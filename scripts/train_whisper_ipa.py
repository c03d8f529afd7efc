#!/usr/bin/env python
"""Reference-invocation shim: `python scripts/train_whisper_ipa.py ...` works exactly
as in the upstream repo; the implementation lives in
whisper_ipa.cli.train_whisper_ipa."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from whisper_ipa.cli.train_whisper_ipa import main

if __name__ == "__main__":
    main()

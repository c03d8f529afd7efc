#!/usr/bin/env python
"""Reference-invocation shim: `python scripts/evaluate_model.py ...` works exactly
as in the upstream repo; the implementation lives in
whisper_ipa.cli.evaluate_model."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from whisper_ipa.cli.evaluate_model import main

if __name__ == "__main__":
    main()

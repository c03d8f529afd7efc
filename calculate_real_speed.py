#!/usr/bin/env python
"""Reference-invocation shim for the out-of-process speed monitor
(`python calculate_real_speed.py [PID] [CKPT_DIR] [STEPS] [BATCH]`)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from whisper_ipa.cli.calculate_real_speed import main

if __name__ == "__main__":
    main()

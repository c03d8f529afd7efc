"""The package's environment settings.

Every setting is read as ``WHISPER_IPA_<NAME>`` through :func:`setting`.
Before the package took its present name, each variable carried one more
word after the prefix (``WHISPER_IPA_<WORD>_<NAME>``). When the present
name is unset, such a former name is still honoured, with a
``FutureWarning`` that names the replacement, so a setup written for the
former names keeps its meaning instead of quietly falling back to a
default.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Optional

PREFIX = "WHISPER_IPA_"


def former_name(name: str) -> Optional[str]:
    """The set variable that spells ``name`` the former way, if any."""
    pattern = re.compile(re.escape(PREFIX) + r"[A-Z0-9]+_" + re.escape(name))
    found = sorted(k for k in os.environ if pattern.fullmatch(k))
    return found[0] if found else None


def setting(name: str, default: Optional[str] = None) -> Optional[str]:
    """``$WHISPER_IPA_<name>``, else its former spelling, else ``default``."""
    key = PREFIX + name
    if key in os.environ:
        return os.environ[key]
    old = former_name(name)
    if old is None:
        return default
    warnings.warn(f"{old} is a former name; set {key} instead",
                  FutureWarning, stacklevel=2)
    return os.environ[old]

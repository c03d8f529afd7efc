"""JAX's persistent compilation cache, set up one way by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache directory and
JAX reads it itself: the program then sets no other. Otherwise the cache
lives in ``.jax_cache`` at the root of the checkout (listed in
.gitignore). The path is part of what a later process must find again,
so it is fixed, not derived from the user's home or temporary directory.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR

"""Test configuration: force CPU with a virtual 8-device mesh.

Multi-chip hardware is not available in CI; sharding/pjit paths are
exercised on 8 virtual CPU devices via XLA's host platform override. Must
run before the first jax import.
"""

import os
import subprocess
import sys

# The full suite JIT-compiles hundreds of XLA CPU executables; LLVM ORC
# maps ~3 small anonymous regions per module and XLA splits each program
# into many modules (parallel codegen), so one process accumulates tens of
# thousands of mappings. The stock vm.max_map_count (65530) is hit near the
# end of the suite and the NEXT compile segfaults inside LLVM (measured:
# two identical crashes at 64.8k maps, test #386). Raise the limit up front
# (best-effort — needs root); _maps_guard below is the fallback.
_MAP_LIMIT = 65530
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _MAP_LIMIT = int(_f.read())
    if _MAP_LIMIT < 1048576:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("1048576")
        _MAP_LIMIT = 1048576
except (OSError, ValueError):
    pass

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# pin the CPU backend even where a site hook or the environment names
# another platform, before any backend initializes
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import gc

import pytest


@pytest.fixture(autouse=True)
def _maps_guard():
    """Fallback when vm.max_map_count could not be raised (non-root).

    Reads this process's mapping count after each test (one /proc read,
    ~50 us) and drops JAX's compiled-executable caches when within 75% of
    the limit, releasing the LLVM JIT code mappings of dead executables.
    Recompiles cost time but a segfault costs the suite.
    """
    yield
    if _MAP_LIMIT >= 1048576:
        return
    try:
        with open("/proc/self/maps") as f:
            n = sum(1 for _ in f)
    except OSError:
        return
    if n > 0.75 * _MAP_LIMIT:
        jax.clear_caches()
        gc.collect()


# Build the native metric cores once per session (best-effort).
_native_lib = os.path.join(REPO_ROOT, "native", "libwipa_native.so")
if not os.path.isfile(_native_lib):
    try:
        subprocess.run(
            ["make", "-C", os.path.join(REPO_ROOT, "native")],
            check=False,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        pass

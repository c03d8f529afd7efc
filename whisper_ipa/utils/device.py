"""The accelerator a measurement runs on: checks and a description of it."""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return JAX's first device; raise SystemExit unless it is a GPU.

    Measurements and on-card checks never fall back to another backend:
    a number taken elsewhere would be reported under the GPU's name.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(
        line.strip() for line in out.stdout.splitlines() if line.strip()
    )

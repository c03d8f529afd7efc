"""On-device stochastic-rounding int8 weight quantization.

Quantizing weights on the host (ops/quant.py, numpy) costs a full float32
download, a CPU pass and an upload. This module quantizes on the device
in one pass. Stochastic rounding, q = floor(x/s + u) with u ~ U[0, 1),
makes the quantizer unbiased (E[q·s] = w), so quantization error behaves
like zero-mean noise instead of a systematic bias. The scale convention
matches ops/quant.quantize_linear: per-output-channel symmetric,
s[out] = max|w[:, out]| / 127.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _stochastic_quantize(x, seed):
    key = jax.random.PRNGKey(seed)
    amax = jnp.max(jnp.abs(x), axis=0, keepdims=True)
    s = jnp.maximum(amax, 1e-8) / 127.0
    u = jax.random.uniform(key, x.shape, jnp.float32)
    q = jnp.clip(jnp.floor(x / s + u), -127, 127).astype(jnp.int8)
    return q, s[0]


def stochastic_quantize_int8(x, seed: int = 0):
    """(in, out) float -> (int8 codes (in, out), scales (out,) float32).

    Per-output-channel symmetric scales (the ops/quant weight layout),
    stochastically rounded.
    """
    return _stochastic_quantize(jnp.asarray(x, jnp.float32), seed)


def quantize_linear_device(p, seed: int = 0):
    """Device-side {"w": ...} -> {"w_q", "w_s"} (stochastic rounding)."""
    q, s = stochastic_quantize_int8(p["w"], seed=seed)
    out = {k: v for k, v in p.items() if k != "w"}
    out["w_q"] = q
    out["w_s"] = s
    return out


def quantize_params_device(params, quantize_encoder: bool = True,
                           seed: int = 0):
    """On-device int8 weight quantization of a whole parameter tree.

    Same output layout as ops/quant.quantize_params(bits=8), but the
    float32 weights never leave the device and rounding is stochastic.
    Each weight gets a distinct derived seed.
    """
    counter = [0]

    def visit(tree):
        if isinstance(tree, dict):
            if "w" in tree and np.ndim(tree["w"]) == 2:
                counter[0] += 1
                return quantize_linear_device(tree, seed=seed + counter[0])
            return {k: visit(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v) for v in tree]
        return tree

    out = dict(params)
    out["decoder"] = {
        k: (visit(v) if k == "blocks" else v)
        for k, v in params["decoder"].items()
    }
    if quantize_encoder:
        out["encoder"] = {
            k: (visit(v) if k == "blocks" else v)
            for k, v in params["encoder"].items()
        }
    return out

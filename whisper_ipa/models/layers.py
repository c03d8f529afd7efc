"""Functional building blocks for the Whisper transformer.

Pure functions over parameter pytrees — no module framework. Canonical
parameter layouts (``x @ w`` contractions with no transposes):

  linear:  {"w": (in, out), "b": (out,)}        (k-projection has no bias)
  ln:      {"g": (d,), "b": (d,)}
  conv1d:  {"w": (width, in, out), "b": (out,)}  -- 'WIO' rhs layout

Attention follows the Whisper convention: the 1/sqrt(d_head) scale is split
as d_head**-0.25 applied to q and k separately.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def layer_norm(x, p, eps: float = 1e-5):
    """LayerNorm in float32 accumulation regardless of activation dtype."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).astype(x.dtype)


def _int4_halves(packed, w_s4, dtype):
    """Nibble-packed int4 codes + group scales -> (lo, hi) half-weights.

    packed: (in//2, out) int8, original row 2i in the low nibble, 2i+1 in
    the high (ops/quant.pack_int4). Arithmetic shifts sign-extend the
    4-bit codes. Returns the dequantized even-row and odd-row halves,
    each (in//2, out). The consumer contracts each half against the
    matching stride-2 slice of x, so the halves are never interleaved
    back into one (in, out) weight.
    """
    lo = jnp.right_shift(jnp.left_shift(packed, 4), 4).astype(dtype)
    hi = jnp.right_shift(packed, 4).astype(dtype)
    n_half, n_out = packed.shape
    n_groups = w_s4.shape[0]
    s = w_s4[:, None, :].astype(dtype)
    rows = n_half // n_groups  # group//2 packed rows per group
    lo = (lo.reshape(n_groups, rows, n_out) * s).reshape(n_half, n_out)
    hi = (hi.reshape(n_groups, rows, n_out) * s).reshape(n_half, n_out)
    return lo, hi


def _unpack_int4(packed, w_s4, dtype):
    """Full dequantized (in, out) weight — for tests/inspection only."""
    lo, hi = _int4_halves(packed, w_s4, dtype)
    n_half, n_out = packed.shape
    return jnp.stack([lo, hi], axis=1).reshape(2 * n_half, n_out)


def linear(x, p):
    if "w_q4" in p:
        lo, hi = _int4_halves(p["w_q4"], p["w_s4"], x.dtype)
        # y = x @ w with w rows de-interleaved: even input features hit
        # the low-nibble half, odd the high-nibble half
        y = x[..., 0::2] @ lo + x[..., 1::2] @ hi
        if "b" in p and p["b"] is not None:
            y = y + p["b"].astype(x.dtype)
        return y
    if "w_q" in p:
        # weight-only int8 (ops/quant.py): dequant fuses into the matmul,
        # so HBM traffic stays int8
        w = p["w_q"].astype(x.dtype) * p["w_s"].astype(x.dtype)
    else:
        w = p["w"].astype(x.dtype)
    y = x @ w
    if "b" in p and p["b"] is not None:
        y = y + p["b"].astype(x.dtype)
    return y


def conv1d(x, p, stride: int = 1):
    """1-D convolution, SAME-style padding 1, NWC layout.

    x: (B, W, C_in); p["w"]: (width, C_in, C_out).
    """
    y = jax.lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=(stride,),
        padding=((1, 1),),
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    return y + p["b"].astype(x.dtype)


def gelu(x):
    return jax.nn.gelu(x, approximate=False)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embeddings for the audio encoder."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(
        -log_timescale_increment * np.arange(channels // 2)
    )
    scaled_time = (
        np.arange(length)[:, None] * inv_timescales[None, :]
    )
    return np.concatenate(
        [np.sin(scaled_time), np.cos(scaled_time)], axis=1
    ).astype(np.float32)


def _split_heads(x, n_head: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(0, 2, 1, 3)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, t, h * hd)


# Kernel policy, the one place where the backend picks an implementation.
# Unmasked, half-precision attention runs through cuDNN's fused flash
# attention on the GPU, so the (B, H, Tq, Tk) logits and probabilities
# never reach device memory. Everything else, and every backend but the
# GPU, takes the einsum path below. Timed on an H100 SXM
# (bench.py --encoder-attention, 1500 keys, bf16): cuDNN wins from q = 5
# up (2.0x forward at q = 5, batch 192; 1.5x forward+backward at q = 6;
# 2.8x at q = 1500), and ties the einsum path at q = 1, so single-query
# decode steps stay on einsum.
_CUDNN_MIN_QLEN = 2


def use_cudnn_attention(q, k, mask) -> bool:
    """True when multi_head_attention hands (q, k, v) to cuDNN."""
    return (
        mask is None
        and q.dtype in (jnp.bfloat16, jnp.float16)
        and q.shape[1] >= _CUDNN_MIN_QLEN
        # JAX's cuDNN route refuses the backward pass for odd lengths; an
        # odd query is padded below, an odd key length cannot be
        and k.shape[1] % 2 == 0
        and jax.default_backend() == "gpu"
    )


def multi_head_attention_int8kv(q, k_i8, k_scale, v_i8, v_scale, n_head: int):
    """Unmasked attention with an int8-quantized, T-minor K/V cache.

    q: (B, S, d); k_i8/v_i8: (B, H, Dh, T) int8; scales: (B, H, T) f32
    (init_cache's cross_kv_int8 layout). Cross-K/V reads dominate the
    decode loop's memory traffic, and int8 halves the bytes against
    bfloat16. Scales fold into the logits (K) and the probabilities (V);
    no dequantized copy is materialized. A scale of 0 marks a padding
    position.
    """
    d_head = q.shape[-1] // n_head
    qh = _split_heads(q * (d_head**-0.5), n_head)  # (B, H, S, Dh)

    if k_scale.shape[-1] != k_i8.shape[-1]:
        # int4 nibble-packed codes (T_pad/2 bytes vs T_pad scales):
        # dequantize per nibble plane, interleave only the SMALL logits
        return _mha_int4kv(qh, k_i8, k_scale, v_i8, v_scale)

    logits = jnp.einsum(
        "bhsd,bhdt->bhst", qh, k_i8.astype(q.dtype)
    ).astype(jnp.float32)
    ks = k_scale[:, :, None, :]
    # scale 0 marks tile-padding positions (real scales are > 0)
    logits = jnp.where(ks > 0.0, logits * ks, -jnp.inf)
    w = jax.nn.softmax(logits, axis=-1)
    w = (w * v_scale[:, :, None, :]).astype(q.dtype)
    out = jnp.einsum("bhst,bhdt->bhsd", w, v_i8.astype(q.dtype))
    return _merge_heads(out)


def _mha_int4kv(qh, k_p4, k_scale, v_p4, v_scale):
    """Attention over the nibble-packed int4 T-minor cache.

    qh: (B, H, S, Dh) pre-scaled; k_p4/v_p4: (B, H, Dh, T_pad/2) int8
    holding two T-adjacent int4 codes (even T low nibble, odd high);
    scales: (B, H, T_pad) f32. The K/V loads stay packed (quarter of
    bf16's bytes); the nibble planes are contracted separately and only
    the (B, H, S, T) logits/probabilities — tiny next to the cache — are
    interleaved/de-interleaved.
    """
    dtype = qh.dtype
    B, H, S, Dh = qh.shape
    T2 = k_p4.shape[-1]

    def planes(p):
        lo = jnp.right_shift(jnp.left_shift(p, 4), 4).astype(dtype)
        hi = jnp.right_shift(p, 4).astype(dtype)
        return lo, hi

    k_lo, k_hi = planes(k_p4)
    l_even = jnp.einsum("bhsd,bhdt->bhst", qh, k_lo).astype(jnp.float32)
    l_odd = jnp.einsum("bhsd,bhdt->bhst", qh, k_hi).astype(jnp.float32)
    logits = jnp.stack([l_even, l_odd], axis=-1).reshape(B, H, S, 2 * T2)
    ks = k_scale[:, :, None, :]
    logits = jnp.where(ks > 0.0, logits * ks, -jnp.inf)
    w = jax.nn.softmax(logits, axis=-1)
    w = w * v_scale[:, :, None, :]
    v_lo, v_hi = planes(v_p4)
    w_even = w[..., 0::2].astype(dtype)
    w_odd = w[..., 1::2].astype(dtype)
    out = jnp.einsum("bhst,bhdt->bhsd", w_even, v_lo) + jnp.einsum(
        "bhst,bhdt->bhsd", w_odd, v_hi
    )
    return _merge_heads(out)


def multi_head_attention(
    q, k, v, n_head: int, mask: Optional[jax.Array] = None,
    cudnn: Optional[bool] = None,
):
    """Scaled dot-product attention over merged-head projections.

    q/k/v: (B, Tq/Tk, d). mask: additive, broadcastable to (B, H, Tq, Tk).
    Softmax accumulates in float32. cudnn: None follows the kernel policy
    (use_cudnn_attention); True or False forces the path, for timing both.
    """
    d_head = q.shape[-1] // n_head
    scale = d_head ** -0.25

    if use_cudnn_attention(q, k, mask) if cudnn is None else cudnn:
        # (B, T, d) -> (B, T, H, Dh) is a free reshape: cuDNN takes the
        # BTNH layout, so no head transposes surround the kernel
        b, tq, _ = q.shape
        if tq % 2:
            # unmasked query rows are independent: one zero row makes the
            # length even and is dropped from the output
            q = jnp.pad(q, ((0, 0), (0, 1), (0, 0)))

        def heads(x):
            return x.reshape(x.shape[0], x.shape[1], n_head, d_head)

        out = jax.nn.dot_product_attention(
            heads(q), heads(k), heads(v),
            scale=float(d_head ** -0.5), implementation="cudnn",
        )
        return out[:, :tq].reshape(b, tq, n_head * d_head)

    return _attention_core(q, k, v, mask, n_head=n_head, scale=scale)


def _attention_core(q, k, v, mask, *, n_head: int, scale: float):
    qh = _split_heads(q, n_head) * scale
    kh = _split_heads(k, n_head) * scale
    vh = _split_heads(v, n_head)

    logits = jnp.einsum("bhqd,bhkd->bhqk", qh, kh).astype(jnp.float32)
    if mask is not None:
        logits = logits + mask
    w = jax.nn.softmax(logits, axis=-1).astype(vh.dtype)
    out = jnp.einsum("bhqk,bhkd->bhqd", w, vh)
    return _merge_heads(out)


def multi_head_attention_two_part(
    q, k_cache, v_cache, k_new, v_new, n_head: int, mask_cache, mask_new
):
    """Attention over [frozen cache | new in-step keys] WITHOUT
    concatenating K/V (a (B, n_ctx, d) concat would re-copy the whole
    cache every decode step — the copy this formulation exists to kill).
    Only the LOGITS are concatenated ((B, H, S, n_ctx + S), a few KB at
    S=1), then the two value dots are summed.

    mask_cache: additive, broadcastable to (B, H, S, n_ctx);
    mask_new: additive, broadcastable to (B, H, S, S).
    """
    d_head = q.shape[-1] // n_head
    scale = d_head ** -0.25
    qh = _split_heads(q, n_head) * scale
    kc = _split_heads(k_cache, n_head) * scale
    kn = _split_heads(k_new, n_head) * scale

    lc = jnp.einsum("bhqd,bhkd->bhqk", qh, kc).astype(jnp.float32)
    lc = lc + mask_cache
    ln = jnp.einsum("bhqd,bhkd->bhqk", qh, kn).astype(jnp.float32)
    ln = ln + mask_new
    n_ctx = lc.shape[-1]
    w = jax.nn.softmax(
        jnp.concatenate([lc, ln], axis=-1), axis=-1
    ).astype(v_cache.dtype)
    out = jnp.einsum(
        "bhqk,bhkd->bhqd", w[..., :n_ctx], _split_heads(v_cache, n_head)
    ) + jnp.einsum(
        "bhqk,bhkd->bhqd", w[..., n_ctx:], _split_heads(v_new, n_head)
    )
    return _merge_heads(out)


def multi_head_attention_beam_cache(
    q, k_cache, v_cache, k_new, v_new, n_head: int, sel_mask
):
    """Beam self-attention over UNREORDERED per-row K/V caches.

    Classic beam search reorders the whole self-KV cache every step
    (a one-hot einsum = a full cache copy — the dominant HBM term once
    the context grows). This formulation never moves the cache: each
    physical row k keeps the K/V its beam slot wrote, an ancestry table
    records which row holds beam j's history at each position, and
    attention computes logits against ALL rows then lets an additive
    select-mask (0 where anc[b,j,p]==k and p is live, -inf elsewhere)
    pick exactly one row per (beam, position) inside the softmax. Bytes
    read: live rows once (same as reordered attention); bytes written:
    none. The K-fold extra logit FLOPs are decode-shaped matvecs.

    q/k_new/v_new: (B, J, d) — one query (and one new self K/V) per
    beam; k_cache/v_cache: (B, K, n_ctx, d) physical rows (J == K);
    sel_mask: additive (B, J, K, n_ctx). The new token attends itself
    (causally last), so its logit needs no mask.
    """
    B, J, d = q.shape
    n_ctx = k_cache.shape[2]
    d_head = d // n_head
    scale = d_head ** -0.25

    def split(x):  # (B, X, d) -> (B, X, H, Dh)
        return x.reshape(x.shape[:-1] + (n_head, d_head))

    qh = split(q) * scale  # (B, J, H, Dh)
    kc = split(k_cache.reshape(B, -1, d)).reshape(
        B, k_cache.shape[1], n_ctx, n_head, d_head
    ) * scale  # (B, K, P, H, Dh)
    kn = split(k_new) * scale  # (B, J, H, Dh)

    lc = jnp.einsum("bjhd,bkphd->bhjkp", qh, kc).astype(jnp.float32)
    lc = lc + sel_mask[:, None]  # (B, H, J, K, P)
    ln = jnp.einsum("bjhd,bjhd->bhj", qh, kn).astype(jnp.float32)

    flat = jnp.concatenate(
        [lc.reshape(B, n_head, J, -1), ln[..., None]], axis=-1
    )
    w = jax.nn.softmax(flat, axis=-1).astype(v_cache.dtype)
    wc = w[..., :-1].reshape(lc.shape)
    vc = split(v_cache.reshape(B, -1, d)).reshape(
        B, v_cache.shape[1], n_ctx, n_head, d_head
    )
    out = jnp.einsum("bhjkp,bkphd->bjhd", wc, vc)
    out = out + w[..., -1][..., None].transpose(0, 2, 1, 3) * split(v_new)
    return out.reshape(B, J, d)


def attention_block(x, p, n_head: int, mask=None, kv=None, cudnn=None):
    """Self- or cross-attention through a Whisper attention param group.

    p: {"query","key","value","out"}. When kv is given (cross-attention or
    cached keys/values) it is a tuple (k, v) of already-projected tensors.
    cudnn: as in multi_head_attention.
    """
    q = linear(x, p["query"])
    if kv is None:
        k = linear(x, p["key"])
        v = linear(x, p["value"])
    else:
        k, v = kv
    out = multi_head_attention(q, k, v, n_head, mask, cudnn)
    return linear(out, p["out"]), (k, v)


def mlp_block(x, p):
    return linear(gelu(linear(x, p["mlp1"])), p["mlp2"])


def causal_mask(n_ctx: int) -> np.ndarray:
    """(n_ctx, n_ctx) additive causal mask (upper triangle = -inf)."""
    mask = np.full((n_ctx, n_ctx), -np.inf, dtype=np.float32)
    return np.triu(mask, k=1)

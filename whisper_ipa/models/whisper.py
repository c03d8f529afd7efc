"""Whisper encoder/decoder as pure-JAX functions over a parameter pytree.

Architecture (behavioral parity with the reference's model layer, reference
SURVEY §2b / mlx_whisper model): conv stem (k=3 s=1, k=3 s=2, GELU) +
sinusoidal positions + pre-LN transformer encoder; token + learned-position
embeddings + pre-LN transformer decoder with cross-attention; logits tied to
the token embedding.

Parameter tree (canonical names; see convert.py for HF/MLX mappings):

  encoder:
    conv1/conv2: {"w": (3, in, out), "b": (out,)}
    blocks: [ {attn_ln, attn{query,key,value,out}, mlp_ln, mlp1, mlp2} ]
    ln_post: {"g", "b"}
  decoder:
    token_embedding: (n_vocab, d)
    positional_embedding: (n_text_ctx, d)
    blocks: [ {attn_ln, attn, cross_attn_ln, cross_attn, mlp_ln, mlp1, mlp2} ]
    ln: {"g", "b"}

All forward functions are jit-compatible with static shapes. The KV cache
uses fixed-length per-layer buffers updated with dynamic_update_slice so the
autoregressive decode loop compiles to a single XLA while_loop program.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from .layers import (
    attention_block,
    causal_mask,
    conv1d,
    gelu,
    layer_norm,
    linear,
    mlp_block,
    sinusoids,
)

Params = Dict[str, Any]


# -- initialization -------------------------------------------------------

def _init_linear(key, d_in, d_out, bias=True, std=None):
    if std is None:
        std = d_in ** -0.5
    k1, _ = jax.random.split(key)
    p = {"w": jax.random.normal(k1, (d_in, d_out), jnp.float32) * std}
    if bias:
        p["b"] = jnp.zeros((d_out,), jnp.float32)
    return p


def _init_ln(d):
    return {"g": jnp.ones((d,), jnp.float32), "b": jnp.zeros((d,), jnp.float32)}


def _init_attn(key, d, cross=False):
    ks = jax.random.split(key, 4)
    return {
        "query": _init_linear(ks[0], d, d),
        "key": _init_linear(ks[1], d, d, bias=False),
        "value": _init_linear(ks[2], d, d),
        "out": _init_linear(ks[3], d, d),
    }


def _init_block(key, d, mlp_dim, cross: bool):
    ks = jax.random.split(key, 4)
    block = {
        "attn_ln": _init_ln(d),
        "attn": _init_attn(ks[0], d),
        "mlp_ln": _init_ln(d),
        "mlp1": _init_linear(ks[1], d, mlp_dim),
        "mlp2": _init_linear(ks[2], mlp_dim, d),
    }
    if cross:
        block["cross_attn_ln"] = _init_ln(d)
        block["cross_attn"] = _init_attn(ks[3], d, cross=True)
    return block


def init_params(cfg: WhisperConfig, seed: int = 0) -> Params:
    """Random-initialized parameter tree (float32)."""
    key = jax.random.PRNGKey(seed)
    k_enc, k_dec, k_emb = jax.random.split(key, 3)

    d_a, d_t = cfg.n_audio_state, cfg.n_text_state
    enc_keys = jax.random.split(k_enc, cfg.n_audio_layer + 2)
    encoder = {
        "conv1": {
            "w": jax.random.normal(enc_keys[0], (3, cfg.n_mels, d_a), jnp.float32)
            * (3 * cfg.n_mels) ** -0.5,
            "b": jnp.zeros((d_a,), jnp.float32),
        },
        "conv2": {
            "w": jax.random.normal(enc_keys[1], (3, d_a, d_a), jnp.float32)
            * (3 * d_a) ** -0.5,
            "b": jnp.zeros((d_a,), jnp.float32),
        },
        "blocks": [
            _init_block(enc_keys[2 + i], d_a, 4 * d_a, cross=False)
            for i in range(cfg.n_audio_layer)
        ],
        "ln_post": _init_ln(d_a),
    }

    dec_keys = jax.random.split(k_dec, cfg.n_text_layer)
    decoder = {
        "token_embedding": jax.random.normal(
            k_emb, (cfg.n_vocab, d_t), jnp.float32
        )
        * 0.02,
        "positional_embedding": jnp.zeros(
            (cfg.n_text_ctx, d_t), jnp.float32
        ),
        "blocks": [
            _init_block(dec_keys[i], d_t, 4 * d_t, cross=True)
            for i in range(cfg.n_text_layer)
        ],
        "ln": _init_ln(d_t),
    }
    return {"encoder": encoder, "decoder": decoder}


# -- layer stacking (scan-over-depth) -------------------------------------

def _stack_blocks(blocks: List[Dict]) -> Dict:
    """List of per-layer param dicts -> one dict with leading L axis.

    Done inside the traced function: the transformer body then compiles as
    a single lax.scan over depth, making XLA compile time independent of
    layer count (the unrolled 12-layer whisper-small decode program took
    >3 min to compile; the scanned one takes seconds). The stack itself is
    one HBM copy that XLA usually elides.
    """
    return jax.tree.map(lambda *xs: jnp.stack(xs), *blocks)


# -- encoder --------------------------------------------------------------

def encode(params: Params, cfg: WhisperConfig, mel, dtype=jnp.float32,
           remat: bool = False, cudnn: Optional[bool] = None):
    """Audio encoder: (B, 3000, n_mels) -> (B, 1500, d).

    remat=True checkpoints each encoder layer — only relevant to FULL
    fine-tuning (frozen-encoder training runs the encoder under
    stop_gradient, which saves nothing already). The binding residuals
    in the unfrozen backward are the per-layer (B, 1500, 4d) MLP hidden
    activations stacked over the scan (1.65 GB at batch 16,
    whisper-small, per the OOM dump); rematerializing the layer trades
    ~1/3 extra encoder FLOPs for all of that.

    cudnn: the self-attention path (layers.multi_head_attention); None
    follows the kernel policy.
    """
    enc = params["encoder"]
    x = mel.astype(dtype)
    x = gelu(conv1d(x, enc["conv1"], stride=1))
    x = gelu(conv1d(x, enc["conv2"], stride=2))

    pos = jnp.asarray(sinusoids(cfg.n_audio_ctx, cfg.n_audio_state))
    x = x + pos.astype(dtype)

    stacked = _stack_blocks(enc["blocks"])

    def body(x, block):
        h, _ = attention_block(
            layer_norm(x, block["attn_ln"]), block["attn"], cfg.n_audio_head,
            cudnn=cudnn,
        )
        x = x + h
        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return x, None

    if remat:
        body = jax.checkpoint(body)

    x, _ = jax.lax.scan(body, x, stacked)
    return layer_norm(x, enc["ln_post"])


# alias matching the reference surface (model.embed_audio)
embed_audio = encode


# -- decoder (teacher forcing / full sequence) ----------------------------

def decoder_hidden(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    audio_features,
    dtype=jnp.float32,
    remat: bool = False,
):
    """Decoder final hidden states (B, T, d), before the logits matmul.

    remat=True checkpoints each layer (activations recomputed in the
    backward pass — trades FLOPs for HBM, needed for large-v3 training).
    """
    dec = params["decoder"]
    B, T = tokens.shape
    x = dec["token_embedding"][tokens].astype(dtype)
    x = x + dec["positional_embedding"][:T].astype(dtype)

    mask = jnp.asarray(causal_mask(T))
    audio_features = audio_features.astype(dtype)

    stacked = _stack_blocks(dec["blocks"])

    def _tail(x, block, xa_k, xa_v):
        h, _ = attention_block(
            layer_norm(x, block["attn_ln"]),
            block["attn"],
            cfg.n_text_head,
            mask=mask,
        )
        x = x + h
        h, _ = attention_block(
            layer_norm(x, block["cross_attn_ln"]),
            block["cross_attn"],
            cfg.n_text_head,
            kv=(xa_k, xa_v),
        )
        x = x + h
        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return x

    # Per-layer K/V projections stay INSIDE the scan body: a hoisted
    # all-layers projection would keep an (B, T_enc, L*2*d) result live
    # across the whole scan and its backward.
    def body(x, block):
        xa_k = linear(audio_features, block["cross_attn"]["key"])
        xa_v = linear(audio_features, block["cross_attn"]["value"])
        return _tail(x, block, xa_k, xa_v), None

    if remat:
        body = jax.checkpoint(body)
    x, _ = jax.lax.scan(body, x, stacked)
    return layer_norm(x, dec["ln"])


def decoder_logits(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    audio_features,
    dtype=jnp.float32,
    remat: bool = False,
    bf16_head: bool = False,
):
    """Teacher-forced decoder: (B, T) x (B, 1500, d) -> (B, T, n_vocab).

    Used by training (reference compute_loss calls model.logits at
    scripts/train_whisper_ipa.py:232).

    bf16_head: run the (d x n_vocab) logits GEMM with bfloat16 operands
    and float32 accumulation (preferred_element_type) instead of the
    default full-float32 GEMM, which runs well below the bf16 tensor-core
    rate. The logits (and
    the loss computed from them) stay float32; only the multiplicands
    round to bf16 (~0.4% relative logit error — standard mixed-precision
    LM-head practice).
    """
    x = decoder_hidden(
        params, cfg, tokens, audio_features, dtype=dtype, remat=remat
    )
    emb = params["decoder"]["token_embedding"]
    if bf16_head:
        return jnp.matmul(
            x.astype(jnp.bfloat16),
            emb.T.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return jnp.matmul(
        x.astype(jnp.float32), emb.T.astype(jnp.float32)
    )


logits = decoder_logits  # reference-surface alias (model.logits)


def decoder_cross_attentions(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    audio_features,
    dtype=jnp.float32,
):
    """Teacher-forced forward that also returns cross-attention weights.

    Returns (logits (B, T, V), weights (L, B, H, T, 1500)) — the alignment
    signal used for phone-level timestamps (decode/word_timestamps.py).
    """
    from .layers import _merge_heads, _split_heads

    dec = params["decoder"]
    B, T = tokens.shape
    x = dec["token_embedding"][tokens].astype(dtype)
    x = x + dec["positional_embedding"][:T].astype(dtype)
    mask = jnp.asarray(causal_mask(T))
    audio_features = audio_features.astype(dtype)
    stacked = _stack_blocks(dec["blocks"])
    H = cfg.n_text_head
    d_head = cfg.n_text_head_dim
    scale = d_head ** -0.25

    def body(x, block):
        h, _ = attention_block(
            layer_norm(x, block["attn_ln"]), block["attn"], H, mask=mask
        )
        x = x + h
        xn = layer_norm(x, block["cross_attn_ln"])
        q = _split_heads(linear(xn, block["cross_attn"]["query"]), H) * scale
        k = _split_heads(
            linear(audio_features, block["cross_attn"]["key"]), H
        ) * scale
        v = _split_heads(linear(audio_features, block["cross_attn"]["value"]), H)
        logits_attn = jnp.einsum("bhqd,bhkd->bhqk", q, k).astype(jnp.float32)
        w = jax.nn.softmax(logits_attn, axis=-1)
        out = jnp.einsum("bhqk,bhkd->bhqd", w.astype(v.dtype), v)
        x = x + linear(_merge_heads(out), block["cross_attn"]["out"])
        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return x, w

    x, weights = jax.lax.scan(body, x, stacked)
    x = layer_norm(x, dec["ln"])
    logits = jnp.matmul(
        x.astype(jnp.float32), dec["token_embedding"].T.astype(jnp.float32)
    )
    return logits, weights


# -- decoder (incremental, KV-cached) -------------------------------------

class DecoderCache(NamedTuple):
    """Fixed-shape KV cache for autoregressive decoding under jit.

    self_k/self_v: (L, B, n_ctx, d) rolling buffers for self-attention.
    cross_k/cross_v: (L, B, 1500, d) computed once per utterance.

    When the cross cache is int8-quantized (cross_kv_int8), cross_k/cross_v
    hold head-split, T-minor int8 codes (L, B, H, Dh, T_pad) and
    cross_k_scale/cross_v_scale hold per-(position, head) float32 scales
    (L, B, H, T_pad), T padded to a multiple of 128 with scale 0 marking
    pad positions. Cross-K/V reads dominate the decode loop's memory
    traffic (they scale with batch x 1500 x d x layers): int8 halves
    their width.
    """

    self_k: jax.Array
    self_v: jax.Array
    cross_k: jax.Array
    cross_v: jax.Array
    cross_k_scale: Optional[jax.Array] = None
    cross_v_scale: Optional[jax.Array] = None


def _quantize_kv_heads(x, n_head: int):
    """Symmetric int8 per-(position, head) quantization, T-minor layout.

    (B, T, d) -> codes (B, H, Dh, T) int8, scales (B, H, T) f32.
    T is the minor axis of the codes.
    """
    B, T, d = x.shape
    dh = d // n_head
    # transpose first, then do all float work in the T-minor layout
    xf = x.transpose(0, 2, 1).astype(jnp.float32).reshape(B, n_head, dh, T)
    amax = jnp.max(jnp.abs(xf), axis=2)  # (B, H, T)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    codes = jnp.round(xf / scale[:, :, None, :]).astype(jnp.int8)
    # pad T to a multiple of 128 ONCE here: padding inside the decode step
    # would copy the whole cache every token. Padded positions get scale 0,
    # which the attention paths use as the mask (real scales are > 0).
    t_pad = ((T + 127) // 128) * 128
    if t_pad != T:
        codes = jnp.pad(codes, ((0, 0), (0, 0), (0, 0), (0, t_pad - T)))
        scale = jnp.pad(scale, ((0, 0), (0, 0), (0, t_pad - T)))
    return codes, scale


def _quantize_kv_heads4(x, n_head: int):
    """Symmetric int4 per-(position, head) quantization, T-minor packed.

    (B, T, d) -> codes (B, H, Dh, T_pad/2) int8 (two T-adjacent nibbles
    per byte: even T in the low nibble, odd in the high), scales
    (B, H, T_pad) f32. Quarter the memory bytes of bf16 / half of int8 for
    the decode loop's dominant read — at ~4x the quantization noise of
    int8 (4-bit codes over a 64-value group). Opt-in via kv_int4.
    """
    B, T, d = x.shape
    dh = d // n_head
    xf = x.transpose(0, 2, 1).astype(jnp.float32).reshape(B, n_head, dh, T)
    amax = jnp.max(jnp.abs(xf), axis=2)  # (B, H, T)
    scale = jnp.maximum(amax, 1e-8) / 7.0
    codes = jnp.clip(
        jnp.round(xf / scale[:, :, None, :]), -7, 7
    ).astype(jnp.int8)
    t_pad = ((T + 127) // 128) * 128
    if t_pad != T:
        codes = jnp.pad(codes, ((0, 0), (0, 0), (0, 0), (0, t_pad - T)))
        scale = jnp.pad(scale, ((0, 0), (0, 0), (0, t_pad - T)))
    lo = codes[..., 0::2]  # even T positions
    hi = codes[..., 1::2]
    packed = jnp.bitwise_or(
        jnp.bitwise_and(lo, 0xF),
        jnp.left_shift(hi, 4),
    ).astype(jnp.int8)
    return packed, scale


def cast_decoder_blocks(params: Params, dtype) -> Params:
    """Pre-cast decoder-block matmul weights/biases to the decode dtype.

    ``layers.linear`` casts ``w``/``b`` to the activation dtype at every
    use; inside the token while_loop that convert re-runs per layer per
    step and the param slices stream float32 bytes (xprof r4, batch-128
    whisper-small decode: 29.6 ms/decode of in-loop convert_element_type
    plus double-width dynamic_slice reads — ~60 ms of the ~160 ms
    non-cross-attention loop residue). Casting the block tree ONCE at
    the jitted entry, outside the loop, is numerically identical (the
    same single f32->bf16 rounding the per-use cast applies) and halves
    the per-step parameter traffic.

    Only float32 leaves named exactly ``w``/``b`` are cast: layernorm
    params (``*_ln``, applied in f32 by ``layer_norm``), quantized
    leaves (``w_q``/``w_s``/``w_q4``/``w_s4``, consumed by fused-dequant
    paths that expect their stored dtypes), and the embeddings/logits
    head (f32 by design, ``_final_logits``) keep their dtypes.
    """
    if jnp.dtype(dtype) == jnp.float32:
        return params

    def _cast(obj):
        if isinstance(obj, dict):
            return {
                k: (
                    v.astype(dtype)
                    if k in ("w", "b")
                    and v is not None
                    and getattr(v, "dtype", None) == jnp.float32
                    else _cast(v)
                )
                for k, v in obj.items()
            }
        return obj

    def _cast_block(block):
        return {
            name: (group if name.endswith("_ln") else _cast(group))
            for name, group in block.items()
        }

    dec = dict(params["decoder"])
    dec["blocks"] = [_cast_block(b) for b in dec["blocks"]]
    out = dict(params)
    out["decoder"] = dec
    return out


def init_cache(
    params: Params,
    cfg: WhisperConfig,
    audio_features,
    max_len: Optional[int] = None,
    dtype=jnp.float32,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
) -> DecoderCache:
    """Allocate self-attn buffers and precompute cross-attn K/V per layer."""
    B = audio_features.shape[0]
    L = cfg.n_text_layer
    n_ctx = max_len or cfg.n_text_ctx
    d = cfg.n_text_state
    audio_features = audio_features.astype(dtype)

    stacked = _stack_blocks(params["decoder"]["blocks"])
    k_scale = v_scale = None
    if cross_kv_int8 or cross_kv_int4:
        quantize = (
            _quantize_kv_heads4 if cross_kv_int4 else _quantize_kv_heads
        )
        # project + quantize one layer at a time (lax.map, not vmap): the
        # float32 projection transient is ~B*1500*d*4 bytes PER LAYER; doing
        # all layers at once OOMs HBM at large batch
        def _project_quantize(p):
            k = linear(audio_features, p["key"])
            v = linear(audio_features, p["value"])
            kq, ks = quantize(k, cfg.n_text_head)
            vq, vs = quantize(v, cfg.n_text_head)
            return kq, ks, vq, vs

        cross_k, k_scale, cross_v, v_scale = jax.lax.map(
            _project_quantize,
            {
                "key": stacked["cross_attn"]["key"],
                "value": stacked["cross_attn"]["value"],
            },
        )
    else:
        cross_k = jax.vmap(lambda p: linear(audio_features, p))(
            stacked["cross_attn"]["key"]
        )
        cross_v = jax.vmap(lambda p: linear(audio_features, p))(
            stacked["cross_attn"]["value"]
        )
    return DecoderCache(
        self_k=jnp.zeros((L, B, n_ctx, d), dtype),
        self_v=jnp.zeros((L, B, n_ctx, d), dtype),
        cross_k=cross_k,
        cross_v=cross_v,
        cross_k_scale=k_scale,
        cross_v_scale=v_scale,
    )


def _run_decoder_layers(dec, cfg: WhisperConfig, x, cache, self_attn,
                        cross_attn):
    """Scan the decoder layers with pluggable attention policies.

    The four decode-step variants (fixed-position, per-element multipos,
    general block, beam) differ ONLY in how self-attention masks/selects
    the cache and how the cross queries are batched; the layer wiring —
    pre-LN, q/k/v projections, residuals, MLP, and the append-only scan
    that stacks just the small per-step K/V projections (never the full
    cache; see decode_step's original note) — lives once, here.

    self_attn(q, k_cache, v_cache, k_new, v_new) and
    cross_attn(qc, xk, xv, k_scale, v_scale) operate on one layer's
    slices and return the merged-head attention output shaped like x.
    Returns (x, (k_news, v_news)) with k/v_news stacked over layers.
    """
    stacked = _stack_blocks(dec["blocks"])

    def body(x, inp):
        block, k_cache, v_cache, xk, xv, k_scale, v_scale = inp
        xn = layer_norm(x, block["attn_ln"])
        q = linear(xn, block["attn"]["query"])
        k_new = linear(xn, block["attn"]["key"])
        v_new = linear(xn, block["attn"]["value"])

        h = self_attn(q, k_cache, v_cache, k_new, v_new)
        x = x + linear(h, block["attn"]["out"])

        xn = layer_norm(x, block["cross_attn_ln"])
        qc = linear(xn, block["cross_attn"]["query"])
        h = cross_attn(qc, xk, xv, k_scale, v_scale)
        x = x + linear(h, block["cross_attn"]["out"])

        x = x + mlp_block(layer_norm(x, block["mlp_ln"]), block)
        return x, (k_new, v_new)

    return jax.lax.scan(
        body,
        x,
        (
            stacked,
            cache.self_k,
            cache.self_v,
            cache.cross_k,
            cache.cross_v,
            cache.cross_k_scale,
            cache.cross_v_scale,
        ),
    )


def _cross_attn_default(cfg: WhisperConfig):
    """Standard cross-attention policy: int8/int4 T-minor cache when
    scales are present, full-precision otherwise."""
    from .layers import multi_head_attention, multi_head_attention_int8kv

    def cross_attn(qc, xk, xv, k_scale, v_scale):
        if k_scale is not None:
            return multi_head_attention_int8kv(
                qc, xk, k_scale, xv, v_scale, cfg.n_text_head
            )
        return multi_head_attention(qc, xk, xv, cfg.n_text_head)

    return cross_attn


def _final_logits(dec, x):
    """Final LN + tied-embedding logits head (float32)."""
    x = layer_norm(x, dec["ln"])
    return jnp.matmul(
        x.astype(jnp.float32), dec["token_embedding"].T.astype(jnp.float32)
    ), x


def decode_step(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    dtype=jnp.float32,
) -> Tuple[jax.Array, DecoderCache]:
    """One decoder step: tokens (B, S) at positions [pos, pos+S).

    Returns (logits (B, S, n_vocab), updated cache). S is static (1 for the
    greedy loop; the SOT prefix is fed in one call with S = prefix length).
    """
    dec = params["decoder"]
    B, S = tokens.shape
    n_ctx = cache.self_k.shape[2]

    x = dec["token_embedding"][tokens].astype(dtype)
    pos_emb = jax.lax.dynamic_slice_in_dim(
        dec["positional_embedding"], pos, S, axis=0
    )
    x = x + pos_emb.astype(dtype)

    # Append-only self-attention: the scan never materializes an updated
    # (L, B, n_ctx, d) cache (stacking those as scan ys re-copied the
    # whole cache every token — xprof showed ~1 ms/step of pure copies at
    # batch 128). Instead each layer attends over [frozen cache | new
    # block K/V] with a two-part mask, the scan stacks only the small
    # (B, S, d) projections, and ONE dynamic_update_slice per step lands
    # them in the big buffers — which XLA aliases in place inside the
    # decode while_loop.
    key_idx = jnp.arange(n_ctx)[None, :]
    query_idx = pos + jnp.arange(S)[:, None]
    # frozen cache rows: strictly before pos (rows >= pos are stale)
    mask_cache = jnp.where(
        (key_idx < pos) & (key_idx <= query_idx), 0.0, -jnp.inf
    ).astype(jnp.float32)  # (S, n_ctx)
    # in-block causality for the S new keys at positions pos..pos+S-1
    blk = jnp.arange(S)
    mask_new = jnp.where(
        blk[None, :] <= blk[:, None], 0.0, -jnp.inf
    ).astype(jnp.float32)  # (S, S)

    from .layers import multi_head_attention_two_part

    def self_attn(q, k_cache, v_cache, k_new, v_new):
        return multi_head_attention_two_part(
            q, k_cache, v_cache, k_new, v_new,
            cfg.n_text_head, mask_cache, mask_new,
        )

    x, (k_news, v_news) = _run_decoder_layers(
        dec, cfg, x, cache, self_attn, _cross_attn_default(cfg)
    )

    # one in-place write of the (L, B, S, d) projections per step
    new_self_k = jax.lax.dynamic_update_slice(
        cache.self_k, k_news, (0, 0, pos, 0)
    )
    new_self_v = jax.lax.dynamic_update_slice(
        cache.self_v, v_news, (0, 0, pos, 0)
    )

    step_logits, _ = _final_logits(dec, x)
    new_cache = cache._replace(self_k=new_self_k, self_v=new_self_v)
    return step_logits, new_cache


def decode_step_beam(
    params: Params,
    cfg: WhisperConfig,
    tokens,  # (B, J) int32 — one new token per beam
    cache: DecoderCache,
    pos,  # scalar: the position these tokens occupy
    anc,  # (B, J, n_ctx) int32 — physical row holding beam j's KV at p
    dtype=jnp.float32,
) -> Tuple[jax.Array, DecoderCache]:
    """One beam decode step over an UNREORDERED self-KV cache.

    Differences from decode_step (see multi_head_attention_beam_cache
    for the why):
      - self-attention selects each beam's history rows through the
        ancestry table instead of requiring the cache to be physically
        reordered every step (the reorder was a full cache copy/step);
      - the cross K/V cache is stored at batch B — NOT repeated per
        beam — and read ONCE per step with the J beam queries batched
        as the query-sequence axis (a J-fold HBM saving on the decode
        loop's dominant stream).

    cache.self_k/self_v: (L, B*J, n_ctx, d); cache.cross_*: batch B.
    Writes land at physical row j (anc[b, j, pos] must equal j).
    """
    dec = params["decoder"]
    B, J = tokens.shape
    n_ctx = cache.self_k.shape[2]

    x = dec["token_embedding"][tokens.reshape(B * J)].astype(dtype)
    x = (x + dec["positional_embedding"][pos].astype(dtype)).reshape(
        B * J, 1, -1
    )

    # additive select-mask, shared across layers: row anc[b,j,p] at
    # position p < pos is beam j's history; everything else is -inf
    key_idx = jnp.arange(n_ctx)[None, None, :]
    sel_mask = jnp.where(
        (anc[..., None, :] == jnp.arange(J)[None, None, :, None])
        & (key_idx[..., None, :] < pos),
        0.0,
        -jnp.inf,
    ).astype(jnp.float32)  # (B, J, K=J, n_ctx)

    from .layers import (
        multi_head_attention,
        multi_head_attention_beam_cache,
        multi_head_attention_int8kv,
    )

    def self_attn(q, k_cache, v_cache, k_new, v_new):
        return multi_head_attention_beam_cache(
            q.reshape(B, J, -1),
            k_cache.reshape(B, J, n_ctx, -1),
            v_cache.reshape(B, J, n_ctx, -1),
            k_new.reshape(B, J, -1),
            v_new.reshape(B, J, -1),
            cfg.n_text_head,
            sel_mask,
        ).reshape(B * J, 1, -1)

    def cross_attn(qc, xk, xv, k_scale, v_scale):
        # beam-invariant cross cache at batch B: the J beam queries ride
        # the query-sequence axis, so K/V stream once, not J times
        qc_b = qc.reshape(B, J, -1)
        if k_scale is not None:
            hc = multi_head_attention_int8kv(
                qc_b, xk, k_scale, xv, v_scale, cfg.n_text_head
            )
        else:
            hc = multi_head_attention(qc_b, xk, xv, cfg.n_text_head)
        return hc.reshape(B * J, 1, -1)

    x, (k_news, v_news) = _run_decoder_layers(
        dec, cfg, x, cache, self_attn, cross_attn
    )

    new_self_k = jax.lax.dynamic_update_slice(
        cache.self_k, k_news, (0, 0, pos, 0)
    )
    new_self_v = jax.lax.dynamic_update_slice(
        cache.self_v, v_news, (0, 0, pos, 0)
    )

    step_logits, _ = _final_logits(dec, x)
    new_cache = cache._replace(self_k=new_self_k, self_v=new_self_v)
    return step_logits.reshape(B, J, -1), new_cache


def decode_step_block(
    params: Params,
    cfg: WhisperConfig,
    tokens,  # (B, S) int32
    cache: DecoderCache,
    pos,  # (B, S) int32 — each token's position (may repeat across S!)
    frontier,  # (B,) int32 — cache rows < frontier are frozen-valid
    mask_new,  # additive (B, S, S) or (S, S): in-block attention policy
    write_len: int,  # write K/V for block entries [0, write_len) only
    dtype=jnp.float32,
) -> Tuple[jax.Array, DecoderCache, jax.Array]:
    """Fully general block decode step: per-TOKEN positions, an explicit
    in-block mask, and a partial KV write.

    decode_step/_multipos assume the block is one causal run of
    consecutive positions, all written to the cache. Tree-structured
    speculative verification breaks all three assumptions: sibling
    draft nodes SHARE a position (so they must not all be written), a
    node may attend only its own ancestors (so causality is a tree, not
    a chain), and the re-fed accepted tokens occupy positions behind
    the frontier. This variant takes the policy from the caller:

      - ``pos[b, s]``: position of token s (positional embedding + the
        cache causality bound),
      - ``mask_new``: additive in-block mask (the tree),
      - ``write_len``: only entries [0, write_len) land in the cache, at
        positions ``pos[b, 0] + arange(write_len)`` (they must be
        consecutive; read-only entries — draft nodes — follow them).

    Returns (logits (B, S, V), cache, hidden (B, S, d)).
    """
    dec = params["decoder"]
    B, S = tokens.shape
    n_ctx = cache.self_k.shape[2]

    x = dec["token_embedding"][tokens].astype(dtype)
    x = x + dec["positional_embedding"][pos].astype(dtype)

    key_idx = jnp.arange(n_ctx)[None, None, :]
    mask_cache = jnp.where(
        (key_idx < frontier[:, None, None]) & (key_idx <= pos[:, :, None]),
        0.0,
        -jnp.inf,
    ).astype(jnp.float32)[:, None, :, :]  # (B, 1, S, n_ctx)
    if mask_new.ndim == 3:
        mask_new = mask_new[:, None]  # (B, 1, S, S)

    from .layers import multi_head_attention_two_part

    def self_attn(q, k_cache, v_cache, k_new, v_new):
        h = multi_head_attention_two_part(
            q, k_cache, v_cache, k_new, v_new,
            cfg.n_text_head, mask_cache, mask_new,
        )
        return h

    x, (k_news, v_news) = _run_decoder_layers(
        dec, cfg, x, cache, self_attn, _cross_attn_default(cfg)
    )
    # only the writable prefix of the block lands in the cache; draft
    # nodes (entries past write_len) are read-only
    k_news = k_news[:, :, :write_len]
    v_news = v_news[:, :, :write_len]

    write = jax.vmap(
        lambda buf, new, p: jax.lax.dynamic_update_slice(
            buf, new, (0, p, 0)
        ),
        in_axes=(1, 1, 0),
        out_axes=1,
    )
    new_self_k = write(cache.self_k, k_news, pos[:, 0])
    new_self_v = write(cache.self_v, v_news, pos[:, 0])

    step_logits, x = _final_logits(dec, x)
    new_cache = cache._replace(self_k=new_self_k, self_v=new_self_v)
    return step_logits, new_cache, x


def decode_step_multipos(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    dtype=jnp.float32,
) -> Tuple[jax.Array, DecoderCache]:
    """decode_step with a PER-ELEMENT position vector: pos (B,) int32."""
    logits, cache, _ = decode_step_multipos_hidden(
        params, cfg, tokens, cache, pos, dtype=dtype
    )
    return logits, cache


def decode_step_multipos_hidden(
    params: Params,
    cfg: WhisperConfig,
    tokens,
    cache: DecoderCache,
    pos,
    dtype=jnp.float32,
) -> Tuple[jax.Array, DecoderCache, jax.Array]:
    """decode_step_multipos that ALSO returns the final-LN hidden states
    (B, S, d) — Medusa-style draft heads condition on them.

    Speculative decoding accepts a different number of draft tokens per
    batch element each round, so element b's next write position diverges
    from element b'. Queries for element b sit at positions
    [pos[b], pos[b]+S); the KV-cache write and the causal mask are per
    element. Everything else matches decode_step.
    """
    dec = params["decoder"]
    B, S = tokens.shape
    n_ctx = cache.self_k.shape[2]

    x = dec["token_embedding"][tokens].astype(dtype)
    # per-element positional slice: (B, S) gather
    pos_idx = pos[:, None] + jnp.arange(S)[None, :]
    x = x + dec["positional_embedding"][pos_idx].astype(dtype)

    # Append-only self-attention (see decode_step): frozen cache rows
    # strictly before each element's pos, plus the S new in-block keys
    # under a causal mask. (B, 1, S, n_ctx + S).
    key_idx = jnp.arange(n_ctx)[None, None, :]
    query_idx = pos_idx[:, :, None]
    mask_cache = jnp.where(
        (key_idx < pos[:, None, None]) & (key_idx <= query_idx),
        0.0,
        -jnp.inf,
    ).astype(jnp.float32)[:, None, :, :]  # (B, 1, S, n_ctx)
    blk = jnp.arange(S)
    mask_new = jnp.where(
        blk[None, :] <= blk[:, None], 0.0, -jnp.inf
    ).astype(jnp.float32)  # (S, S)

    from .layers import multi_head_attention_two_part

    def self_attn(q, k_cache, v_cache, k_new, v_new):
        return multi_head_attention_two_part(
            q, k_cache, v_cache, k_new, v_new,
            cfg.n_text_head, mask_cache, mask_new,
        )

    x, (k_news, v_news) = _run_decoder_layers(
        dec, cfg, x, cache, self_attn, _cross_attn_default(cfg)
    )

    # one per-element in-place landing of the (L, B, S, d) projections
    write = jax.vmap(
        lambda buf, new, p: jax.lax.dynamic_update_slice(
            buf, new, (0, p, 0)
        ),
        in_axes=(1, 1, 0),
        out_axes=1,
    )
    new_self_k = write(cache.self_k, k_news, pos)
    new_self_v = write(cache.self_v, v_news, pos)

    step_logits, x = _final_logits(dec, x)
    new_cache = cache._replace(self_k=new_self_k, self_v=new_self_v)
    return step_logits, new_cache, x


# -- parameter utilities --------------------------------------------------

def count_parameters(params) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))

"""Batched beam-search decoding under a single jitted while_loop.

Whisper-parity semantics: finished hypotheses move to a per-sample pool of
completed candidates (scored with the GNMT length penalty) and their beam
slots are reclaimed by the best unfinished continuations; decoding stops
when every sample has collected ``ceil(beam_size * patience)`` finished
candidates (patience=1.0 default) or the length limit hits. The final
answer is the best pooled candidate (falling back to the best active beam
when nothing finished).

Formulation notes:
  - per-beam top-(K+1) then a K*(K+1) pool: guarantees K unfinished
    candidates without sorting the vocab axis (V=51865) per step
  - every beam/pool reorder is a one-hot einsum, not a gather (>3-D XLA
    gathers inside the loop compiled 3x slower)
  - DEFAULT (v2, r4): the self-KV cache is never reordered — an
    ancestry table + additive select-mask routes each beam to its
    history rows inside the softmax, and the beam-invariant cross cache
    stays at batch B, streaming once per step instead of K times
    (models/whisper.py decode_step_beam). The legacy loop (full one-hot
    cache reorder per step, K-fold cross copies) is kept under
    WHISPER_IPA_LEGACY_BEAM=1 for A/B parity and regression tests.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from ..env import setting
from ..models.whisper import DecoderCache, decode_step, init_cache
from .decoding import (
    DecodingOptions,
    DecodingResult,
    apply_timestamp_rules,
    compression_ratio,
    sequence_score,
)


def _gnmt_penalty(length, length_penalty):
    if length_penalty is None:
        return jnp.maximum(length, 1).astype(jnp.float32)
    return ((5.0 + length.astype(jnp.float32)) / 6.0) ** length_penalty


def _merge_pool(n_pool, pool_sc, pool_sm, pool_ln, pool_tk,
                new_sc, new_sm, new_ln, new_tk):
    """Keep the best n_pool of (pool + new) by penalized score.

    Shared by the legacy and v2 loops — every reorder is a one-hot
    einsum, not a gather (>3-D XLA gathers compile slowly).
    """
    all_sc = jnp.concatenate([pool_sc, new_sc], axis=1)  # (B, P+K)
    all_sm = jnp.concatenate([pool_sm, new_sm], axis=1)
    all_ln = jnp.concatenate([pool_ln, new_ln], axis=1)
    all_tk = jnp.concatenate([pool_tk, new_tk], axis=1)
    best_sc, best_idx = jax.lax.top_k(all_sc, n_pool)  # (B, n_pool)
    onehot = jax.nn.one_hot(best_idx, all_sc.shape[1], dtype=jnp.float32)
    sm = jnp.einsum("bpj,bj->bp", onehot, all_sm)
    ln = jnp.einsum("bpj,bj->bp", onehot, all_ln.astype(jnp.float32))
    tk = jnp.einsum("bpj,bjl->bpl", onehot, all_tk.astype(jnp.float32))
    return best_sc, sm, ln.astype(jnp.int32), tk.astype(jnp.int32)


@partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "n_prefix",
        "sample_len",
        "beam_size",
        "n_pool",
        "has_length_penalty",
        "length_penalty_value",
        "timestamp_rules",
        "timestamp_begin",
        "max_initial_ts_index",
        "sot_index",
        "cross_kv_int8",
    ),
)
def _beam_decode_jit(
    params,
    cfg: WhisperConfig,
    audio_features,  # (B, 1500, d)
    prefix_tokens,  # (B, n_prefix)
    suppress_mask,
    blank_mask,
    eot: int,
    n_prefix: int,
    sample_len: int,
    beam_size: int,
    n_pool: int,
    has_length_penalty: bool,
    length_penalty_value: float,
    timestamp_rules: bool = False,
    timestamp_begin: int = 50364,
    max_initial_ts_index: int = 50,
    sot_index: int = 0,
    cross_kv_int8: bool = False,
):
    B = audio_features.shape[0]
    K = beam_size
    C = K + 1  # candidates per beam: at most one can be EOT
    max_len = n_prefix + sample_len
    lp_arg = length_penalty_value if has_length_penalty else None
    neg_inf = jnp.float32(-jnp.inf)
    V = cfg.n_vocab
    vocab_idx = jnp.arange(V)

    def ts_filter(logits, step, prev_tok, prev2_tok, last_ts):
        """Timestamp grammar over (..., V) logits (static no-op if off)."""
        if not timestamp_rules:
            return logits
        return apply_timestamp_rules(
            logits,
            vocab_idx,
            step,
            prev_tok,
            prev2_tok,
            last_ts,
            eot=eot,
            timestamp_begin=timestamp_begin,
            max_initial_ts_index=max_initial_ts_index,
        )

    # prefix pass at batch B, then tile cache across beams -> batch B*K
    cache = init_cache(
        params, cfg, audio_features, max_len=max_len,
        cross_kv_int8=cross_kv_int8,
    )
    prefix_logits, cache = decode_step(params, cfg, prefix_tokens, cache, 0)
    cache = DecoderCache(
        *[None if x is None else jnp.repeat(x, K, axis=1) for x in cache]
    )
    sot_logits = prefix_logits[:, sot_index]  # for no_speech_prob

    # first expansion: top-K tokens from the prefix logits
    logits0 = prefix_logits[:, -1] + suppress_mask + blank_mask  # (B, V)
    logits0 = ts_filter(
        logits0,
        jnp.array(0, jnp.int32),
        prefix_tokens[:, -1].astype(jnp.int32),
        (
            prefix_tokens[:, -2] if n_prefix >= 2 else prefix_tokens[:, -1]
        ).astype(jnp.int32),
        jnp.full((B,), timestamp_begin - 1, jnp.int32),
    )
    logprobs0 = jax.nn.log_softmax(logits0, axis=-1)
    top_lp, top_tok = jax.lax.top_k(logprobs0, K)  # (B, K)

    # per-beam timestamp-grammar state
    prev_tok = top_tok.astype(jnp.int32)  # (B, K)
    prev2_tok = jnp.tile(
        prefix_tokens[:, -1:].astype(jnp.int32), (1, K)
    )  # (B, K)
    last_ts = jnp.where(
        prev_tok >= timestamp_begin, prev_tok, timestamp_begin - 1
    )

    tokens_buf = jnp.full((B, K, max_len), eot, jnp.int32)
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf,
        jnp.tile(prefix_tokens[:, None, :], (1, K, 1)).astype(jnp.int32),
        (0, 0, 0),
    )
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf, top_tok[:, :, None].astype(jnp.int32), (0, 0, n_prefix)
    )
    sum_logprobs = top_lp  # (B, K) raw sums of ACTIVE beams
    lengths = jnp.ones((B, K), jnp.int32)

    # finished-candidate pool (penalized scores; raw sums kept for output)
    pool_scores = jnp.full((B, n_pool), neg_inf)
    pool_sums = jnp.zeros((B, n_pool), jnp.float32)
    pool_lens = jnp.zeros((B, n_pool), jnp.int32)
    pool_tokens = jnp.full((B, n_pool, max_len), eot, jnp.int32)

    flat_tok = top_tok.reshape(B * K, 1).astype(jnp.int32)
    logits, cache = decode_step(params, cfg, flat_tok, cache, n_prefix)
    logits = logits[:, 0].reshape(B, K, V)

    def body(state):
        (
            step,
            tokens_buf,
            cache,
            logits,
            sum_logprobs,
            lengths,
            pool_scores,
            pool_sums,
            pool_lens,
            pool_tokens,
            prev_tok,
            prev2_tok,
            last_ts,
        ) = state

        # step 0 of this loop is the SECOND sampled position (the first was
        # the top-K expansion above), hence step + 1 for the grammar
        filtered = ts_filter(
            logits + suppress_mask, step + 1, prev_tok, prev2_tok, last_ts
        )
        lp = jax.nn.log_softmax(filtered, axis=-1)  # (B,K,V)
        cand_lp, cand_tok = jax.lax.top_k(lp, C)  # (B, K, C)
        cand_scores = sum_logprobs[:, :, None] + cand_lp
        flat_scores = cand_scores.reshape(B, K * C)
        flat_tok = cand_tok.reshape(B, K * C)
        is_eot = flat_tok == eot

        # ---- finished candidates -> pool
        fin_scores_raw = jnp.where(is_eot, flat_scores, neg_inf)
        fin_top, fin_idx = jax.lax.top_k(fin_scores_raw, K)  # (B, K)
        fin_onehot = jax.nn.one_hot(fin_idx, K * C, dtype=jnp.float32)
        parent = fin_idx // C  # (B, K) parent beam of each finished cand
        parent_onehot = jax.nn.one_hot(parent, K, dtype=jnp.float32)
        fin_lens = jnp.einsum(
            "bkj,bj->bk", parent_onehot, lengths.astype(jnp.float32)
        ).astype(jnp.int32)
        fin_tokens = jnp.einsum(
            "bkj,bjl->bkl", parent_onehot, tokens_buf.astype(jnp.float32)
        ).astype(jnp.int32)
        fin_pen = fin_top / _gnmt_penalty(fin_lens, lp_arg)
        fin_pen = jnp.where(fin_top == neg_inf, neg_inf, fin_pen)
        pool_scores, pool_sums, pool_lens, pool_tokens = _merge_pool(
            n_pool, pool_scores, pool_sums, pool_lens, pool_tokens,
            fin_pen, fin_top, fin_lens, fin_tokens,
        )

        # ---- unfinished candidates -> new active beams
        unf_scores = jnp.where(is_eot, neg_inf, flat_scores)
        new_sums, unf_idx = jax.lax.top_k(unf_scores, K)  # (B, K)
        new_tok = jnp.take_along_axis(flat_tok, unf_idx, axis=1).astype(
            jnp.int32
        )
        beam_idx = unf_idx // C
        onehot = jax.nn.one_hot(beam_idx, K, dtype=jnp.float32)  # (B,Kn,Ko)

        tokens_buf = jnp.einsum(
            "bjk,bkl->bjl", onehot, tokens_buf.astype(jnp.float32)
        ).astype(jnp.int32)
        lengths = jnp.einsum(
            "bjk,bk->bj", onehot, lengths.astype(jnp.float32)
        ).astype(jnp.int32)

        def gather_cache(x):  # (L, B*K, ...) beams reordered per sample
            L = x.shape[0]
            xs = x.reshape((L, B, K) + x.shape[2:])
            xs = jnp.einsum("bjk,lbkcd->lbjcd", onehot.astype(x.dtype), xs)
            return xs.reshape(x.shape)

        # only the SELF cache depends on beam history; the cross cache is
        # identical across a sample's beams, so reordering it would be a
        # (very expensive: B*K x 1500 x d x L bytes/step) identity gather
        cache = cache._replace(
            self_k=gather_cache(cache.self_k),
            self_v=gather_cache(cache.self_v),
        )

        # timestamp-grammar state follows the beam reorder: the parent's
        # last token becomes prev2, the new token becomes prev
        prev2_tok = jnp.einsum(
            "bjk,bk->bj", onehot, prev_tok.astype(jnp.float32)
        ).astype(jnp.int32)
        last_ts = jnp.einsum(
            "bjk,bk->bj", onehot, last_ts.astype(jnp.float32)
        ).astype(jnp.int32)
        prev_tok = new_tok
        last_ts = jnp.where(new_tok >= timestamp_begin, new_tok, last_ts)

        pos = n_prefix + step + 1
        tokens_buf = jax.lax.dynamic_update_slice(
            tokens_buf, new_tok[:, :, None], (0, 0, pos)
        )
        lengths = lengths + 1
        sum_logprobs = new_sums

        new_logits, cache = decode_step(
            params, cfg, new_tok.reshape(B * K, 1), cache, pos
        )
        new_logits = new_logits[:, 0].reshape(B, K, V)
        return (
            step + 1,
            tokens_buf,
            cache,
            new_logits,
            sum_logprobs,
            lengths,
            pool_scores,
            pool_sums,
            pool_lens,
            pool_tokens,
            prev_tok,
            prev2_tok,
            last_ts,
        )

    def cond(state):
        step = state[0]
        pool_scores = state[6]
        enough = jnp.all(
            jnp.sum(pool_scores > neg_inf, axis=1) >= n_pool
        )
        return (step < sample_len - 1) & ~enough

    state = (
        jnp.array(0, jnp.int32),
        tokens_buf,
        cache,
        logits,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        prev_tok,
        prev2_tok,
        last_ts,
    )
    out = jax.lax.while_loop(cond, body, state)
    (
        _,
        tokens_buf,
        _,
        _,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        _,
        _,
        _,
    ) = out
    return (
        tokens_buf,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        sot_logits,
    )


@partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "n_prefix",
        "sample_len",
        "beam_size",
        "n_pool",
        "has_length_penalty",
        "length_penalty_value",
        "timestamp_rules",
        "timestamp_begin",
        "max_initial_ts_index",
        "sot_index",
        "cross_kv_int8",
        "cross_kv_int4",
        "dtype_name",
    ),
)
def _beam_decode_jit_v2(
    params,
    cfg: WhisperConfig,
    audio_features,  # (B, 1500, d)
    prefix_tokens,  # (B, n_prefix)
    suppress_mask,
    blank_mask,
    eot: int,
    n_prefix: int,
    sample_len: int,
    beam_size: int,
    n_pool: int,
    has_length_penalty: bool,
    length_penalty_value: float,
    timestamp_rules: bool = False,
    timestamp_begin: int = 50364,
    max_initial_ts_index: int = 50,
    sot_index: int = 0,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
    dtype_name: str = "float32",
):
    """Reorder-free beam search (same semantics as _beam_decode_jit).

    Two HBM-traffic changes over the legacy loop (models/whisper.py
    decode_step_beam has the mechanics):
      - the self-KV cache is never physically reordered — an ancestry
        table + additive select-mask routes each beam to its history
        rows inside the softmax (the per-step one-hot reorder einsum
        was a full cache copy, the dominant per-step HBM term);
      - the beam-invariant cross-KV cache stays at batch B instead of
        being repeated K-fold, and streams ONCE per step with the K
        beam queries on the query-sequence axis.
    Also threads bf16 compute (``dtype_name``), which the legacy jit
    never did. Output contract matches _beam_decode_jit exactly.
    """
    from ..models.whisper import cast_decoder_blocks, decode_step_beam

    dtype = jnp.dtype(dtype_name)
    # hoist the per-(layer, step) weight converts out of the loop
    params = cast_decoder_blocks(params, dtype)
    B = audio_features.shape[0]
    K = beam_size
    C = K + 1  # candidates per beam: at most one can be EOT
    max_len = n_prefix + sample_len
    lp_arg = length_penalty_value if has_length_penalty else None
    neg_inf = jnp.float32(-jnp.inf)
    V = cfg.n_vocab
    vocab_idx = jnp.arange(V)

    def ts_filter(logits, step, prev_tok, prev2_tok, last_ts):
        if not timestamp_rules:
            return logits
        return apply_timestamp_rules(
            logits,
            vocab_idx,
            step,
            prev_tok,
            prev2_tok,
            last_ts,
            eot=eot,
            timestamp_begin=timestamp_begin,
            max_initial_ts_index=max_initial_ts_index,
        )

    # prefix pass at batch B; then K-fold ONLY the self cache (the
    # prefix K/V is identical across beams, so every physical row holds
    # a valid copy and anc[b, j, p] = j is consistent from the start)
    cache = init_cache(
        params, cfg, audio_features, max_len=max_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4,
    )
    prefix_logits, cache = decode_step(
        params, cfg, prefix_tokens, cache, 0, dtype=dtype
    )
    cache = cache._replace(
        self_k=jnp.repeat(cache.self_k, K, axis=1),
        self_v=jnp.repeat(cache.self_v, K, axis=1),
    )
    anc = jnp.tile(
        jnp.arange(K, dtype=jnp.int32)[None, :, None], (B, 1, max_len)
    )
    sot_logits = prefix_logits[:, sot_index]

    logits0 = prefix_logits[:, -1] + suppress_mask + blank_mask  # (B, V)
    logits0 = ts_filter(
        logits0,
        jnp.array(0, jnp.int32),
        prefix_tokens[:, -1].astype(jnp.int32),
        (
            prefix_tokens[:, -2] if n_prefix >= 2 else prefix_tokens[:, -1]
        ).astype(jnp.int32),
        jnp.full((B,), timestamp_begin - 1, jnp.int32),
    )
    logprobs0 = jax.nn.log_softmax(logits0, axis=-1)
    top_lp, top_tok = jax.lax.top_k(logprobs0, K)  # (B, K)

    prev_tok = top_tok.astype(jnp.int32)
    prev2_tok = jnp.tile(prefix_tokens[:, -1:].astype(jnp.int32), (1, K))
    last_ts = jnp.where(
        prev_tok >= timestamp_begin, prev_tok, timestamp_begin - 1
    )

    tokens_buf = jnp.full((B, K, max_len), eot, jnp.int32)
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf,
        jnp.tile(prefix_tokens[:, None, :], (1, K, 1)).astype(jnp.int32),
        (0, 0, 0),
    )
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf, top_tok[:, :, None].astype(jnp.int32), (0, 0, n_prefix)
    )
    sum_logprobs = top_lp
    lengths = jnp.ones((B, K), jnp.int32)

    pool_scores = jnp.full((B, n_pool), neg_inf)
    pool_sums = jnp.zeros((B, n_pool), jnp.float32)
    pool_lens = jnp.zeros((B, n_pool), jnp.int32)
    pool_tokens = jnp.full((B, n_pool, max_len), eot, jnp.int32)

    logits, cache = decode_step_beam(
        params, cfg, top_tok.astype(jnp.int32), cache, n_prefix, anc,
        dtype=dtype,
    )  # (B, K, V)

    def body(state):
        (
            step,
            tokens_buf,
            cache,
            anc,
            logits,
            sum_logprobs,
            lengths,
            pool_scores,
            pool_sums,
            pool_lens,
            pool_tokens,
            prev_tok,
            prev2_tok,
            last_ts,
        ) = state

        filtered = ts_filter(
            logits + suppress_mask, step + 1, prev_tok, prev2_tok, last_ts
        )
        lp = jax.nn.log_softmax(filtered, axis=-1)  # (B,K,V)
        cand_lp, cand_tok = jax.lax.top_k(lp, C)
        cand_scores = sum_logprobs[:, :, None] + cand_lp
        flat_scores = cand_scores.reshape(B, K * C)
        flat_tok = cand_tok.reshape(B, K * C)
        is_eot = flat_tok == eot

        # ---- finished candidates -> pool
        fin_scores_raw = jnp.where(is_eot, flat_scores, neg_inf)
        fin_top, fin_idx = jax.lax.top_k(fin_scores_raw, K)
        parent = fin_idx // C
        parent_onehot = jax.nn.one_hot(parent, K, dtype=jnp.float32)
        fin_lens = jnp.einsum(
            "bkj,bj->bk", parent_onehot, lengths.astype(jnp.float32)
        ).astype(jnp.int32)
        fin_tokens = jnp.einsum(
            "bkj,bjl->bkl", parent_onehot, tokens_buf.astype(jnp.float32)
        ).astype(jnp.int32)
        fin_pen = fin_top / _gnmt_penalty(fin_lens, lp_arg)
        fin_pen = jnp.where(fin_top == neg_inf, neg_inf, fin_pen)
        pool_scores, pool_sums, pool_lens, pool_tokens = _merge_pool(
            n_pool, pool_scores, pool_sums, pool_lens, pool_tokens,
            fin_pen, fin_top, fin_lens, fin_tokens,
        )

        # ---- unfinished candidates -> new active beams
        unf_scores = jnp.where(is_eot, neg_inf, flat_scores)
        new_sums, unf_idx = jax.lax.top_k(unf_scores, K)
        new_tok = jnp.take_along_axis(flat_tok, unf_idx, axis=1).astype(
            jnp.int32
        )
        beam_idx = unf_idx // C
        onehot = jax.nn.one_hot(beam_idx, K, dtype=jnp.float32)  # (B,Kn,Ko)

        tokens_buf = jnp.einsum(
            "bjk,bkl->bjl", onehot, tokens_buf.astype(jnp.float32)
        ).astype(jnp.int32)
        lengths = jnp.einsum(
            "bjk,bk->bj", onehot, lengths.astype(jnp.float32)
        ).astype(jnp.int32)

        # the CACHE stays put; only the tiny ancestry table reorders.
        # New beam j inherits parent's row map for p < pos and will
        # write its own K/V at physical row j at pos.
        pos = n_prefix + step + 1
        anc = jnp.einsum(
            "bjk,bkp->bjp", onehot, anc.astype(jnp.float32)
        ).astype(jnp.int32)
        anc = jax.lax.dynamic_update_slice(
            anc,
            jnp.tile(jnp.arange(K, dtype=jnp.int32)[None, :, None], (B, 1, 1)),
            (0, 0, pos),
        )

        prev2_tok = jnp.einsum(
            "bjk,bk->bj", onehot, prev_tok.astype(jnp.float32)
        ).astype(jnp.int32)
        last_ts = jnp.einsum(
            "bjk,bk->bj", onehot, last_ts.astype(jnp.float32)
        ).astype(jnp.int32)
        prev_tok = new_tok
        last_ts = jnp.where(new_tok >= timestamp_begin, new_tok, last_ts)

        tokens_buf = jax.lax.dynamic_update_slice(
            tokens_buf, new_tok[:, :, None], (0, 0, pos)
        )
        lengths = lengths + 1
        sum_logprobs = new_sums

        new_logits, cache = decode_step_beam(
            params, cfg, new_tok, cache, pos, anc, dtype=dtype
        )
        return (
            step + 1,
            tokens_buf,
            cache,
            anc,
            new_logits,
            sum_logprobs,
            lengths,
            pool_scores,
            pool_sums,
            pool_lens,
            pool_tokens,
            prev_tok,
            prev2_tok,
            last_ts,
        )

    def cond(state):
        step = state[0]
        pool_scores = state[7]
        enough = jnp.all(
            jnp.sum(pool_scores > neg_inf, axis=1) >= n_pool
        )
        return (step < sample_len - 1) & ~enough

    state = (
        jnp.array(0, jnp.int32),
        tokens_buf,
        cache,
        anc,
        logits,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        prev_tok,
        prev2_tok,
        last_ts,
    )
    out = jax.lax.while_loop(cond, body, state)
    tokens_buf = out[1]
    sum_logprobs = out[5]
    lengths = out[6]
    pool_scores = out[7]
    pool_sums = out[8]
    pool_lens = out[9]
    pool_tokens = out[10]
    return (
        tokens_buf,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        sot_logits,
    )


def beam_decode(
    params,
    cfg: WhisperConfig,
    audio_features,
    prefix: List[int],
    options: DecodingOptions,
    tokenizer,
    suppress_mask,
    blank_mask,
    prefix_tokens=None,
    sot_index: int = 0,
    max_initial_ts_index: int = 50,
    detected_langs: Optional[List[str]] = None,
) -> List[DecodingResult]:
    B = audio_features.shape[0]
    n_prefix = len(prefix)
    sample_len = options.sample_len or (cfg.n_text_ctx // 2)
    sample_len = min(sample_len, cfg.n_text_ctx - n_prefix)
    if prefix_tokens is None:
        prefix_tokens = jnp.tile(
            jnp.asarray(prefix, jnp.int32)[None, :], (B, 1)
        )

    K = int(options.beam_size)
    patience = float(options.patience) if options.patience else 1.0
    n_pool = max(K, int(math.ceil(K * patience)))

    blank = (
        blank_mask
        if options.suppress_blank
        else jnp.zeros_like(suppress_mask)
    )
    # reorder-free v2 loop is the default; the legacy full-reorder loop
    # stays for A/B parity and perf regression checks
    legacy = setting("LEGACY_BEAM") == "1"
    extra = (
        {}
        if legacy
        else {
            "dtype_name": "bfloat16" if options.fp16 else "float32",
            "cross_kv_int4": options.kv_int4,
        }
    )
    if legacy and options.kv_int4:
        raise ValueError(
            "int4 cross-KV beam search needs the v2 loop (unset "
            "WHISPER_IPA_LEGACY_BEAM)"
        )
    (
        tokens_buf,
        sum_logprobs,
        lengths,
        pool_scores,
        pool_sums,
        pool_lens,
        pool_tokens,
        sot_logits,
    ) = (_beam_decode_jit if legacy else _beam_decode_jit_v2)(
        params,
        cfg,
        audio_features,
        prefix_tokens,
        suppress_mask,
        blank,
        tokenizer.eot,
        n_prefix,
        int(sample_len),
        K,
        n_pool,
        options.length_penalty is not None,
        float(options.length_penalty or 0.0),
        timestamp_rules=not options.without_timestamps,
        timestamp_begin=tokenizer.timestamp_begin,
        max_initial_ts_index=max_initial_ts_index,
        sot_index=sot_index,
        cross_kv_int8=options.kv_int8,
        **extra,
    )

    no_speech_probs = np.asarray(
        jax.nn.softmax(sot_logits, axis=-1)[:, tokenizer.no_speech]
    )
    tokens_np = np.asarray(tokens_buf)
    sums_np = np.asarray(sum_logprobs)
    pool_scores_np = np.asarray(pool_scores)
    pool_sums_np = np.asarray(pool_sums)
    pool_lens_np = np.asarray(pool_lens)
    pool_tokens_np = np.asarray(pool_tokens)

    results = []
    for b in range(B):
        finished = pool_scores_np[b] > -np.inf
        if finished.any():
            k = int(np.argmax(pool_scores_np[b]))
            length = int(pool_lens_np[b, k])
            seq = pool_tokens_np[b, k, n_prefix : n_prefix + length].tolist()
            total_lp = float(pool_sums_np[b, k])
        else:
            # nothing finished within the length limit: best active beam
            best_score = -np.inf
            k_best = 0
            for k in range(K):
                score = sequence_score(
                    float(sums_np[b, k]),
                    int(np.asarray(lengths)[b, k]),
                    options.length_penalty,
                )
                if score > best_score:
                    best_score = score
                    k_best = k
            seq_full = tokens_np[b, k_best, n_prefix:]
            eot_pos = np.nonzero(seq_full == tokenizer.eot)[0]
            end = int(eot_pos[0]) if len(eot_pos) else len(seq_full)
            seq = seq_full[:end].tolist()
            total_lp = float(sums_np[b, k_best])
            length = end
        text = tokenizer.decode_text(seq).strip()
        results.append(
            DecodingResult(
                tokens=seq,
                text=text,
                avg_logprob=total_lp / (length + 1),
                no_speech_prob=float(no_speech_probs[b]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
                language=(
                    detected_langs[b]
                    if detected_langs
                    else options.language or tokenizer.language
                ),
            )
        )
    return results

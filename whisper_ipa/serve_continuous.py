"""Continuous (in-flight) batching: requests join a RUNNING decode batch.

The micro-batching service (serve.py) coalesces requests into fixed
batches — a request arriving mid-batch waits for the whole batch to
finish. This engine instead keeps one persistent decode state of
``slots`` sequences and lets new requests claim finished/empty slots
between steps, the pattern production LLM servers use (Orca-style
in-flight batching), rebuilt for fixed-shape XLA programs:

- every slot has its own length, so steps run through
  ``models.whisper.decode_step_multipos`` (per-element positions, causal
  masks, and KV writes) — one fixed-shape XLA program regardless of
  which slots are active;
- a JOIN feeds the new slot's SOT prefix at position 0 while every other
  slot re-feeds its latest token at its own frontier — rewriting a
  cached position with the same token recomputes identical K/V, so
  active slots are undisturbed (same invariant speculative decoding
  relies on); stale data in a reclaimed slot is never visible because
  the causal mask hides indices past each slot's frontier and writes
  land before reads;
- per-slot cross-attention K/V is scattered into the persistent cache
  when a request joins (one encoder forward per request);
- steps run in chunks of ``steps_per_sync`` under ``lax.scan`` between
  host syncs: the sync reads the emitted tokens to detect EOT and admit
  joiners, and doubles as token-level streaming (``on_token``).

Trade-off vs serve.py: continuous batching pays one small device->host
fetch per chunk for zero queue-to-start latency and per-token streaming;
the micro-batch service keeps the whole decode in one while_loop program
for maximum throughput. The reference has neither (batch-1 scripts,
reference scripts/evaluate_model.py:179).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .audio import N_SAMPLES, load_audio, log_mel_spectrogram, pad_or_trim
from .config import WhisperConfig
from .decode.decoding import (
    DecodingOptions,
    build_blank_mask,
    build_suppress_mask,
    initial_tokens,
)
from .models.whisper import (
    DecoderCache,
    cast_decoder_blocks,
    decode_step_multipos,
    encode,
    init_cache,
)
from .tokenizer import WhisperTokenizer, get_tokenizer


@partial(jax.jit, static_argnames=("cfg", "dtype_name"))
def _encode_one(params, cfg: WhisperConfig, mel, dtype_name="float32"):
    return encode(params, cfg, mel, dtype=jnp.dtype(dtype_name))


@partial(jax.jit, static_argnames=("cfg", "dtype_name", "cross_kv_int8"))
def _cross_kv_one(params, cfg: WhisperConfig, features, n_ctx: int = 8,
                  dtype_name="float32", cross_kv_int8=False):
    """Cross K/V (+ empty self buffers) for one utterance's features."""
    return init_cache(
        params, cfg, features, max_len=n_ctx,
        dtype=jnp.dtype(dtype_name), cross_kv_int8=cross_kv_int8,
    )


@partial(jax.jit, donate_argnames=("cache",))
def _scatter_slot(cache: DecoderCache, one: DecoderCache, slot):
    """Install one request's cross-K/V into batch slot `slot`."""

    def put(big, small):
        if big is None:
            return None
        return big.at[:, slot].set(small[:, 0])

    return DecoderCache(
        self_k=cache.self_k,
        self_v=cache.self_v,
        cross_k=put(cache.cross_k, one.cross_k),
        cross_v=put(cache.cross_v, one.cross_v),
        cross_k_scale=put(cache.cross_k_scale, one.cross_k_scale),
        cross_v_scale=put(cache.cross_v_scale, one.cross_v_scale),
    )


@partial(
    jax.jit, static_argnames=("cfg", "dtype_name"),
    donate_argnames=("cache",),
)
def _join_step(
    params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    tokens,  # (B, n_prefix): joiners get their prefix, others re-feed
    pos,  # (B,): 0 for joiners, lens - n_prefix for active slots
    dtype_name="float32",
):
    """Consume the SOT prefix for joining slots; re-feed everyone else."""
    _, cache = decode_step_multipos(
        params, cfg, tokens, cache, pos, dtype=jnp.dtype(dtype_name)
    )
    return cache


@partial(
    jax.jit, static_argnames=("cfg", "dtype_name"),
    donate_argnames=("cache",),
)
def _join_step_hidden(
    params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    tokens,  # (B, n_prefix)
    pos,  # (B,)
    dtype_name="float32",
):
    """_join_step that also returns each slot's frontier hidden state.

    Medusa heads draft from the final-LN hidden of the input token at
    position lens-2 (head k at h_t predicts the token at t+k+2,
    models/medusa.py). In the join block, position lens-2 is block
    index n_prefix-2 for joiners (pos=0, lens becomes n_prefix) AND for
    re-feeders (pos = lens-n_prefix, so block index lens-2-pos), so one
    slice serves both.
    """
    from .models.whisper import decode_step_multipos_hidden

    _, cache, hidden = decode_step_multipos_hidden(
        params, cfg, tokens, cache, pos, dtype=jnp.dtype(dtype_name)
    )
    return cache, hidden[:, tokens.shape[1] - 2]


@partial(
    jax.jit, static_argnames=("cfg", "dtype_name"),
    donate_argnames=("cache",),
)
def _join_step_tree(
    params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    tokens,  # (B, W): each slot's last W tokens, EOT-padded past lens
    start,  # (B,): max(lens - W, 0)
    lens_eff,  # (B,): prefix + content token count per slot
    dtype_name="float32",
):
    """Join step for TREE-medusa mode (width W >= tree_K + 2).

    The chain-medusa join re-feeds n_prefix tokens — enough there
    because chain rounds write every accepted token's KV via the
    multipos step. A TREE round accepts up to K+1 tokens whose KV was
    NEVER written (tree nodes are read-only), so a join between chunks
    must re-feed at least K+2 rows; an n_prefix-wide join could read
    stale cache rows below its window and recompute a wrong frontier
    hidden (and wrong re-written KV). W = max(n_prefix, K+2) heals
    every unwritten row; garbage entries past each slot's lens are
    masked (same policy as the tree round's re-feed). Returns the
    cache and the per-slot hidden of the input at lens-2 (the Medusa
    draft frontier).
    """
    from .models.whisper import decode_step_block

    B, W = tokens.shape
    pos = start[:, None] + jnp.arange(W)[None, :]  # (B, W)
    real = pos < lens_eff[:, None]
    mask_new = jnp.where(
        real[:, None, :] & (pos[:, None, :] <= pos[:, :, None]),
        0.0,
        -jnp.inf,
    ).astype(jnp.float32)  # (B, W, W)
    _, cache, hidden = decode_step_block(
        params, cfg, tokens, cache, pos, start, mask_new,
        write_len=W, dtype=jnp.dtype(dtype_name),
    )
    idx = lens_eff - 2 - start  # block index of the input at lens-2
    hf = jnp.take_along_axis(hidden, idx[:, None, None], axis=1)[:, 0]
    return cache, hf


@partial(
    jax.jit,
    static_argnames=("cfg", "n_steps", "n_prefix", "max_new", "dtype_name"),
    donate_argnames=("cache",),
)
def _decode_chunk(
    params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    last_tok,  # (B,)
    lens,  # (B,)
    finished,  # (B,) bool
    suppress_mask,
    blank_mask,
    eot: int,
    n_steps: int,
    n_prefix: int,
    max_new: int,
    dtype_name="float32",
):
    """Advance every slot by up to n_steps tokens (frozen once finished).

    Each step re-feeds the slot's latest token at its frontier (an
    identical-KV rewrite) and samples the next greedily. Returns the
    (n_steps, B) emitted tokens for the host to inspect: -1 marks a
    halted slot (finished, or its max_new budget exhausted — the budget
    is enforced HERE, on device, so a chunk never advances lens past
    n_prefix + max_new and never writes KV beyond the cache; a
    start-clamped dynamic_update_slice would silently corrupt the
    frontier row otherwise).

    Runs as a while_loop with an all-halted early exit: once every slot
    is finished (or budget-frozen) the device stops instead of burning
    the remaining rounds on frozen state. Output-identical to the fixed
    lax.scan it replaces — halted slots emit -1 either way, and the
    token buffer is pre-filled with -1 — but long chunks (the adaptive
    steps-per-sync mode) stop paying for drained batches.
    """
    dtype = jnp.dtype(dtype_name)
    params = cast_decoder_blocks(params, dtype)
    B = last_tok.shape[0]
    toks_buf = jnp.full((n_steps, B), -1, jnp.int32)

    def cond(state):
        step, cache, last_tok, lens, finished, toks = state
        halted = finished | (lens - n_prefix >= max_new)
        return (step < n_steps) & ~jnp.all(halted)

    def body(state):
        step, cache, last_tok, lens, finished, toks = state
        halted = finished | (lens - n_prefix >= max_new)
        logits, cache = decode_step_multipos(
            params, cfg, last_tok[:, None], cache, lens - 1, dtype=dtype
        )
        lg = logits[:, 0] + suppress_mask
        lg = jnp.where((lens == n_prefix)[:, None], lg + blank_mask, lg)
        nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        nxt = jnp.where(halted, -1, nxt)
        lens = jnp.where(halted, lens, lens + 1)
        finished = halted | (nxt == eot)
        last_tok = jnp.where((nxt == eot) | (nxt < 0), last_tok, nxt)
        toks = jax.lax.dynamic_update_slice(toks, nxt[None, :], (step, 0))
        return step + 1, cache, last_tok, lens, finished, toks

    state = (jnp.array(0, jnp.int32), cache, last_tok, lens, finished,
             toks_buf)
    _, cache, last_tok, lens, finished, toks = jax.lax.while_loop(
        cond, body, state
    )
    return cache, last_tok, lens, finished, toks


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "n_rounds", "draft_k", "n_prefix", "max_new", "dtype_name",
    ),
    donate_argnames=("cache",),
)
def _spec_chunk(
    params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    tokens_buf,  # (B, buf_len) int32: prefix + emitted so far, EOT-padded
    last_tok,  # (B,)
    lens,  # (B,)
    finished,  # (B,) bool
    suppress_mask,
    blank_mask,
    eot: int,
    n_rounds: int,
    draft_k: int,
    n_prefix: int,
    max_new: int,
    dtype_name="float32",
):
    """n_rounds speculative verification rounds, entirely on device.

    Each round drafts K tokens per slot by prompt-lookup over tokens_buf
    (decode.speculative._ngram_drafts), verifies them in one (K+1)-query
    forward, and accepts the longest matching run plus the correction
    token — token-identical to single-step greedy. Running the drafting
    and accept logic on device lets one host sync cover n_rounds rounds;
    a host round-trip per round would otherwise bound every round by the
    host's latency. Rejected draft K/V is overwritten by the next
    round's frontier re-feed (the invariant joins rely on).

    Returns per-round emissions for the host: emits (n_rounds, B, K+1)
    and counts v (n_rounds, B) — row r emits emits[r, b, :v[r, b]]
    (EOT included when hit).
    """
    from .decode.speculative import _ngram_drafts

    dtype = jnp.dtype(dtype_name)
    params = cast_decoder_blocks(params, dtype)
    K = draft_k
    idx = jnp.arange(K + 1)[None, :]
    write_row = jax.vmap(
        lambda buf, new, p: jax.lax.dynamic_update_slice_in_dim(
            buf, new, p, axis=0
        )
    )

    def round_body(carry, _):
        cache, tokens_buf, last_tok, lens, finished = carry
        drafts = _ngram_drafts(tokens_buf, lens, K)  # (B, K)
        block = jnp.concatenate([last_tok[:, None], drafts], axis=1)
        logits, cache = decode_step_multipos(
            params, cfg, block, cache, lens - 1, dtype=dtype
        )
        slots = lens[:, None] + idx  # logits[:, i] predicts slot lens+i
        lg = logits + suppress_mask
        lg = jnp.where((slots == n_prefix)[..., None], lg + blank_mask, lg)
        greedy = jnp.argmax(lg, axis=-1).astype(jnp.int32)  # (B, K+1)

        match = greedy[:, :K] == drafts
        a = jnp.cumprod(match.astype(jnp.int32), axis=1).sum(axis=1)
        eot_hit = (greedy == eot) & (idx <= a[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, a + 1)
        budget = max_new - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        emit_w = jnp.where(idx < v[:, None], greedy, eot)
        tokens_buf = write_row(tokens_buf, emit_w, lens)
        # engine lens counts CONTENT tokens (the EOT itself is not
        # content); the last content token precedes any emitted EOT
        ate_eot = any_eot & (first_eot < v)
        last_idx = jnp.where(ate_eot, first_eot - 1, v - 1)
        last_emit = jnp.take_along_axis(
            greedy, jnp.maximum(last_idx, 0)[:, None], axis=1
        )[:, 0]
        last_tok = jnp.where(last_idx >= 0, last_emit, last_tok)
        lens = lens + v - jnp.where(ate_eot, 1, 0)
        finished = finished | ate_eot | (lens - n_prefix >= max_new)
        return (cache, tokens_buf, last_tok, lens, finished), (emit_w, v)

    (cache, tokens_buf, last_tok, lens, finished), (emits, vs) = (
        jax.lax.scan(
            round_body,
            (cache, tokens_buf, last_tok, lens, finished),
            None,
            length=n_rounds,
        )
    )
    return cache, last_tok, lens, finished, emits, vs


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "draft_cfg", "n_rounds", "draft_k", "n_prefix", "max_new",
        "dtype_name",
    ),
    donate_argnames=("cache", "draft_cache"),
)
def _spec_chunk_model(
    params,
    draft_params,
    cfg: WhisperConfig,
    draft_cfg: WhisperConfig,
    cache: DecoderCache,
    draft_cache: DecoderCache,
    last_tok,  # (B,)
    lens,  # (B,)
    finished,  # (B,) bool
    suppress_mask,
    blank_mask,
    eot: int,
    n_rounds: int,
    draft_k: int,
    n_prefix: int,
    max_new: int,
    dtype_name="float32",
):
    """n_rounds MODEL-draft verification rounds, entirely on device.

    Each round runs K autoregressive single steps of the persistent
    DRAFT model (its own self/cross KV cache, same slot layout), then
    one (K+1)-query verification forward of the target — emitted tokens
    are exactly the target's greedy decode, as in _spec_chunk. The
    draft's cache needs NO repair pass: accepted tokens equal the draft
    tokens whose K/V the drafting steps already wrote, and the one
    correction token's row is rewritten by the next round's first draft
    step (the same identical-KV frontier re-feed the joins rely on —
    the correction lands at exactly lens_new - 1). Drafting applies the
    same suppress/blank masks as verification so the draft can't
    propose tokens the target is forbidden to accept.

    Emission contract matches _spec_chunk: emits (n_rounds, B, K+1),
    counts v (n_rounds, B).
    """
    dtype = jnp.dtype(dtype_name)
    params = cast_decoder_blocks(params, dtype)
    draft_params = cast_decoder_blocks(draft_params, dtype)
    K = draft_k
    idx = jnp.arange(K + 1)[None, :]

    def round_body(carry, _):
        cache, dcache, last_tok, lens, finished = carry

        def draft_step(dc, i):
            dcache, tok = dc
            logits, dcache = decode_step_multipos(
                draft_params, draft_cfg, tok[:, None], dcache,
                lens - 1 + i, dtype=dtype,
            )
            lg = logits[:, 0] + suppress_mask
            lg = jnp.where(
                (lens + i == n_prefix)[:, None], lg + blank_mask, lg
            )
            nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            return (dcache, nxt), nxt

        (dcache, _), drafts = jax.lax.scan(
            draft_step, (dcache, last_tok), jnp.arange(K)
        )
        drafts = drafts.T  # (B, K)

        block = jnp.concatenate([last_tok[:, None], drafts], axis=1)
        logits, cache = decode_step_multipos(
            params, cfg, block, cache, lens - 1, dtype=dtype
        )
        slots = lens[:, None] + idx
        lg = logits + suppress_mask
        lg = jnp.where((slots == n_prefix)[..., None], lg + blank_mask, lg)
        greedy = jnp.argmax(lg, axis=-1).astype(jnp.int32)  # (B, K+1)

        match = greedy[:, :K] == drafts
        a = jnp.cumprod(match.astype(jnp.int32), axis=1).sum(axis=1)
        eot_hit = (greedy == eot) & (idx <= a[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, a + 1)
        budget = max_new - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        emit_w = jnp.where(idx < v[:, None], greedy, eot)
        ate_eot = any_eot & (first_eot < v)
        last_idx = jnp.where(ate_eot, first_eot - 1, v - 1)
        last_emit = jnp.take_along_axis(
            greedy, jnp.maximum(last_idx, 0)[:, None], axis=1
        )[:, 0]
        last_tok = jnp.where(last_idx >= 0, last_emit, last_tok)
        lens = lens + v - jnp.where(ate_eot, 1, 0)
        finished = finished | ate_eot | (lens - n_prefix >= max_new)
        return (cache, dcache, last_tok, lens, finished), (emit_w, v)

    (cache, draft_cache, last_tok, lens, finished), (emits, vs) = (
        jax.lax.scan(
            round_body,
            (cache, draft_cache, last_tok, lens, finished),
            None,
            length=n_rounds,
        )
    )
    return cache, draft_cache, last_tok, lens, finished, emits, vs


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "n_rounds", "draft_k", "n_prefix", "max_new", "dtype_name",
    ),
    donate_argnames=("cache",),
)
def _spec_chunk_medusa(
    params,
    medusa_params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    hidden_frontier,  # (B, d): final-LN hidden of the token at lens-2
    last_tok,  # (B,)
    lens,  # (B,)
    finished,  # (B,) bool
    suppress_mask,
    blank_mask,
    eot: int,
    n_rounds: int,
    draft_k: int,
    n_prefix: int,
    max_new: int,
    dtype_name="float32",
):
    """n_rounds MEDUSA verification rounds, entirely on device.

    The K trained residual heads (models/medusa.py) propose all K
    drafts in ONE shot from each slot's frontier hidden state — no
    draft model, no draft forwards, so a round costs exactly one
    (K+1)-query target forward and the engine's per-round cost is
    acceptance-independent. hidden_frontier is carried across rounds (and across
    chunks via the engine state; joins refresh it through
    _join_step_hidden). Emission contract matches _spec_chunk.
    """
    from .models.medusa import medusa_propose
    from .models.whisper import decode_step_multipos_hidden

    dtype = jnp.dtype(dtype_name)
    params = cast_decoder_blocks(params, dtype)
    K = draft_k
    idx = jnp.arange(K + 1)[None, :]

    def round_body(carry, _):
        cache, hidden_frontier, last_tok, lens, finished = carry
        drafts = medusa_propose(
            medusa_params, params, hidden_frontier, dtype
        )  # (B, K)
        block = jnp.concatenate([last_tok[:, None], drafts], axis=1)
        logits, cache, block_hidden = decode_step_multipos_hidden(
            params, cfg, block, cache, lens - 1, dtype=dtype
        )
        slots = lens[:, None] + idx
        lg = logits + suppress_mask
        lg = jnp.where((slots == n_prefix)[..., None], lg + blank_mask, lg)
        greedy = jnp.argmax(lg, axis=-1).astype(jnp.int32)  # (B, K+1)

        match = greedy[:, :K] == drafts
        a = jnp.cumprod(match.astype(jnp.int32), axis=1).sum(axis=1)
        eot_hit = (greedy == eot) & (idx <= a[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, a + 1)
        budget = max_new - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        emit_w = jnp.where(idx < v[:, None], greedy, eot)
        ate_eot = any_eot & (first_eot < v)
        last_idx = jnp.where(ate_eot, first_eot - 1, v - 1)
        last_emit = jnp.take_along_axis(
            greedy, jnp.maximum(last_idx, 0)[:, None], axis=1
        )[:, 0]
        last_tok = jnp.where(last_idx >= 0, last_emit, last_tok)
        # new lens counts content tokens; the frontier hidden for the
        # NEXT round is the hidden of the input at (new lens)-2, which
        # is block index last_idx (= content v - 1)
        new_hf = jnp.take_along_axis(
            block_hidden, jnp.maximum(last_idx, 0)[:, None, None], axis=1
        )[:, 0]
        hidden_frontier = jnp.where(
            (last_idx >= 0)[:, None], new_hf, hidden_frontier
        )
        lens = lens + v - jnp.where(ate_eot, 1, 0)
        finished = finished | ate_eot | (lens - n_prefix >= max_new)
        return (
            (cache, hidden_frontier, last_tok, lens, finished),
            (emit_w, v),
        )

    (cache, hidden_frontier, last_tok, lens, finished), (emits, vs) = (
        jax.lax.scan(
            round_body,
            (cache, hidden_frontier, last_tok, lens, finished),
            None,
            length=n_rounds,
        )
    )
    return cache, hidden_frontier, last_tok, lens, finished, emits, vs


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "n_rounds", "n_prefix", "max_new", "dtype_name", "tree",
    ),
    donate_argnames=("cache",),
)
def _spec_chunk_medusa_tree(
    params,
    medusa_params,
    cfg: WhisperConfig,
    cache: DecoderCache,
    tokens_buf,  # (B, buf_len): prefix + emitted content, EOT-padded
    hidden_frontier,  # (B, d)
    last_tok,  # (B,)
    lens,  # (B,)
    finished,  # (B,) bool
    suppress_mask,
    blank_mask,
    eot: int,
    n_rounds: int,
    n_prefix: int,
    max_new: int,
    dtype_name="float32",
    tree=None,
):
    """n_rounds TREE-medusa verification rounds, entirely on device.

    The in-flight variant of decode/medusa_tree.py: each round re-feeds
    the last R = K+2 tokens per slot (identical-KV rewrites keep every
    slot's cache valid below lens — the same mechanism joins use), then
    verifies N tree nodes (top-C per head) in the SAME forward and
    accepts along the running greedy token. Per-slot positions ride
    decode_step_block's per-token position vectors. Emission contract
    matches _spec_chunk: emits (n_rounds, B, K+1), counts v
    (n_rounds, B), engine lens counts content tokens (EOT excluded).
    """
    from .decode.medusa_tree import _tree_tables, tree_round

    dtype = jnp.dtype(dtype_name)
    params = cast_decoder_blocks(params, dtype)
    _, _, _, _, _, K = _tree_tables(tree)
    B = tokens_buf.shape[0]
    idxs = jnp.arange(K + 1)[None, :]
    write_row = jax.vmap(
        lambda buf, new, p: jax.lax.dynamic_update_slice_in_dim(
            buf, new, p, axis=0
        )
    )

    def round_body(carry, _):
        (
            cache, tokens_buf, hidden_frontier, last_tok, lens, finished,
        ) = carry

        cache, emit, _, sel, m, hidden = tree_round(
            params, medusa_params, cfg, cache, tokens_buf,
            hidden_frontier, lens, suppress_mask, blank_mask,
            n_prefix, tree, dtype,
        )

        eot_hit = (emit == eot) & (idxs <= m[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, m + 1)
        budget = max_new - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        emit_w = jnp.where(idxs < v[:, None], emit, eot)
        tokens_buf = write_row(tokens_buf, emit_w, lens)
        ate_eot = any_eot & (first_eot < v)
        last_idx = jnp.where(ate_eot, first_eot - 1, v - 1)
        last_emit = jnp.take_along_axis(
            emit, jnp.maximum(last_idx, 0)[:, None], axis=1
        )[:, 0]
        last_tok = jnp.where(last_idx >= 0, last_emit, last_tok)

        # frontier hidden for the NEXT round's drafts: hidden of the
        # input at (new content lens) - 2; sel[:, i] holds the block
        # index whose logits produced emit[i] (the input at position
        # lens-1+i), so the input at new_lens-2 = lens + vc - 2 is
        # sel[:, vc-1]
        vc = jnp.maximum(v - jnp.where(ate_eot, 1, 0), 0)  # content count
        pick = jnp.take_along_axis(
            sel, jnp.maximum(vc - 1, 0)[:, None], axis=1
        )[:, 0]
        new_hf = jnp.take_along_axis(
            hidden, pick[:, None, None], axis=1
        )[:, 0]
        hidden_frontier = jnp.where(
            (vc >= 1)[:, None], new_hf, hidden_frontier
        )

        lens = lens + vc
        finished = finished | ate_eot | (lens - n_prefix >= max_new)
        return (
            (cache, tokens_buf, hidden_frontier, last_tok, lens, finished),
            (emit_w, v),
        )

    (cache, tokens_buf, hidden_frontier, last_tok, lens, finished), (
        emits,
        vs,
    ) = jax.lax.scan(
        round_body,
        (cache, tokens_buf, hidden_frontier, last_tok, lens, finished),
        None,
        length=n_rounds,
    )
    return cache, hidden_frontier, last_tok, lens, finished, emits, vs


@dataclass
class _Slot:
    future: Optional[Future] = None
    tokens: List[int] = field(default_factory=list)  # current window
    window_tokens: List[List[int]] = field(default_factory=list)
    windows: List[np.ndarray] = field(default_factory=list)  # remaining
    truncated: bool = False
    submitted_at: float = 0.0
    started_at: float = 0.0
    first_token_at: float = 0.0  # first token visible on host (TTFT)
    on_token: Optional[Callable[[dict], None]] = None
    deadline: Optional[float] = None  # absolute wall time; None = no limit
    timed_out: bool = False

    def all_tokens(self) -> List[int]:
        out: List[int] = []
        for w in self.window_tokens:
            out.extend(w)
        out.extend(self.tokens)
        return out


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the waiting queue is at max_pending —
    backpressure for upstream load shedding (HTTP layer maps it to 503)."""


class ContinuousBatcher:
    """In-flight batching greedy transcription engine (single 30 s window).

    slots: persistent batch width. max_new_tokens: per-request budget.
    steps_per_sync: decode steps between host syncs (latency knob: a new
    request waits at most one chunk before joining).
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        *,
        slots: int = 8,
        max_new_tokens: int = 128,
        steps_per_sync: int = 4,
        language: str = "en",
        bf16: bool = False,
        kv_int8: bool = False,
        draft_k: int = 0,
        draft_params=None,
        draft_cfg: Optional[WhisperConfig] = None,
        medusa_params=None,
        medusa_tree=None,
        tokenizer: Optional[WhisperTokenizer] = None,
        mesh=None,
        tensor_parallel: bool = False,
        max_pending: Optional[int] = None,
        join_fast_sync: bool = True,
        prewarm: bool = False,
        adaptive_sync: bool = False,
        adaptive_mult: int = 4,
    ):
        """draft_k > 0 turns on in-flight speculation: model-free n-gram
        drafts by default, or a persistent DRAFT MODEL when
        draft_params/draft_cfg are given (it keeps its own slot-aligned
        KV caches and drafts K tokens per verification round — the
        engine's answer to trained-pair speculation).
        medusa_params (models/medusa.py): trained residual heads draft
        in ONE shot from the frontier hidden state — no draft model and
        no extra forwards; draft_k is taken from the head count.
        medusa_tree: a static (parent, cand) tree template
        (decode/medusa_tree.py) — verify top-C candidates per head as a
        TREE in the same forward (higher tokens/round, same exact-greedy
        output).
        mesh: shard the SLOT axis of all persistent device state over the
        mesh 'data' axis (params replicated) — the engine's throughput
        then scales with the chip count, one engine per pod slice, with
        token-identical output (tests/test_serve_continuous.py oracle).
        slots must divide evenly by the data axis.
        tensor_parallel: additionally Megatron-shard the TARGET weights
        over the mesh 'model' axis (serve models too big for one chip);
        the KV caches inherit the 'model' sharding from the projections
        and the slot axis still shards over 'data' — dp x tp composes.
        max_pending: bound on the waiting queue; submit() raises
        EngineOverloaded beyond it (backpressure instead of unbounded
        latency). Per-request deadlines/cancellation: submit(...,
        deadline_sec=...) and Future.cancel().
        join_fast_sync: run a 1-round chunk immediately after a join so
        the joiner's first tokens reach the host after ONE decode round
        instead of a full steps_per_sync chunk (TTFT knob; output is
        token-identical — chunking is host-sync granularity only). Costs
        one extra host sync per join event, and under SUSTAINED
        staggered arrivals (a join in nearly every chunk) the engine
        degrades toward per-round syncs — steady state is only untouched
        while joins are sparse relative to steps_per_sync. The rounds=1
        program is a second static variant: without prewarm, the FIRST
        join pays its compile (a persistent-cache load once warm).
        prewarm: compile (or load from the cache) every chunk-program variant
        in __init__ — both rounds=steps_per_sync and, with
        join_fast_sync, rounds=1 — so no request ever pays a compile.
        Off by default: tests and short-lived engines shouldn't pay
        multi-program compiles up front; the serve CLI turns it on.
        adaptive_sync: when no work is waiting to join (empty queue, no
        continuations, nothing admitted this loop), run a LONG chunk of
        steps_per_sync*adaptive_mult rounds instead — fewer host syncs
        buy throughput when arrivals are sparse. The chunk's on-device
        all-halted early exit keeps drained batches from paying for the
        longer program. Tradeoff: a request arriving mid-long-chunk
        waits up to adaptive_mult times longer to join (TTFT) — off by
        default, a throughput knob for batch-style serving."""
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("draft_params and draft_cfg go together")
        if medusa_params is not None and draft_params is not None:
            raise ValueError("medusa_params excludes a draft model")
        if medusa_tree is not None and medusa_params is None:
            raise ValueError("medusa_tree needs medusa_params")
        if medusa_params is not None:
            draft_k = len(medusa_params["heads"])
            if medusa_tree is not None:
                from .decode.medusa_tree import _tree_tables

                _, _, _, _, _, tree_k = _tree_tables(medusa_tree)
                if tree_k > draft_k:
                    raise ValueError(
                        f"tree depth {tree_k} exceeds {draft_k} heads"
                    )
                draft_k = max(draft_k, tree_k + 2)  # refeed headroom
                self._tree_join_width = None  # set after n_prefix below
        if draft_params is not None and draft_k <= 0:
            raise ValueError("a draft model needs draft_k > 0")
        if draft_cfg is not None and (
            draft_cfg.n_vocab != cfg.n_vocab
            or draft_cfg.multilingual != cfg.multilingual
            or draft_cfg.n_mels != cfg.n_mels
        ):
            raise ValueError(
                "draft and target must share tokenizer and mel size"
            )
        self.mesh = mesh
        if mesh is not None:
            n_data = int(mesh.shape.get("data", 1))
            n_model = int(mesh.shape.get("model", 1))
            if tensor_parallel and n_model <= 1:
                raise ValueError(
                    "tensor_parallel needs a mesh 'model' axis > 1"
                )
            if n_data <= 1 and not tensor_parallel:
                self.mesh = mesh = None
            elif slots % n_data != 0:
                raise ValueError(
                    f"slots={slots} must divide by the mesh data axis "
                    f"({n_data})"
                )
            else:
                from .parallel.mesh import replicate as _replicate
                from .parallel.mesh import shard_params as _shard_params

                if tensor_parallel:
                    # Megatron weight sharding over 'model'; the decode
                    # programs' KV caches inherit the head-axis sharding
                    # from the projections (TP-decode oracle in
                    # tests/test_parallel.py)
                    params = _shard_params(
                        mesh, params, tensor_parallel=True
                    )
                else:
                    params = _replicate(mesh, params)
                if draft_params is not None:
                    draft_params = _replicate(mesh, draft_params)
                if medusa_params is not None:
                    medusa_params = _replicate(mesh, medusa_params)
        self.params = params
        self.cfg = cfg
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.medusa_params = medusa_params
        self.medusa_tree = tuple(medusa_tree) if medusa_tree else None
        self.slots = slots
        self.max_new = max_new_tokens
        self.steps_per_sync = steps_per_sync
        self.adaptive_sync = adaptive_sync
        self.adaptive_rounds = max(steps_per_sync * adaptive_mult,
                                   steps_per_sync + 1)
        self.join_fast_sync = join_fast_sync and steps_per_sync > 1
        self.draft_k = draft_k
        self.dtype_name = "bfloat16" if bf16 else "float32"
        self.kv_int8 = kv_int8
        self.tokenizer = tokenizer or get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language,
        )
        options = DecodingOptions(
            language=language, without_timestamps=True
        )
        self.prefix = initial_tokens(self.tokenizer, options)
        self.n_prefix = len(self.prefix)
        # draft_k > 0 needs K cache/position headroom past the frontier
        # for the (K+1)-wide verification block
        ctx_cap = cfg.n_text_ctx - draft_k
        if draft_cfg is not None:
            ctx_cap = min(ctx_cap, draft_cfg.n_text_ctx - draft_k)
        self.n_ctx = min(self.n_prefix + self.max_new + 1, ctx_cap)
        self.max_new = self.n_ctx - self.n_prefix - 1
        self._cache_len = self.n_ctx + draft_k
        self.suppress = jnp.asarray(
            build_suppress_mask(self.tokenizer, options, cfg.n_vocab)
        )
        self.blank = jnp.asarray(
            build_blank_mask(self.tokenizer, cfg.n_vocab)
        )
        self.eot = self.tokenizer.eot

        # persistent device state: an all-empty batch
        dummy = jnp.zeros(
            (slots, cfg.n_audio_ctx, cfg.n_audio_state),
            jnp.dtype(self.dtype_name),
        )
        self.cache = init_cache(
            params, cfg, dummy, max_len=self._cache_len,
            dtype=jnp.dtype(self.dtype_name), cross_kv_int8=kv_int8,
        )
        self.draft_cache = None
        if draft_params is not None:
            ddummy = jnp.zeros(
                (slots, draft_cfg.n_audio_ctx, draft_cfg.n_audio_state),
                jnp.dtype(self.dtype_name),
            )
            self.draft_cache = init_cache(
                draft_params, draft_cfg, ddummy, max_len=self._cache_len,
                dtype=jnp.dtype(self.dtype_name), cross_kv_int8=kv_int8,
            )
        self.last_tok = jnp.full((slots,), self.eot, jnp.int32)
        self.lens = jnp.full((slots,), self.n_prefix, jnp.int32)
        self.finished = jnp.ones((slots,), bool)
        self.hidden_frontier = None
        if medusa_params is not None:
            self.hidden_frontier = jnp.zeros(
                (slots, cfg.n_text_state), jnp.dtype(self.dtype_name)
            )
        if self.medusa_tree is not None:
            from .decode.medusa_tree import _tree_tables

            _, _, _, _, _, tree_k = _tree_tables(self.medusa_tree)
            self._tree_join_width = max(self.n_prefix, tree_k + 2)
        if mesh is not None and int(mesh.shape.get("data", 1)) > 1:
            # shard every persistent buffer's SLOT axis over 'data': the
            # cache batch axis is 1 ((L, B, ...) — models/whisper.py
            # DecoderCache), the per-slot vectors' is 0. All engine
            # programs are slot-parallel, so GSPMD splits them cleanly.
            # Under tensor_parallel the cache leaves already carry a
            # 'model' sharding (propagated from the TP projections) —
            # EXTEND that spec rather than clobber it, so dp x tp holds.
            from jax.sharding import NamedSharding, PartitionSpec as _P

            def _slot_sharded(x, axis):
                if x is None:
                    return None
                spec = [None] * x.ndim
                sh = getattr(x, "sharding", None)
                if isinstance(sh, NamedSharding):
                    prior = list(sh.spec) + [None] * (x.ndim - len(sh.spec))
                    spec = prior[: x.ndim]
                spec[axis] = "data"
                return jax.device_put(x, NamedSharding(mesh, _P(*spec)))

            self.cache = jax.tree.map(
                lambda x: _slot_sharded(x, 1), self.cache
            )
            if self.draft_cache is not None:
                self.draft_cache = jax.tree.map(
                    lambda x: _slot_sharded(x, 1), self.draft_cache
                )
            self.last_tok = _slot_sharded(self.last_tok, 0)
            self.lens = _slot_sharded(self.lens, 0)
            self.finished = _slot_sharded(self.finished, 0)
            if self.hidden_frontier is not None:
                self.hidden_frontier = _slot_sharded(self.hidden_frontier, 0)
        self._prefix_row = np.asarray(self.prefix, np.int32)

        self._slots: List[Optional[_Slot]] = [None] * slots
        self._queue: "queue.Queue" = queue.Queue()  # (slot, audio) pairs
        self.max_pending = max_pending
        # finished-window requests waiting to rejoin for their next window
        self._continuations: List[tuple] = []
        self._stop = threading.Event()
        self._stats = {
            "requests": 0, "joins": 0, "chunks": 0, "fast_chunks": 0,
            "long_chunks": 0, "spec_rounds": 0, "spec_emitted": 0,
            "rejected": 0, "cancelled": 0, "timed_out": 0,
        }
        if prewarm:
            self._prewarm()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------

    def submit(
        self,
        audio,
        on_token: Optional[Callable[[dict], None]] = None,
        on_partial: Optional[Callable[[dict], None]] = None,
        deadline_sec: Optional[float] = None,
    ) -> Future:
        """Submit one utterance (path or waveform, first 30 s window).

        on_token: called from the engine thread with
        {"token", "text_so_far"} per decoded token (token streaming).
        on_partial is an alias accepted for interface parity with
        serve.TranscriptionService (the HTTP stream handler uses it).

        deadline_sec: wall-clock budget from NOW; a request past its
        deadline resolves at the next engine sync with whatever it has
        decoded so far (``timed_out: True`` in the result). Calling
        ``.cancel()`` on the returned Future drops the request (queued
        ones never run; in-flight ones stop at the next sync).
        Raises EngineOverloaded when max_pending requests are waiting.
        """
        if (
            self.max_pending is not None
            and self._queue.qsize() >= self.max_pending
        ):
            self._stats["rejected"] += 1
            raise EngineOverloaded(
                f"{self._queue.qsize()} requests already waiting "
                f"(max_pending={self.max_pending})"
            )
        on_token = on_token or on_partial
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        windows = [
            pad_or_trim(audio[s : s + N_SAMPLES])
            for s in range(0, max(len(audio), 1), N_SAMPLES)
        ]
        fut: Future = Future()
        slot = _Slot(
            future=fut,
            windows=windows[1:],
            submitted_at=time.time(),
            on_token=on_token,
            deadline=(
                time.time() + deadline_sec
                if deadline_sec is not None
                else None
            ),
        )
        self._queue.put((slot, windows[0]))
        self._stats["requests"] += 1
        return fut

    def transcribe(self, audio, timeout: Optional[float] = None) -> dict:
        return self.submit(audio).result(timeout=timeout)

    def stats(self) -> dict:
        d = dict(self._stats)
        d["pending"] = self._queue.qsize()
        d["active_slots"] = sum(s is not None for s in self._slots)
        return d

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)

    # -- engine -----------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def _admit(self) -> bool:
        """Join queued requests into free slots. Returns True if any.

        Window continuations (long audio) are admitted before new
        requests so an in-progress utterance never starves behind
        fresh arrivals.
        """
        free = self._free_slots()
        joiners = []
        while free and (self._continuations or not self._queue.empty()):
            if self._continuations:
                slot_state, audio = self._continuations.pop(0)
            else:
                try:
                    slot_state, audio = self._queue.get_nowait()
                except queue.Empty:
                    break
            # cancelled / already-expired requests never pay the encode
            if slot_state.future.cancelled():
                self._stats["cancelled"] += 1
                continue
            if (
                slot_state.deadline is not None
                and time.time() > slot_state.deadline
            ):
                slot_state.timed_out = True
                self._stats["timed_out"] += 1
                self._resolve(slot_state)
                continue
            i = free.pop(0)
            mel = log_mel_spectrogram(audio, n_mels=self.cfg.n_mels)
            feats = _encode_one(
                self.params, self.cfg, jnp.asarray(mel)[None],
                dtype_name=self.dtype_name,
            )
            one = _cross_kv_one(
                self.params, self.cfg, feats,
                dtype_name=self.dtype_name, cross_kv_int8=self.kv_int8,
            )
            self.cache = _scatter_slot(self.cache, one, i)
            if self.draft_params is not None:
                dfeats = _encode_one(
                    self.draft_params, self.draft_cfg,
                    jnp.asarray(mel)[None], dtype_name=self.dtype_name,
                )
                done_ = _cross_kv_one(
                    self.draft_params, self.draft_cfg, dfeats,
                    dtype_name=self.dtype_name,
                    cross_kv_int8=self.kv_int8,
                )
                self.draft_cache = _scatter_slot(
                    self.draft_cache, done_, i
                )
            if not slot_state.started_at:
                slot_state.started_at = time.time()
            self._slots[i] = slot_state
            joiners.append(i)

        if not joiners:
            return False
        # one batched prefix pass: joiners consume the SOT prefix at pos 0,
        # every other slot re-feeds its latest n_prefix tokens in place
        B, P = self.slots, self.n_prefix
        lens_np = np.asarray(self.lens)
        tok_rows = np.tile(self._prefix_row, (B, 1))
        pos = np.maximum(lens_np - P, 0).astype(np.int32)
        # active slots re-feed: their last P tokens (prefix tail + emitted)
        for b in range(B):
            if b in joiners:
                pos[b] = 0
                continue
            hist = list(self.prefix) + (
                self._slots[b].tokens if self._slots[b] else []
            )
            tail = hist[pos[b] : pos[b] + P]
            tok_rows[b, : len(tail)] = tail
        if self.medusa_params is not None and self.medusa_tree is not None:
            # tree rounds leave up to K+1 accepted tokens with unwritten
            # KV (nodes are read-only), so the tree-mode join re-feeds
            # W = max(P, K+2) tokens with garbage masking — see
            # _join_step_tree
            W = self._tree_join_width
            rows = np.full((B, W), self.eot, np.int32)
            starts = np.zeros(B, np.int32)
            lens_eff = np.zeros(B, np.int32)
            for b in range(B):
                hist = list(self.prefix) + (
                    self._slots[b].tokens if self._slots[b] else []
                )
                lens_eff[b] = len(hist)
                starts[b] = max(len(hist) - W, 0)
                seg = hist[starts[b] : starts[b] + W]
                rows[b, : len(seg)] = seg
            self.cache, self.hidden_frontier = _join_step_tree(
                self.params, self.cfg, self.cache,
                jnp.asarray(rows), jnp.asarray(starts),
                jnp.asarray(lens_eff), dtype_name=self.dtype_name,
            )
        elif self.medusa_params is not None:
            # every row's frontier hidden sits at block index P-2 (see
            # _join_step_hidden): joiners by construction, re-feeders
            # because chain rounds write every accepted token's KV, so
            # the recomputed hidden of an already-cached token is
            # identical (deterministic forward)
            self.cache, self.hidden_frontier = _join_step_hidden(
                self.params, self.cfg, self.cache,
                jnp.asarray(tok_rows), jnp.asarray(pos),
                dtype_name=self.dtype_name,
            )
        else:
            self.cache = _join_step(
                self.params, self.cfg, self.cache,
                jnp.asarray(tok_rows), jnp.asarray(pos),
                dtype_name=self.dtype_name,
            )
        if self.draft_params is not None:
            # the draft consumes the same prefix so its self-KV tracks
            # the target's slot state from position 0
            self.draft_cache = _join_step(
                self.draft_params, self.draft_cfg, self.draft_cache,
                jnp.asarray(tok_rows), jnp.asarray(pos),
                dtype_name=self.dtype_name,
            )
        join_mask = np.zeros(B, bool)
        join_mask[joiners] = True
        self.last_tok = jnp.where(
            jnp.asarray(join_mask),
            jnp.int32(self.prefix[-1]),
            self.last_tok,
        )
        self.lens = jnp.where(
            jnp.asarray(join_mask), jnp.int32(P), self.lens
        )
        self.finished = jnp.where(
            jnp.asarray(join_mask), False, self.finished
        )
        self._stats["joins"] += len(joiners)
        return True

    def _resolve(self, s: _Slot):
        """Resolve a request's Future with its final transcript."""
        if s.future.done():  # cancelled under our feet
            return
        tokens = s.all_tokens()
        text = self.tokenizer.decode_text(tokens).strip()
        try:
            s.future.set_result(
                {
                    "text": text,
                    "tokens": tokens,
                    "n_windows": len(s.window_tokens),
                    "latency_sec": time.time() - s.submitted_at,
                    "queue_sec": (
                        (s.started_at - s.submitted_at)
                        if s.started_at
                        else None  # expired while still queued
                    ),
                    "ttft_sec": (
                        (s.first_token_at - s.submitted_at)
                        if s.first_token_at
                        else None  # produced no tokens (immediate EOT)
                    ),
                    "truncated": s.truncated,
                    "timed_out": s.timed_out,
                }
            )
        except Exception:
            pass  # a cancel() racing set_result

    def _retire(self, i: int, budget_hit: bool):
        """Finish the current window; chain the next or resolve."""
        s = self._slots[i]
        if s is None:
            return
        s.truncated = s.truncated or budget_hit
        s.window_tokens.append(list(s.tokens))
        s.tokens = []
        self._slots[i] = None
        if s.windows:
            # long audio: requeue this request for its next 30 s window
            # (the slot is freed — another request may use it meanwhile)
            self._continuations.append((s, s.windows.pop(0)))
            return
        self._resolve(s)

    def _halt_device_slot(self, i: int):
        """Mark slot i finished ON DEVICE so forced retires stop burning
        decode steps on a dead request (joins reset the flag later)."""
        onehot = np.zeros(self.slots, bool)
        onehot[i] = True
        self.finished = jnp.logical_or(self.finished, jnp.asarray(onehot))

    def _force_retire(self, i: int, cancelled: bool):
        """Drop an in-flight request NOW (client cancel or deadline)."""
        s = self._slots[i]
        if s is None:
            return
        self._slots[i] = None
        self._halt_device_slot(i)
        if cancelled:
            self._stats["cancelled"] += 1
            return  # the Future is already in its CANCELLED state
        s.timed_out = True
        self._stats["timed_out"] += 1
        s.window_tokens.append(list(s.tokens))
        s.tokens = []
        self._resolve(s)  # partial transcript, timed_out flag set

    def _reap(self):
        """Apply client cancels and deadlines to in-flight slots and to
        requests still waiting between windows (continuations)."""
        now = time.time()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.future.cancelled():
                self._force_retire(i, cancelled=True)
            elif s.deadline is not None and now > s.deadline:
                self._force_retire(i, cancelled=False)
        if self._continuations:
            keep = []
            for s, audio in self._continuations:
                if s.future.cancelled():
                    self._stats["cancelled"] += 1
                elif s.deadline is not None and now > s.deadline:
                    s.timed_out = True
                    self._stats["timed_out"] += 1
                    self._resolve(s)
                else:
                    keep.append((s, audio))
            self._continuations = keep
        # the WAITING queue too: with every slot busy _admit never pops
        # it, so without this sweep a queued request with a deadline (or
        # a cancelled one) would block its client until a slot frees —
        # the unbounded latency deadlines exist to prevent — and dead
        # entries would keep counting toward max_pending
        if not self._queue.empty():
            keep_q = []
            while True:
                try:
                    s, audio = self._queue.get_nowait()
                except queue.Empty:
                    break
                if s.future.cancelled():
                    self._stats["cancelled"] += 1
                elif s.deadline is not None and now > s.deadline:
                    s.timed_out = True
                    self._stats["timed_out"] += 1
                    self._resolve(s)
                else:
                    keep_q.append((s, audio))
            for item in keep_q:  # FIFO order preserved for the survivors
                self._queue.put(item)

    def _prewarm(self):
        """Compile (or load from the cache) every chunk-program variant before
        serving: the rounds=steps_per_sync steady-state program and, when
        join_fast_sync is on, the rounds=1 variant — otherwise the FIRST
        join pays a full compile at the worst possible moment (TTFT).
        All slots start finished=True, so each call is a device no-op:
        lens freeze, token buffers emit -1, and the engine state it
        returns is value-identical. Runs in __init__ (single-threaded);
        stats are reset afterwards so the warmup chunks don't count."""
        variants = [self.steps_per_sync]
        if self.join_fast_sync and 1 not in variants:
            variants.append(1)
        if self.adaptive_sync and self.adaptive_rounds not in variants:
            variants.append(self.adaptive_rounds)
        for rounds in variants:
            if self.draft_k > 0:
                self._spec_round([], rounds)
            else:
                (
                    self.cache,
                    self.last_tok,
                    self.lens,
                    self.finished,
                    _,
                ) = _decode_chunk(
                    self.params,
                    self.cfg,
                    self.cache,
                    self.last_tok,
                    self.lens,
                    self.finished,
                    self.suppress,
                    self.blank,
                    self.eot,
                    rounds,
                    self.n_prefix,
                    self.max_new,
                    dtype_name=self.dtype_name,
                )
        for k in ("chunks", "fast_chunks", "long_chunks", "spec_rounds",
                  "spec_emitted"):
            self._stats[k] = 0

    def _spec_round(self, active: List[int], rounds: int):
        """One speculative chunk (draft_k > 0): steps_per_sync
        verification rounds run fully on device (_spec_chunk for n-gram
        drafts, _spec_chunk_model for a persistent draft model), then
        one host sync unpacks the per-round emissions — token-identical
        to the plain greedy engine, 1..K+1 tokens per round per slot."""
        K = self.draft_k
        B = self.slots
        if self.medusa_params is not None and self.medusa_tree is not None:
            buf_len = self._cache_len
            tokens_buf = np.full((B, buf_len), self.eot, np.int32)
            for b in range(B):
                hist = list(self.prefix) + (
                    self._slots[b].tokens if self._slots[b] else []
                )
                tokens_buf[b, : len(hist)] = hist[:buf_len]
            (
                self.cache,
                self.hidden_frontier,
                self.last_tok,
                self.lens,
                self.finished,
                emits,
                vs,
            ) = _spec_chunk_medusa_tree(
                self.params,
                self.medusa_params,
                self.cfg,
                self.cache,
                jnp.asarray(tokens_buf),
                self.hidden_frontier,
                self.last_tok,
                self.lens,
                self.finished,
                self.suppress,
                self.blank,
                self.eot,
                rounds,
                self.n_prefix,
                self.max_new,
                dtype_name=self.dtype_name,
                tree=self.medusa_tree,
            )
        elif self.medusa_params is not None:
            (
                self.cache,
                self.hidden_frontier,
                self.last_tok,
                self.lens,
                self.finished,
                emits,
                vs,
            ) = _spec_chunk_medusa(
                self.params,
                self.medusa_params,
                self.cfg,
                self.cache,
                self.hidden_frontier,
                self.last_tok,
                self.lens,
                self.finished,
                self.suppress,
                self.blank,
                self.eot,
                rounds,
                K,
                self.n_prefix,
                self.max_new,
                dtype_name=self.dtype_name,
            )
        elif self.draft_params is not None:
            (
                self.cache,
                self.draft_cache,
                self.last_tok,
                self.lens,
                self.finished,
                emits,
                vs,
            ) = _spec_chunk_model(
                self.params,
                self.draft_params,
                self.cfg,
                self.draft_cfg,
                self.cache,
                self.draft_cache,
                self.last_tok,
                self.lens,
                self.finished,
                self.suppress,
                self.blank,
                self.eot,
                rounds,
                K,
                self.n_prefix,
                self.max_new,
                dtype_name=self.dtype_name,
            )
        else:
            buf_len = self._cache_len
            tokens_buf = np.full((B, buf_len), self.eot, np.int32)
            for b in range(B):
                hist = list(self.prefix) + (
                    self._slots[b].tokens if self._slots[b] else []
                )
                tokens_buf[b, : len(hist)] = hist[:buf_len]
            (
                self.cache,
                self.last_tok,
                self.lens,
                self.finished,
                emits,
                vs,
            ) = _spec_chunk(
                self.params,
                self.cfg,
                self.cache,
                jnp.asarray(tokens_buf),
                self.last_tok,
                self.lens,
                self.finished,
                self.suppress,
                self.blank,
                self.eot,
                rounds,
                K,
                self.n_prefix,
                self.max_new,
                dtype_name=self.dtype_name,
            )
        emits_np = np.asarray(emits)  # (R, B, K+1) — the host sync
        vs_np = np.asarray(vs)  # (R, B)
        self._stats["chunks"] += 1
        self._stats["spec_rounds"] += vs_np.shape[0]
        for b in active:
            s = self._slots[b]
            done = False
            for r in range(vs_np.shape[0]):
                for j in range(int(vs_np[r, b])):
                    t = int(emits_np[r, b, j])
                    if t == self.eot:
                        done = True
                        break
                    s.tokens.append(t)
                    if not s.first_token_at:
                        s.first_token_at = time.time()
                    self._stats["spec_emitted"] += 1
                    if s.on_token is not None:
                        try:
                            s.on_token(
                                {
                                    "token": t,
                                    "window": len(s.window_tokens),
                                    "text_so_far": self.tokenizer
                                    .decode_text(s.all_tokens()),
                                }
                            )
                        except Exception:
                            pass
                if done:
                    break
            budget_hit = len(s.tokens) >= self.max_new
            if done or budget_hit:
                self._retire(b, budget_hit and not done)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._loop_once()
            except Exception as e:
                # fail every pending request loudly instead of leaving
                # futures hanging on a dead engine thread
                for i, s in enumerate(self._slots):
                    if s is not None and not s.future.done():
                        s.future.set_exception(e)
                    self._slots[i] = None
                while True:
                    try:
                        slot_state, _ = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if not slot_state.future.done():
                        slot_state.future.set_exception(e)
                for slot_state, _ in self._continuations:
                    if not slot_state.future.done():
                        slot_state.future.set_exception(e)
                self._continuations.clear()
                raise

    def _loop_once(self):
        self._reap()
        admitted = self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            if not admitted:
                time.sleep(0.002)
            return

        # TTFT fast path: a slot just joined, so sync after ONE round —
        # its first tokens reach the client a full chunk earlier
        rounds = self.steps_per_sync
        if self.join_fast_sync and admitted:
            rounds = 1
            self._stats["fast_chunks"] += 1
        elif (
            self.adaptive_sync
            and self._queue.empty()
            and not self._continuations
        ):
            # nothing waiting to join: take a long chunk to amortize the
            # host sync; the on-device
            # early exit stops it as soon as every slot drains
            rounds = self.adaptive_rounds
            self._stats["long_chunks"] += 1

        if self.draft_k > 0:
            self._spec_round(active, rounds)
            return

        (
            self.cache,
            self.last_tok,
            self.lens,
            self.finished,
            toks,
        ) = _decode_chunk(
            self.params,
            self.cfg,
            self.cache,
            self.last_tok,
            self.lens,
            self.finished,
            self.suppress,
            self.blank,
            self.eot,
            rounds,
            self.n_prefix,
            self.max_new,
            dtype_name=self.dtype_name,
        )
        toks_np = np.asarray(toks)  # (n_steps, B) — the host sync
        self._stats["chunks"] += 1
        lens_np = np.asarray(self.lens)
        for b in active:
            s = self._slots[b]
            done = False
            for t in toks_np[:, b].tolist():
                if t == self.eot:
                    done = True
                    break
                if t < 0:  # halted on device (budget frozen)
                    break
                s.tokens.append(int(t))
                if not s.first_token_at:
                    s.first_token_at = time.time()
                if s.on_token is not None:
                    try:
                        s.on_token(
                            {
                                "token": int(t),
                                "window": len(s.window_tokens),
                                "text_so_far": self.tokenizer
                                .decode_text(s.all_tokens()),
                            }
                        )
                    except Exception:
                        pass
            budget_hit = lens_np[b] - self.n_prefix >= self.max_new
            if done or budget_hit:
                self._retire(b, budget_hit and not done)

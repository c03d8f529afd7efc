"""Speculative decoding: a draft model proposes, the target model verifies.

A small draft model (e.g. whisper-tiny) autoregressively proposes K tokens;
the target model (e.g. whisper-small / large-v3) scores them all in ONE
KV-cached forward of S=K+1 queries, and the longest prefix of draft tokens
that matches the target's greedy choices is accepted — plus one token from
the target itself (the correction at the first mismatch, or a bonus token
when everything matched). At temperature 0 the emitted sequence is
IDENTICAL to the target model's own greedy decode: the draft changes only
how many target forwards are needed, never the output. Each verification
round therefore emits between 1 and K+1 tokens per element.

Design:
- the whole propose/verify/accept loop is a single ``lax.while_loop``
  program with fixed shapes (K draft steps + one (K+1)-query target step
  per round) — no host round-trips, no dynamic shapes;
- each batch element accepts a different number of tokens per round, so
  lengths, causal masks, positional embeddings, and KV-cache writes are
  per-element (``models.whisper.decode_step_multipos``);
- stale KV entries written for rejected draft tokens are never visible:
  the causal mask hides cache indices beyond each element's frontier, and
  round n+1 re-feeds the last emitted token so every stale slot is
  overwritten before the frontier reaches it.

The reference has no speculative decoding (it decodes token-by-token
through mlx_whisper, reference scripts/evaluate_model.py:200); this is a
beyond-reference serving optimization. The algorithm is
the greedy specialization of Leviathan et al. 2023 (arXiv:2211.17192).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from ..models.whisper import (
    cast_decoder_blocks,
    decode_step,
    decode_step_multipos,
    encode,
    init_cache,
)
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import (
    DecodingOptions,
    DecodingResult,
    build_blank_mask,
    build_suppress_mask,
    compression_ratio,
    detect_language,
    initial_tokens,
)


@dataclass
class SpeculativeStats:
    """Accept-rate accounting for one speculative_decode call."""

    rounds: int
    emitted_tokens: int  # across the batch, excluding post-finish padding
    draft_k: int
    batch: int = 1

    @property
    def tokens_per_round(self) -> float:
        """Mean tokens emitted per element per verification round
        (1.0 = nothing accepted; draft_k + 1 = everything accepted)."""
        return self.emitted_tokens / max(self.rounds * self.batch, 1)


def _ngram_drafts(tokens_buf, lens, K: int):
    """Model-free drafts: continue the latest previous occurrence of the
    current TRIGRAM, falling back to the bigram (prompt-lookup decoding
    with longest-suffix-first backoff).

    A trigram match pins the continuation to a more specific context,
    so when one exists its continuation is accepted more often; the
    bigram keeps the original recall. Falls back to repeating the last
    token when neither n-gram has occurred before — verification still
    guarantees exact greedy output either way.
    """
    B, L = tokens_buf.shape
    idx = jnp.arange(L)
    last1 = jnp.take_along_axis(
        tokens_buf, jnp.maximum(lens - 1, 0)[:, None], axis=1
    )  # (B, 1)
    last2 = jnp.take_along_axis(
        tokens_buf, jnp.maximum(lens - 2, 0)[:, None], axis=1
    )
    last3 = jnp.take_along_axis(
        tokens_buf, jnp.maximum(lens - 3, 0)[:, None], axis=1
    )

    match2 = (tokens_buf[:, :-1] == last2) & (tokens_buf[:, 1:] == last1)
    valid2 = idx[None, :-1] + 1 < (lens - 1)[:, None]
    score2 = jnp.where(match2 & valid2, idx[None, :-1], -1)
    j2 = jnp.max(score2, axis=1)  # (B,), -1 = no earlier occurrence

    # trigram: buf[j..j+2] == (last3, last2, last1), continuation j+3;
    # only meaningful when a full trigram of history exists (lens >= 3
    # past the prefix start is guaranteed by the SOT prefix length)
    match3 = (
        (tokens_buf[:, :-2] == last3)
        & (tokens_buf[:, 1:-1] == last2)
        & (tokens_buf[:, 2:] == last1)
    )
    valid3 = idx[None, :-2] + 2 < (lens - 1)[:, None]
    score3 = jnp.where(match3 & valid3, idx[None, :-2], -1)
    j3 = jnp.max(score3, axis=1)

    use3 = j3 >= 0
    found = use3 | (j2 >= 0)
    starts = jnp.where(use3, j3 + 3, jnp.where(j2 >= 0, j2 + 2, 0))
    gather_idx = jnp.minimum(
        starts[:, None] + jnp.arange(K)[None, :], L - 1
    )
    drafts = jnp.take_along_axis(tokens_buf, gather_idx, axis=1)
    return jnp.where(found[:, None], drafts, last1)  # (B, K)


@partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "draft_cfg",
        "n_prefix",
        "sample_len",
        "draft_k",
        "dtype_name",
        "sot_index",
        "cross_kv_int8",
        "cross_kv_int4",
        "ngram",
        "medusa",
    ),
)
def _spec_decode_jit(
    params,
    draft_params,
    cfg: WhisperConfig,
    draft_cfg: WhisperConfig,
    audio_features,
    draft_features,
    prefix_tokens,  # (B, n_prefix) int32
    suppress_mask,  # (n_vocab,) float32
    blank_mask,  # (n_vocab,) float32
    eot: int,
    n_prefix: int,
    sample_len: int,
    draft_k: int,
    dtype_name: str = "float32",
    sot_index: int = 0,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
    ngram: bool = False,
    medusa: bool = False,
    medusa_params=None,
):
    """Batched speculative greedy decode under one lax.while_loop."""
    dtype = jnp.dtype(dtype_name)
    # hoist the per-(layer, step) weight converts out of the loop
    params = cast_decoder_blocks(params, dtype)
    if draft_params is not None:
        draft_params = cast_decoder_blocks(draft_params, dtype)
    K = draft_k
    B = audio_features.shape[0]
    buf_len = n_prefix + sample_len + K + 1

    tcache = init_cache(
        params, cfg, audio_features, max_len=buf_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8, cross_kv_int4=cross_kv_int4,
    )
    if ngram or medusa:
        dcache = None
    else:
        dcache = init_cache(
            draft_params, draft_cfg, draft_features, max_len=buf_len,
            dtype=dtype,
        )

    # consume the prefix in one step (both models)
    if medusa:
        from ..models.whisper import decode_step_multipos_hidden

        B0 = prefix_tokens.shape[0]
        prefix_logits, tcache, prefix_hidden = decode_step_multipos_hidden(
            params, cfg, prefix_tokens, tcache,
            jnp.zeros((B0,), jnp.int32), dtype=dtype,
        )
        # head k conditions on h_t to predict token t+k+2; the first
        # round drafts slots n_prefix.. so it needs h at n_prefix-2
        hidden0 = prefix_hidden[:, n_prefix - 2]
    else:
        prefix_logits, tcache = decode_step(
            params, cfg, prefix_tokens, tcache, 0, dtype=dtype
        )
        hidden0 = jnp.zeros(
            (prefix_tokens.shape[0], cfg.n_text_state), dtype
        )
    if not (ngram or medusa):
        _, dcache = decode_step(
            draft_params, draft_cfg, prefix_tokens, dcache, 0, dtype=dtype
        )
    sot_logits = prefix_logits[:, sot_index]

    tokens_buf = jnp.full((B, buf_len), eot, dtype=jnp.int32)
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf, prefix_tokens.astype(jnp.int32), (0, 0)
    )

    idx = jnp.arange(K + 1)[None, :]  # (1, K+1)
    write_row = jax.vmap(
        lambda buf, new, p: jax.lax.dynamic_update_slice_in_dim(
            buf, new, p, axis=0
        )
    )

    def body(state):
        (
            rounds,
            lens,
            last_tok,
            tokens_buf,
            finished,
            sum_logprobs,
            tcache,
            dcache,
            emitted_total,
            hidden_frontier,
        ) = state

        # -- draft: propose K tokens -------------------------------------
        if medusa:
            from ..models.medusa import medusa_propose

            drafts = medusa_propose(
                medusa_params, params, hidden_frontier, dtype
            )  # (B, K) one-shot from the frontier hidden state
        elif ngram:
            drafts = _ngram_drafts(tokens_buf, lens, K)  # (B, K)
        else:

            def draft_body(carry, _):
                tok, pos, dc = carry  # tok (B,), pos (B,) = tok's position
                logits, dc = decode_step_multipos(
                    draft_params, draft_cfg, tok[:, None], dc, pos,
                    dtype=dtype,
                )
                lg = logits[:, 0] + suppress_mask
                # the token being predicted sits at slot pos+1
                lg = jnp.where(
                    (pos + 1 == n_prefix)[:, None], lg + blank_mask, lg
                )
                nxt = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                return (nxt, pos + 1, dc), nxt

            # K+1 steps: the first K produce d_1..d_K; the extra step only
            # ingests d_K so its KV is in the draft cache when the next
            # round starts past it (full acceptance advances the frontier
            # to len+K+1)
            (_, _, dcache), drafts = jax.lax.scan(
                draft_body, (last_tok, lens - 1, dcache), None, length=K + 1
            )
            drafts = drafts[:K].T  # (B, K)

        # -- target: verify all K drafts in one (K+1)-query forward -------
        block = jnp.concatenate([last_tok[:, None], drafts], axis=1)
        if medusa:
            from ..models.whisper import decode_step_multipos_hidden

            tlogits, tcache, block_hidden = decode_step_multipos_hidden(
                params, cfg, block, tcache, lens - 1, dtype=dtype
            )
        else:
            tlogits, tcache = decode_step_multipos(
                params, cfg, block, tcache, lens - 1, dtype=dtype
            )
            block_hidden = None
        # tlogits[:, i] predicts the token at slot lens+i
        slots = lens[:, None] + idx  # (B, K+1)
        lg = tlogits + suppress_mask
        lg = jnp.where((slots == n_prefix)[..., None], lg + blank_mask, lg)
        greedy_tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)  # (B, K+1)
        logprobs = jax.nn.log_softmax(lg, axis=-1)

        # accepted prefix length a in [0, K]; emit[i] for i <= a is exactly
        # greedy_tok[i] (accepted drafts equal the greedy choice by
        # construction; slot a is the correction/bonus)
        match = greedy_tok[:, :K] == drafts  # (B, K)
        a = jnp.cumprod(match.astype(jnp.int32), axis=1).sum(axis=1)  # (B,)
        emit = greedy_tok

        # stop at the first emitted EOT; cap by the sample_len budget
        eot_hit = (emit == eot) & (idx <= a[:, None])
        any_eot = eot_hit.any(axis=1)
        first_eot = jnp.argmax(eot_hit, axis=1)
        v = jnp.where(any_eot, first_eot + 1, a + 1)
        budget = sample_len - (lens - n_prefix)
        v = jnp.minimum(v, budget)
        v = jnp.where(finished, 0, v)

        lp_emit = jnp.take_along_axis(logprobs, emit[..., None], axis=-1)[
            ..., 0
        ]
        sum_logprobs = sum_logprobs + jnp.where(
            idx < v[:, None], lp_emit, 0.0
        ).sum(axis=1)

        emit_w = jnp.where(idx < v[:, None], emit, eot)
        tokens_buf = write_row(tokens_buf, emit_w, lens)

        last_emit = jnp.take_along_axis(
            emit, jnp.maximum(v - 1, 0)[:, None], axis=1
        )[:, 0]
        last_tok = jnp.where(v >= 1, last_emit, last_tok)

        emit_has_eot = any_eot & (first_eot < v)
        lens = lens + v
        finished = (
            finished | emit_has_eot | (lens - n_prefix >= sample_len)
        )
        emitted_total = emitted_total + v.sum()

        if medusa:
            # next round's heads condition on the hidden of the input at
            # index (new lens)-2 = block position v-1 (v>=1 whenever the
            # element is active)
            new_hf = jnp.take_along_axis(
                block_hidden,
                jnp.maximum(v - 1, 0)[:, None, None],
                axis=1,
            )[:, 0]
            hidden_frontier = jnp.where(
                (v >= 1)[:, None], new_hf, hidden_frontier
            )

        return (
            rounds + 1,
            lens,
            last_tok,
            tokens_buf,
            finished,
            sum_logprobs,
            tcache,
            dcache,
            emitted_total,
            hidden_frontier,
        )

    def cond(state):
        rounds, finished = state[0], state[4]
        return (rounds < sample_len) & ~jnp.all(finished)

    state = (
        jnp.array(0, jnp.int32),
        jnp.full((B,), n_prefix, jnp.int32),
        prefix_tokens[:, -1].astype(jnp.int32),
        tokens_buf,
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.float32),
        tcache,
        dcache,
        jnp.array(0, jnp.int32),
        hidden0,
    )
    out = jax.lax.while_loop(cond, body, state)
    rounds, tokens_buf, sum_logprobs, emitted_total = (
        out[0],
        out[3],
        out[5],
        out[8],
    )
    return tokens_buf, sum_logprobs, sot_logits, rounds, emitted_total


def speculative_decode(
    params,
    cfg: WhisperConfig,
    draft_params,
    draft_cfg: Optional[WhisperConfig],
    mel,
    options: DecodingOptions = DecodingOptions(),
    draft_k: int = 4,
    draft_mel=None,
    tokenizer: Optional[WhisperTokenizer] = None,
    return_stats: bool = False,
    medusa_params=None,
) -> List[DecodingResult]:
    """Greedy decode `mel` with `params`, accelerated by speculation.

    The output tokens are exactly what ``decode(params, cfg, mel, options)``
    would produce at temperature 0 (the draft only affects speed). Two
    draft sources:

    - a draft MODEL (``draft_params``/``draft_cfg``, e.g. whisper-tiny):
      K autoregressive draft steps per round. ``mel``: (B, 3000, n_mels)
      for the target; ``draft_mel`` defaults to ``mel`` and must be
      supplied when the models use different mel sizes (tiny-80 drafting
      large-v3-128).
    - ``draft_params=None``: model-free n-gram lookup (prompt-lookup
      decoding) — drafts continue the latest previous occurrence of the
      current bigram in the generated tokens. Zero draft cost; pays off
      on repetitive output.
    - ``medusa_params`` (models/medusa.py): K trained residual heads
      propose all K drafts in ONE shot from the frontier hidden state —
      no draft model, no draft forward passes. ``draft_k`` is taken from
      the number of heads.

    Requires greedy decoding without timestamps: ``temperature == 0``,
    ``without_timestamps=True``, no beam/best_of. The timestamp grammar is
    stateful across positions, which conflicts with block verification;
    transcription evaluation (the hot serving path) runs without timestamps.
    """
    medusa = medusa_params is not None
    ngram = draft_params is None and not medusa
    if medusa and draft_params is not None:
        raise ValueError("medusa_params excludes a draft model")
    if medusa:
        draft_k = len(medusa_params["heads"])
    if options.temperature != 0.0:
        raise ValueError("speculative_decode requires temperature == 0")
    if not options.without_timestamps:
        raise ValueError(
            "speculative_decode requires without_timestamps=True"
        )
    if options.beam_size is not None or options.best_of is not None:
        raise ValueError("speculative_decode excludes beam_size/best_of")
    if ngram or medusa:
        draft_cfg = cfg  # context-length bookkeeping only
    elif draft_cfg.n_vocab != cfg.n_vocab or (
        draft_cfg.multilingual != cfg.multilingual
    ):
        raise ValueError(
            "draft and target models must share the tokenizer "
            f"(vocab {draft_cfg.n_vocab} vs {cfg.n_vocab})"
        )

    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=options.language or "en",
            task=options.task,
        )

    dtype = jnp.bfloat16 if options.fp16 else jnp.float32

    mel = jnp.asarray(mel)
    if mel.ndim == 2:
        mel = mel[None]
    from .decoding import _encode_jit

    audio_features = _encode_jit(params, cfg, mel, dtype=dtype)

    draft_features = None
    if not (ngram or medusa):
        if draft_mel is None:
            if draft_cfg.n_mels != cfg.n_mels:
                raise ValueError(
                    "draft_mel is required when the models use different "
                    f"mel sizes ({draft_cfg.n_mels} vs {cfg.n_mels})"
                )
            draft_mel = mel
        else:
            draft_mel = jnp.asarray(draft_mel)
            if draft_mel.ndim == 2:
                draft_mel = draft_mel[None]
        draft_features = _encode_jit(draft_params, draft_cfg, draft_mel, dtype=dtype
        )

    prefix = initial_tokens(tokenizer, options)
    n_prefix = len(prefix)
    sot_index = prefix.index(tokenizer.sot)
    B = audio_features.shape[0]
    prefix_tokens = jnp.tile(jnp.asarray(prefix, jnp.int32)[None, :], (B, 1))

    detected_langs = None
    if options.language is None and cfg.multilingual:
        detected_langs, _ = detect_language(
            params, cfg, audio_features, tokenizer
        )
        lang_ids = jnp.asarray(
            [tokenizer.language_token(c) for c in detected_langs], jnp.int32
        )
        prefix_tokens = prefix_tokens.at[:, 1].set(lang_ids)

    sample_len = options.sample_len or (cfg.n_text_ctx // 2)
    # the verification block may run K positions past the last emitted
    # token; keep every touched position inside both models' contexts
    max_ctx = min(cfg.n_text_ctx, draft_cfg.n_text_ctx)
    sample_len = min(sample_len, max_ctx - n_prefix - draft_k - 1)

    suppress_mask = jnp.asarray(
        build_suppress_mask(tokenizer, options, cfg.n_vocab)
    )
    blank_mask = (
        jnp.asarray(build_blank_mask(tokenizer, cfg.n_vocab))
        if options.suppress_blank
        else jnp.zeros((cfg.n_vocab,), jnp.float32)
    )

    tokens_buf, sum_logprobs, sot_logits, rounds, emitted = _spec_decode_jit(
        params,
        draft_params,
        cfg,
        draft_cfg,
        audio_features,
        draft_features,
        prefix_tokens,
        suppress_mask,
        blank_mask,
        tokenizer.eot,
        n_prefix,
        int(sample_len),
        int(draft_k),
        dtype_name=jnp.dtype(dtype).name,
        sot_index=sot_index,
        cross_kv_int8=options.kv_int8,
        cross_kv_int4=options.kv_int4,
        ngram=ngram,
        medusa=medusa,
        medusa_params=medusa_params,
    )

    tokens_np = np.asarray(tokens_buf)
    sum_logprobs_np = np.asarray(sum_logprobs)
    no_speech_probs = np.asarray(
        jax.nn.softmax(sot_logits, axis=-1)[:, tokenizer.no_speech]
    )

    results = []
    for b in range(B):
        seq = tokens_np[b, n_prefix:]
        eot_pos = np.nonzero(seq == tokenizer.eot)[0]
        end = int(eot_pos[0]) if len(eot_pos) else len(seq)
        end = min(end, sample_len)
        out_tokens = seq[:end].tolist()
        text = tokenizer.decode_text(out_tokens).strip()
        avg_logprob = float(sum_logprobs_np[b]) / (end + 1)
        results.append(
            DecodingResult(
                tokens=out_tokens,
                text=text,
                avg_logprob=avg_logprob,
                no_speech_prob=float(no_speech_probs[b]),
                temperature=0.0,
                compression_ratio=compression_ratio(text),
                language=(
                    detected_langs[b]
                    if detected_langs
                    else options.language or tokenizer.language
                ),
            )
        )
    stats = SpeculativeStats(
        rounds=int(rounds),
        emitted_tokens=int(emitted),
        draft_k=draft_k,
        batch=B,
    )
    if return_stats:
        return results, stats
    return results

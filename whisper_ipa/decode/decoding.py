"""Autoregressive decoding: options, logit filters, greedy + sampling loop.

Mirrors the behavioral surface of the reference's decoding layer
(mlx_whisper.decoding.DecodingOptions/decode, consumed at reference
scripts/evaluate_model.py:168-200 and scripts/train_whisper_ipa.py:338-343)
but is designed for accelerator execution: the token loop is a single jitted
``lax.while_loop`` over fixed-shape state (token buffer, KV cache, finished
mask), so one XLA program decodes an entire batch with no per-token host
round-trips — the reference pays a device sync per token.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from functools import partial
from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from ..models.whisper import (
    cast_decoder_blocks,
    decode_step,
    encode,
    init_cache,
)
from ..tokenizer import WhisperTokenizer, get_tokenizer
from ..tokenizer.whisper_tokenizer import N_TIMESTAMPS


@dataclass(frozen=True)
class DecodingOptions:
    """Reference-compatible decoding options."""

    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0
    fp16: bool = False
    # extensions over the reference surface: seed for temperature sampling /
    # best_of draws (the reference's sampler is globally seeded by torch/mlx),
    # and kv_int8 to quantize the cross-attention K/V cache to int8 (halves
    # the decode loop's dominant HBM read; ~0.4% logit error)
    seed: int = 0
    kv_int8: bool = False
    kv_int4: bool = False  # nibble-packed int4 cross-KV (quarter bytes)


@dataclass
class DecodingResult:
    tokens: List[int]
    text: str
    avg_logprob: float
    no_speech_prob: float
    temperature: float
    compression_ratio: float
    audio_features: Optional[np.ndarray] = None
    language: Optional[str] = None


_encode_jit = jax.jit(encode, static_argnames=("cfg", "dtype"))


@partial(jax.jit, static_argnames=("cfg", "sot"))
def _language_logits_jit(params, cfg: WhisperConfig, audio_features, sot: int):
    """Logits after a single SOT step (language-identification forward)."""
    cache = init_cache(params, cfg, audio_features, max_len=8)
    B = audio_features.shape[0]
    tokens = jnp.full((B, 1), sot, jnp.int32)
    logits, _ = decode_step(params, cfg, tokens, cache, 0)
    return logits[:, 0]


def detect_language(
    params,
    cfg: WhisperConfig,
    audio_features,
    tokenizer: Optional[WhisperTokenizer] = None,
):
    """Identify the spoken language from encoder output.

    Returns (language_codes list[str], probs list[dict code->prob]).
    Mirrors the Whisper language-ID procedure: one decoder step on SOT,
    softmax restricted to the language-token block.
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual, num_languages=cfg.num_languages
        )
    logits = _language_logits_jit(
        params, cfg, jnp.asarray(audio_features), tokenizer.sot,
    )
    lang_tokens = np.asarray(tokenizer.all_language_tokens)
    lang_logits = np.asarray(logits)[:, lang_tokens]
    probs = np.exp(lang_logits - lang_logits.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)

    from ..tokenizer.whisper_tokenizer import LANGUAGES, LANGUAGES_V3

    langs = (
        LANGUAGES_V3 if tokenizer.num_languages == 100 else LANGUAGES
    )[: tokenizer.num_languages]
    best = probs.argmax(axis=-1)
    codes = [langs[i] for i in best]
    prob_dicts = [
        dict(zip(langs, row.tolist())) for row in probs
    ]
    return codes, prob_dicts


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# -- suppression masks ----------------------------------------------------

def build_suppress_mask(
    tokenizer: WhisperTokenizer,
    options: DecodingOptions,
    n_vocab: int,
) -> np.ndarray:
    """Additive mask (n_vocab,) with -inf at always-suppressed ids."""
    suppress: set = set()
    opt = options.suppress_tokens
    if isinstance(opt, str):
        if opt == "-1":
            suppress.update(tokenizer.non_speech_tokens)
    elif opt:
        ids = [int(t) for t in opt]
        if -1 in ids:
            suppress.update(tokenizer.non_speech_tokens)
            ids = [t for t in ids if t != -1]
        suppress.update(ids)
    suppress.update(
        [
            tokenizer.transcribe,
            tokenizer.translate,
            tokenizer.sot,
            tokenizer.sot_prev,
            tokenizer.sot_lm,
            tokenizer.no_speech,
        ]
    )
    mask = np.zeros((n_vocab,), dtype=np.float32)
    mask[sorted(i for i in suppress if i < n_vocab)] = -np.inf
    if options.without_timestamps:
        mask[tokenizer.no_timestamps] = -np.inf
        mask[tokenizer.timestamp_begin :] = -np.inf
    return mask


def build_blank_mask(
    tokenizer: WhisperTokenizer, n_vocab: int
) -> np.ndarray:
    """-inf at {space, EOT} — applied only at the first sampled position."""
    mask = np.zeros((n_vocab,), dtype=np.float32)
    for t in tokenizer.encode(" ") + [tokenizer.eot]:
        if t < n_vocab:
            mask[t] = -np.inf
    return mask


def initial_tokens(
    tokenizer: WhisperTokenizer, options: DecodingOptions
) -> List[int]:
    if options.without_timestamps:
        seq = list(tokenizer.sot_sequence_including_notimestamps)
    else:
        seq = list(tokenizer.sot_sequence)
    if options.prefix is not None:
        prefix = (
            tokenizer.encode(" " + options.prefix.strip())
            if isinstance(options.prefix, str)
            else list(options.prefix)
        )
        seq = seq + prefix
    if options.prompt is not None:
        prompt = (
            tokenizer.encode(" " + options.prompt.strip())
            if isinstance(options.prompt, str)
            else list(options.prompt)
        )
        seq = (
            [tokenizer.sot_prev]
            + prompt[-(448 // 2 - 1) :]
            + seq
        )
    return seq


def sequence_score(
    sum_logprob: float, length: int, length_penalty: Optional[float]
) -> float:
    """MaximumLikelihoodRanker penalty (Whisper/GNMT convention)."""
    if length_penalty is None:
        penalty = max(length, 1)
    else:
        penalty = ((5.0 + length) / 6.0) ** length_penalty
    return sum_logprob / penalty


# -- timestamp grammar (shared by greedy and beam loops) --------------------

def apply_timestamp_rules(
    logits,
    vocab_idx,
    step,
    prev_tok,
    prev2_tok,
    last_ts,
    *,
    eot: int,
    timestamp_begin: int,
    max_initial_ts_index: int,
):
    """Whisper's ApplyTimestampRules, batched over any leading dims.

    ``logits``: (..., V); ``prev_tok``/``prev2_tok``/``last_ts``: (...,);
    ``step``: scalar (0 = first sampled position). Rules (reference:
    mlx_whisper.decoding.ApplyTimestampRules, applied in every decode mode):

    - timestamps come in pairs (except directly before EOT): after a lone
      timestamp only timestamps/EOT may follow; after a pair only text
    - timestamps are strictly increasing, except that the token closing a
      lone (segment-opening) timestamp may equal it
    - the first sampled token must be a timestamp, capped at
      max_initial_timestamp
    - when the total timestamp probability beats every text token, a
      timestamp must be sampled

    ``last_ts`` should be initialised to ``timestamp_begin - 1`` (sentinel:
    no timestamp emitted yet, so no monotonicity constraint applies).
    """
    neg_inf = jnp.float32(-jnp.inf)
    is_ts_vec = vocab_idx >= timestamp_begin  # (V,)
    last_was_ts = prev_tok >= timestamp_begin
    pen_was_ts = prev2_tok >= timestamp_begin

    # pairing rules
    suppress_ts = (last_was_ts & pen_was_ts)[..., None] & is_ts_vec
    force_ts = (last_was_ts & ~pen_was_ts)[..., None] & ~(
        is_ts_vec | (vocab_idx == eot)
    )
    logits = jnp.where(suppress_ts | force_ts, neg_inf, logits)

    # monotonicity: strictly greater than the last emitted timestamp, except
    # equality is allowed when closing a lone segment-opening timestamp
    min_allowed = jnp.where(last_was_ts & ~pen_was_ts, last_ts, last_ts + 1)
    logits = jnp.where(
        is_ts_vec & (vocab_idx < min_allowed[..., None]), neg_inf, logits
    )

    # initial timestamp window
    first_allowed = is_ts_vec & (
        vocab_idx <= timestamp_begin + max_initial_ts_index
    )
    logits = jnp.where(
        step == 0, jnp.where(first_allowed, logits, neg_inf), logits
    )

    # timestamp-probability dominance
    lp = jax.nn.log_softmax(logits, axis=-1)
    ts_mass = jax.nn.logsumexp(jnp.where(is_ts_vec, lp, neg_inf), axis=-1)
    max_text = jnp.max(jnp.where(is_ts_vec, neg_inf, lp), axis=-1)
    dominate = (ts_mass > max_text)[..., None]
    logits = jnp.where(dominate & ~is_ts_vec, neg_inf, logits)
    return logits


# -- jitted greedy/sampling loop ------------------------------------------

@partial(
    jax.jit,
    static_argnames=(
        "cfg",
        "n_prefix",
        "sample_len",
        "temperature",
        "dtype_name",
        "timestamp_rules",
        "timestamp_begin",
        "max_initial_ts_index",
        "sot_index",
        "cross_kv_int8",
        "cross_kv_int4",
    ),
)
def _greedy_decode_jit(
    params,
    cfg: WhisperConfig,
    audio_features,
    prefix_tokens,  # (B, n_prefix) int32
    suppress_mask,  # (n_vocab,) float32
    blank_mask,  # (n_vocab,) float32
    eot: int,
    n_prefix: int,
    sample_len: int,
    temperature: float,
    rng_key,
    dtype_name: str = "float32",
    timestamp_rules: bool = False,
    timestamp_begin: int = 50364,
    max_initial_ts_index: int = 50,
    sot_index: int = 0,
    cross_kv_int8: bool = False,
    cross_kv_int4: bool = False,
):
    """Batched greedy/temperature decode under one lax.while_loop."""
    dtype = jnp.dtype(dtype_name)
    # one-time cast OUTSIDE the token loop: kills the per-(layer, step)
    # f32->bf16 weight converts and halves param-slice traffic (xprof r4)
    params = cast_decoder_blocks(params, dtype)
    B = audio_features.shape[0]
    max_len = n_prefix + sample_len
    cache = init_cache(
        params, cfg, audio_features, max_len=max_len, dtype=dtype,
        cross_kv_int8=cross_kv_int8,
        cross_kv_int4=cross_kv_int4,
    )

    # consume the prefix in one step
    prefix_logits, cache = decode_step(
        params, cfg, prefix_tokens, cache, 0, dtype=dtype
    )
    # logits after the SOT token — with a conditioning prompt the prefix is
    # [sot_prev, *prompt, *sot_sequence], so SOT is not at position 0
    sot_logits = prefix_logits[:, sot_index]

    last_logits = prefix_logits[:, -1]

    tokens_buf = jnp.full((B, max_len), eot, dtype=jnp.int32)
    tokens_buf = jax.lax.dynamic_update_slice(
        tokens_buf, prefix_tokens.astype(jnp.int32), (0, 0)
    )

    vocab_idx = jnp.arange(suppress_mask.shape[0])

    def apply_filters(logits, step, prev_tok, prev2_tok, last_ts):
        logits = logits + suppress_mask
        logits = jnp.where(step == 0, logits + blank_mask, logits)
        if timestamp_rules:
            logits = apply_timestamp_rules(
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
        return logits

    def sample(logits, key):
        if temperature == 0.0:
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return jax.random.categorical(key, logits / temperature, axis=-1).astype(
            jnp.int32
        )

    def body(state):
        (
            step,
            tokens_buf,
            cache,
            logits,
            finished,
            sum_logprobs,
            key,
            prev_tok,
            prev2_tok,
            last_ts,
        ) = state
        key, sub = jax.random.split(key)
        filtered = apply_filters(logits, step, prev_tok, prev2_tok, last_ts)
        next_tok = sample(filtered, sub)
        logprobs = jax.nn.log_softmax(filtered, axis=-1)
        tok_logprob = jnp.take_along_axis(
            logprobs, next_tok[:, None], axis=-1
        )[:, 0]

        next_tok = jnp.where(finished, eot, next_tok)
        sum_logprobs = sum_logprobs + jnp.where(finished, 0.0, tok_logprob)
        finished = finished | (next_tok == eot)

        prev2_tok = prev_tok
        prev_tok = next_tok
        last_ts = jnp.where(next_tok >= timestamp_begin, next_tok, last_ts)

        pos = n_prefix + step
        tokens_buf = jax.lax.dynamic_update_slice(
            tokens_buf, next_tok[:, None], (0, pos)
        )
        new_logits, cache = decode_step(
            params, cfg, next_tok[:, None], cache, pos, dtype=dtype
        )
        return (
            step + 1,
            tokens_buf,
            cache,
            new_logits[:, 0],
            finished,
            sum_logprobs,
            key,
            prev_tok,
            prev2_tok,
            last_ts,
        )

    def cond(state):
        step = state[0]
        finished = state[4]
        return (step < sample_len) & ~jnp.all(finished)

    state = (
        jnp.array(0, jnp.int32),
        tokens_buf,
        cache,
        last_logits,
        jnp.zeros((B,), bool),
        jnp.zeros((B,), jnp.float32),
        rng_key,
        prefix_tokens[:, -1].astype(jnp.int32),
        prefix_tokens[:, -2].astype(jnp.int32)
        if n_prefix >= 2
        else prefix_tokens[:, -1].astype(jnp.int32),
        # sentinel: no timestamp emitted yet (see apply_timestamp_rules)
        jnp.full((B,), timestamp_begin - 1, jnp.int32),
    )
    out_state = jax.lax.while_loop(cond, body, state)
    tokens_buf = out_state[1]
    sum_logprobs = out_state[5]
    return tokens_buf, sum_logprobs, sot_logits


# -- public API -----------------------------------------------------------

def decode(
    params,
    cfg: WhisperConfig,
    audio_input,
    options: DecodingOptions = DecodingOptions(),
    tokenizer: Optional[WhisperTokenizer] = None,
) -> List[DecodingResult]:
    """Decode mel spectrograms or precomputed audio features to text.

    audio_input: (B, 3000, n_mels) mel or (B, 1500, d) encoder output.
    Returns one DecodingResult per batch element (reference surface:
    ``decode(model, features, DecodingOptions(...))`` returning result[i]).
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=options.language or "en",
            task=options.task,
        )
    elif options.language and tokenizer.language != options.language:
        tokenizer = replace(tokenizer)
        tokenizer.language = options.language

    # the reference's fp16 flag maps to bfloat16 mixed precision
    dtype = jnp.bfloat16 if options.fp16 else jnp.float32

    audio_input = jnp.asarray(audio_input)
    if audio_input.ndim == 2:
        audio_input = audio_input[None]
    if audio_input.shape[-1] == cfg.n_mels:
        audio_features = _encode_jit(params, cfg, audio_input, dtype=dtype)
    else:
        audio_features = audio_input

    prefix = initial_tokens(tokenizer, options)
    n_prefix = len(prefix)
    # position of SOT in the prefix: no_speech_prob is read from the logits
    # at the SOT position, which shifts when a conditioning prompt is present
    sot_index = prefix.index(tokenizer.sot)
    B = audio_features.shape[0]
    prefix_tokens = jnp.tile(
        jnp.asarray(prefix, jnp.int32)[None, :], (B, 1)
    )

    # language=None on a multilingual model: identify per sample and patch
    # the language slot of each prefix (reference validate() decodes with
    # auto language, scripts/train_whisper_ipa.py:339)
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
    sample_len = min(sample_len, cfg.n_text_ctx - n_prefix)

    suppress_mask = jnp.asarray(
        build_suppress_mask(tokenizer, options, cfg.n_vocab)
    )
    blank_mask = (
        jnp.asarray(build_blank_mask(tokenizer, cfg.n_vocab))
        if options.suppress_blank
        else jnp.zeros((cfg.n_vocab,), jnp.float32)
    )

    max_initial_ts_index = (
        int(options.max_initial_timestamp / 0.02)
        if options.max_initial_timestamp is not None
        else N_TIMESTAMPS - 1
    )

    if options.beam_size is not None:
        from .beam import beam_decode

        return beam_decode(
            params,
            cfg,
            audio_features,
            prefix,
            options,
            tokenizer,
            suppress_mask,
            blank_mask,
            prefix_tokens=prefix_tokens,  # carries detected languages
            sot_index=sot_index,
            max_initial_ts_index=max_initial_ts_index,
            detected_langs=detected_langs,
        )

    # best_of: at temperature > 0, sample n independent candidates per
    # input (batch-tiled) and keep the highest-scoring one (the reference
    # decoder's best_of option)
    n_candidates = (
        int(options.best_of)
        if options.best_of and options.temperature > 0
        else 1
    )
    if n_candidates > 1:
        audio_features = jnp.repeat(audio_features, n_candidates, axis=0)
        prefix_tokens = jnp.repeat(prefix_tokens, n_candidates, axis=0)

    tokens_buf, sum_logprobs, sot_logits = _greedy_decode_jit(
        params,
        cfg,
        audio_features,
        prefix_tokens,
        suppress_mask,
        blank_mask,
        tokenizer.eot,
        n_prefix,
        int(sample_len),
        float(options.temperature),
        jax.random.PRNGKey(options.seed),
        dtype_name=jnp.dtype(dtype).name,
        timestamp_rules=not options.without_timestamps,
        timestamp_begin=tokenizer.timestamp_begin,
        max_initial_ts_index=max_initial_ts_index,
        sot_index=sot_index,
        cross_kv_int8=options.kv_int8,
        cross_kv_int4=options.kv_int4,
    )

    tokens_np = np.asarray(tokens_buf)
    sum_logprobs_np = np.asarray(sum_logprobs)
    no_speech_probs = np.asarray(
        jax.nn.softmax(sot_logits, axis=-1)[:, tokenizer.no_speech]
    )

    if n_candidates > 1:
        # rank candidates per original sample by length-penalized score
        keep = []
        for b in range(B):
            best_row = None
            best_score = -np.inf
            for c in range(n_candidates):
                row = b * n_candidates + c
                seq = tokens_np[row, n_prefix:]
                eot_pos = np.nonzero(seq == tokenizer.eot)[0]
                end = int(eot_pos[0]) if len(eot_pos) else len(seq)
                score = sequence_score(
                    float(sum_logprobs_np[row]), end, options.length_penalty
                )
                if score > best_score:
                    best_score = score
                    best_row = row
            keep.append(best_row)
        tokens_np = tokens_np[keep]
        sum_logprobs_np = sum_logprobs_np[keep]
        no_speech_probs = no_speech_probs[keep]

    results = []
    for b in range(B):
        seq = tokens_np[b, n_prefix:]
        eot_pos = np.nonzero(seq == tokenizer.eot)[0]
        end = int(eot_pos[0]) if len(eot_pos) else len(seq)
        out_tokens = seq[:end].tolist()
        text = tokenizer.decode_text(out_tokens).strip()
        # avg over emitted tokens + the EOT decision
        avg_logprob = float(sum_logprobs_np[b]) / (end + 1)
        results.append(
            DecodingResult(
                tokens=out_tokens,
                text=text,
                avg_logprob=avg_logprob,
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

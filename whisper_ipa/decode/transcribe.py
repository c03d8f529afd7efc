"""High-level transcription: file/array -> text via chunked batched decode.

The reference's base-model path uses mlx_whisper.transcribe (30 s internal
chunking, sequential per chunk; reference scripts/evaluate_model.py:114).
Here chunks are batched: audio is split into 30 s windows on the host, all
windows are melled and encoded as ONE batch on the device, and decoded
together instead of as batch-1 work per chunk. Temperature
fallback follows Whisper's ladder (compression ratio / avg-logprob gates).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from ..audio import (
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_spectrogram,
    pad_or_trim,
)
from ..config import WhisperConfig
from ..tokenizer import WhisperTokenizer, get_tokenizer
from .decoding import DecodingOptions, DecodingResult, decode


def chunk_audio(audio: np.ndarray) -> List[np.ndarray]:
    """Split audio into 30 s windows (last window zero-padded)."""
    if len(audio) == 0:
        return [np.zeros(N_SAMPLES, np.float32)]
    chunks = []
    for start in range(0, len(audio), N_SAMPLES):
        chunks.append(pad_or_trim(audio[start : start + N_SAMPLES]))
    return chunks


PROMPT_PAD_LEN = 64  # fixed conditioning-prompt length (bounded recompiles)


def _fixed_length_prompt(
    tokens, sot_prev: int, length: int = PROMPT_PAD_LEN,
    n_text_ctx: Optional[int] = None,
):
    """Last `length` prompt tokens, left-padded with sot_prev.

    A fixed prompt length keeps the jitted decode program count bounded
    (variable-length prompts would recompile per window). The length is
    capped at n_text_ctx//2 - 1 (Whisper's prompt budget) so the full
    prefix never overruns the positional embedding on small-context models.
    """
    if n_text_ctx is not None:
        length = min(length, n_text_ctx // 2 - 1)
    tokens = list(tokens)[-length:]
    return [sot_prev] * (length - len(tokens)) + tokens


def parse_timestamp_segments(tokens, timestamp_begin: int):
    """Split a timestamped token stream into segments.

    Returns (segments, seek_advance_frames): segments are
    (start_frame, end_frame, text_tokens) triples; seek advance follows
    Whisper's rule — jump to the last *consecutive* timestamp pair if one
    exists, else consume the whole window.
    """
    ts_positions = [
        i for i, t in enumerate(tokens) if t >= timestamp_begin
    ]
    consecutive_ends = [
        ts_positions[k + 1]
        for k in range(len(ts_positions) - 1)
        if ts_positions[k + 1] == ts_positions[k] + 1
    ]

    segments = []
    start_idx = None
    for i, t in enumerate(tokens):
        if t >= timestamp_begin:
            if start_idx is None:
                start_idx = i
            else:
                text = [
                    x for x in tokens[start_idx + 1 : i]
                    if x < timestamp_begin
                ]
                if text:
                    segments.append(
                        (
                            tokens[start_idx] - timestamp_begin,
                            t - timestamp_begin,
                            text,
                        )
                    )
                start_idx = i if tokens[i] >= timestamp_begin else None
    if consecutive_ends:
        seek_advance = tokens[consecutive_ends[-1]] - timestamp_begin
    else:
        seek_advance = None  # consume the full window
    return segments, seek_advance


def transcribe(
    params,
    cfg: WhisperConfig,
    audio: Union[str, np.ndarray],
    *,
    language: Optional[str] = "en",
    temperature: Union[float, tuple] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    beam_size: Optional[int] = None,
    word_timestamps: bool = False,
    condition_on_previous_text: bool = False,
    sequential_timestamps: bool = False,
    tokenizer: Optional[WhisperTokenizer] = None,
    **decode_kwargs,
) -> dict:
    """Transcribe a file path or float32 waveform. Returns {"text", "segments"}.

    Two long-form modes:
      - default: all 30 s windows decoded as ONE device batch (fastest)
      - condition_on_previous_text=True: windows decoded sequentially, each
        conditioned on the previous window's tokens via a fixed-length
        <|startofprev|> prompt (mlx_whisper.transcribe's behavior)

    word_timestamps=True adds per-IPA-phone timing to each segment via
    cross-attention DTW alignment (decode/word_timestamps.py).
    """
    if isinstance(audio, str):
        audio = load_audio(audio)
    audio = np.asarray(audio, dtype=np.float32)

    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )

    if sequential_timestamps:
        return _transcribe_sequential_timestamps(
            params,
            cfg,
            audio,
            language=language,
            tokenizer=tokenizer,
            temperature=temperature,
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            **decode_kwargs,
        )

    chunks = chunk_audio(audio)
    mels = np.stack([log_mel_spectrogram(c, n_mels=cfg.n_mels) for c in chunks])

    temperatures = (
        (temperature,) if isinstance(temperature, (int, float)) else tuple(temperature)
    )

    def run(t: float) -> List[DecodingResult]:
        options = DecodingOptions(
            language=language,
            without_timestamps=True,
            temperature=t,
            beam_size=beam_size if t == 0.0 else None,
            **decode_kwargs,
        )
        return decode(params, cfg, mels, options, tokenizer=tokenizer)

    def run_sequential(t: float) -> List[DecodingResult]:
        results: List[DecodingResult] = []
        prev_tokens: List[int] = []
        for i in range(len(mels)):
            prompt = (
                _fixed_length_prompt(
                    prev_tokens, tokenizer.sot_prev, n_text_ctx=cfg.n_text_ctx
                )
                if prev_tokens
                else None
            )
            options = DecodingOptions(
                language=language,
                without_timestamps=True,
                temperature=t,
                beam_size=beam_size if t == 0.0 else None,
                prompt=prompt,
                **decode_kwargs,
            )
            r = decode(
                params, cfg, mels[i : i + 1], options, tokenizer=tokenizer
            )[0]
            results.append(r)
            prev_tokens = (prev_tokens + r.tokens)[-PROMPT_PAD_LEN:]
        return results

    if condition_on_previous_text and len(mels) > 1:
        results = run_sequential(temperatures[0])
    else:
        results = run(temperatures[0])
    # per-chunk fallback: retry failed chunks at higher temperatures
    for t in temperatures[1:]:
        needs_retry = [
            i
            for i, r in enumerate(results)
            if (
                compression_ratio_threshold is not None
                and r.compression_ratio > compression_ratio_threshold
            )
            or (
                logprob_threshold is not None
                and r.avg_logprob < logprob_threshold
            )
        ]
        if not needs_retry:
            break
        retried = decode(
            params,
            cfg,
            mels[needs_retry],
            DecodingOptions(
                language=language, without_timestamps=True, temperature=t
            ),
            tokenizer=tokenizer,
        )
        for i, r in zip(needs_retry, retried):
            results[i] = r

    segments = []
    texts = []
    for i, r in enumerate(results):
        if (
            no_speech_threshold is not None
            and r.no_speech_prob > no_speech_threshold
            and (
                logprob_threshold is None or r.avg_logprob < logprob_threshold
            )
        ):
            continue  # silent chunk
        segment = {
            "id": i,
            "start": i * 30.0,
            "end": min((i + 1) * 30.0, len(audio) / SAMPLE_RATE),
            "text": r.text,
            "tokens": r.tokens,
            "avg_logprob": r.avg_logprob,
            "no_speech_prob": r.no_speech_prob,
            "compression_ratio": r.compression_ratio,
            "temperature": r.temperature,
        }
        if word_timestamps and r.tokens:
            from .word_timestamps import phone_timestamps

            window_secs = min(30.0, len(audio) / SAMPLE_RATE - i * 30.0)
            phones = phone_timestamps(
                params,
                cfg,
                r.tokens,
                mels[i : i + 1],
                tokenizer=tokenizer,
                audio_seconds=max(window_secs, 0.1),
            )
            offset = i * 30.0
            segment["phones"] = [
                {
                    "phone": p["phone"],
                    "start": p["start"] + offset,
                    "end": p["end"] + offset,
                }
                for p in phones
            ]
        segments.append(segment)
        texts.append(r.text)

    return {
        "text": "".join(texts),
        "segments": segments,
        "language": language,
    }


def _transcribe_sequential_timestamps(
    params,
    cfg: WhisperConfig,
    audio: np.ndarray,
    *,
    language: Optional[str] = "en",
    tokenizer: Optional[WhisperTokenizer] = None,
    max_windows: int = 200,
    temperature: Union[float, tuple] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = False,
    **decode_kwargs,
) -> dict:
    """Whisper's true long-form mode: decode WITH timestamps, advance the
    window to the last complete segment boundary (not fixed 30 s jumps).

    Faithful to mlx_whisper.transcribe's per-window loop: the temperature
    fallback ladder runs per window (retrying when the compression-ratio or
    logprob gate fails), silent windows (no_speech gate) advance without
    emitting, and condition_on_previous_text threads the accumulated tokens
    through a <|startofprev|> prompt (reset after a high-temperature
    fallback, as Whisper does).
    """
    if tokenizer is None:
        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )
    ts_begin = tokenizer.timestamp_begin
    frame_sec = 0.02
    temperatures = (
        (temperature,)
        if isinstance(temperature, (int, float))
        else tuple(temperature)
    )

    def decode_window(mel, prompt):
        """Temperature ladder for one window (Whisper's fallback rule)."""
        r = None
        for t in temperatures:
            options = DecodingOptions(
                language=language,
                without_timestamps=False,
                temperature=t,
                prompt=prompt if t <= 0.5 else None,
                **decode_kwargs,
            )
            r = decode(params, cfg, mel, options, tokenizer=tokenizer)[0]
            ok = True
            if (
                compression_ratio_threshold is not None
                and r.compression_ratio > compression_ratio_threshold
            ):
                ok = False
            if (
                logprob_threshold is not None
                and r.avg_logprob < logprob_threshold
            ):
                ok = False
            if ok:
                return r
        return r

    segments = []
    texts = []
    seek = 0  # in samples
    window = 0
    prev_tokens: List[int] = []
    while seek < len(audio) and window < max_windows:
        chunk = pad_or_trim(audio[seek : seek + N_SAMPLES])
        mel = log_mel_spectrogram(chunk, n_mels=cfg.n_mels)[None]
        prompt = (
            _fixed_length_prompt(
                prev_tokens, tokenizer.sot_prev, n_text_ctx=cfg.n_text_ctx
            )
            if condition_on_previous_text and prev_tokens
            else None
        )
        r = decode_window(mel, prompt)

        # silent window: skip without emitting, advance a full window
        if (
            no_speech_threshold is not None
            and r.no_speech_prob > no_speech_threshold
            and (
                logprob_threshold is None
                or r.avg_logprob < logprob_threshold
            )
        ):
            seek += N_SAMPLES
            window += 1
            prev_tokens = []  # do not condition across silence
            continue

        if condition_on_previous_text:
            if r.temperature > 0.5:
                prev_tokens = []  # Whisper: reset after a hot fallback
            else:
                prev_tokens = (prev_tokens + r.tokens)[-PROMPT_PAD_LEN:]

        # recover the raw token stream incl. timestamps
        window_segments, advance = parse_timestamp_segments(
            r.tokens, ts_begin
        )
        offset_sec = seek / SAMPLE_RATE
        for s_frame, e_frame, text_tokens in window_segments:
            text = tokenizer.decode_text(text_tokens).strip()
            if not text:
                continue
            segments.append(
                {
                    "id": len(segments),
                    "start": offset_sec + s_frame * frame_sec,
                    "end": offset_sec + e_frame * frame_sec,
                    "text": text,
                    "tokens": text_tokens,
                    "avg_logprob": r.avg_logprob,
                    "no_speech_prob": r.no_speech_prob,
                    "temperature": r.temperature,
                }
            )
            texts.append(text)
        if not window_segments and r.text.strip():
            # model emitted text without closing timestamps: keep it
            segments.append(
                {
                    "id": len(segments),
                    "start": offset_sec,
                    "end": min(offset_sec + 30.0, len(audio) / SAMPLE_RATE),
                    "text": r.text.strip(),
                    "tokens": r.tokens,
                    "avg_logprob": r.avg_logprob,
                    "no_speech_prob": r.no_speech_prob,
                    "temperature": r.temperature,
                }
            )
            texts.append(r.text.strip())

        if advance is not None and advance > 0:
            seek += int(advance * frame_sec * SAMPLE_RATE)
        else:
            seek += N_SAMPLES
        window += 1

    return {"text": "".join(texts), "segments": segments, "language": language}

"""Micro-batching inference service: request queue -> fixed device batches.

Production serving pattern for the batched decode path: callers submit audio
(any length) and receive futures; a background scheduler coalesces pending
requests into fixed-size batches (padding the tail with silence so the
jitted decode program never sees a new batch shape), runs the
mel -> encoder -> KV-cached greedy decode pipeline, and resolves futures.

The reference has no serving layer (single-process research scripts); this
is the deployment-facing counterpart of its transcribe path.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np

from .audio import N_SAMPLES, load_audio, pad_or_trim
from .config import WhisperConfig
from .decode import DecodingOptions, decode
from .tokenizer import WhisperTokenizer, get_tokenizer


@dataclass
class _Request:
    chunks: List[np.ndarray]  # 30 s windows of one utterance
    future: Future
    submitted_at: float
    # called from the scheduler thread once per decoded window with
    # {"window", "n_windows", "text", "partial_text"} — must be fast and
    # thread-safe (e.g. queue.put); used for streaming partial results
    on_partial: Optional[Callable[[dict], None]] = None


class TranscriptionService:
    """Thread-safe micro-batching transcription service.

    batch_size: fixed device batch (tail padded with silence).
    max_wait_ms: max time a request waits for the batch to fill.
    """

    def __init__(
        self,
        params,
        cfg: WhisperConfig,
        *,
        batch_size: int = 8,
        max_wait_ms: float = 50.0,
        language: Optional[str] = "en",
        beam_size: Optional[int] = None,
        bf16: bool = True,
        kv_int8: bool = True,
        kv_int4: bool = False,
        quant_bits: Optional[int] = None,
        draft_params=None,
        draft_cfg: Optional[WhisperConfig] = None,
        draft_k: int = 4,
        medusa_params=None,
        medusa_tree=None,
        mesh=None,
        tensor_parallel: bool = False,
        tokenizer: Optional[WhisperTokenizer] = None,
    ):
        if (draft_params is not None or medusa_params is not None) and (
            beam_size is not None
        ):
            raise ValueError(
                "speculative decoding (draft/medusa) excludes beam_size"
            )
        if draft_params is not None and medusa_params is not None:
            raise ValueError("choose ONE of draft_params / medusa_params")
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.draft_k = draft_k
        self.medusa_params = medusa_params
        if medusa_tree is not None and medusa_params is None:
            raise ValueError("medusa_tree needs medusa_params")
        self.medusa_tree = tuple(medusa_tree) if medusa_tree else None
        self.mesh = mesh
        if mesh is not None:
            n_data = mesh.shape.get("data", 1)
            if batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size={batch_size} must be divisible by the "
                    f"mesh's data axis ({n_data})"
                )
            if quant_bits is not None and tensor_parallel:
                raise ValueError(
                    "tensor_parallel serving with quant_bits is not "
                    "supported (TP sharding rules address unquantized "
                    "weight paths)"
                )
        if quant_bits is not None:
            # weight-only quantization at startup: int8 halves weight HBM
            # bytes vs bf16 (4x vs f32); int4 (grouped scales, packed
            # nibbles) halves them again — the decode loop re-reads all
            # decoder weights every token, so bytes ~ latency
            from .ops.quant import quantize_params

            params = quantize_params(params, bits=quant_bits)
        if mesh is not None:
            # multi-chip serving: params TP-sharded (or replicated) over
            # 'model', each batch sharded over 'data'; GSPMD inserts the
            # collectives — decode() itself is sharding-agnostic
            from .parallel.mesh import shard_params

            params = shard_params(mesh, params,
                                  tensor_parallel=tensor_parallel)
            if draft_params is not None:
                self.draft_params = shard_params(mesh, draft_params)
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.tokenizer = tokenizer or get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages,
            language=language or "en",
        )
        self.options = DecodingOptions(
            language=language,
            without_timestamps=True,
            beam_size=beam_size,
            fp16=bf16,
            # int8 cross-KV: +16-29% decode throughput at ~0.1% logit error
            # (token-identical in tests) — the right serving default
            kv_int8=kv_int8 and not kv_int4,
            kv_int4=kv_int4,
        )
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._stats = {"requests": 0, "batches": 0, "windows": 0}
        self._thread = threading.Thread(target=self._scheduler, daemon=True)
        self._thread.start()

    # -- client API -------------------------------------------------------

    def submit(
        self,
        audio: Union[str, np.ndarray],
        on_partial: Optional[Callable[[dict], None]] = None,
    ) -> Future:
        """Submit audio (path or waveform); resolves to {"text", ...}.

        on_partial: optional callback streaming one dict per decoded 30 s
        window (incremental hypotheses) before the future resolves.
        """
        if isinstance(audio, str):
            audio = load_audio(audio)
        audio = np.asarray(audio, np.float32)
        chunks = [
            pad_or_trim(audio[s : s + N_SAMPLES])
            for s in range(0, max(len(audio), 1), N_SAMPLES)
        ]
        fut: Future = Future()
        self._queue.put(_Request(chunks, fut, time.time(), on_partial))
        self._stats["requests"] += 1
        return fut

    def transcribe(self, audio, timeout: Optional[float] = None) -> dict:
        return self.submit(audio).result(timeout=timeout)

    def stats(self) -> dict:
        return dict(self._stats)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- scheduler --------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for the first request, then fill up to batch_size windows
        or until max_wait_ms elapses."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        n_windows = len(first.chunks)
        deadline = time.time() + self.max_wait_ms / 1000.0
        while n_windows < self.batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(req)
            n_windows += len(req.chunks)
        return batch

    def _scheduler(self):
        from .audio import log_mel_spectrogram

        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                windows: List[np.ndarray] = []
                owners: List[int] = []
                for i, req in enumerate(batch):
                    for c in req.chunks:
                        windows.append(c)
                        owners.append(i)

                results_per_req = [[] for _ in batch]
                for start in range(0, len(windows), self.batch_size):
                    group = windows[start : start + self.batch_size]
                    group_owners = owners[start : start + self.batch_size]
                    n_real = len(group)
                    while len(group) < self.batch_size:
                        group.append(np.zeros(N_SAMPLES, np.float32))
                    mels = np.stack(
                        [
                            log_mel_spectrogram(g, n_mels=self.cfg.n_mels)
                            for g in group
                        ]
                    )
                    if self.mesh is not None:
                        from .parallel.mesh import shard_batch

                        mels = shard_batch(self.mesh, mels)
                    if self.medusa_params is not None and (
                        self.medusa_tree is not None
                    ):
                        from .decode import medusa_tree_decode

                        results = medusa_tree_decode(
                            self.params,
                            self.cfg,
                            self.medusa_params,
                            mels,
                            self.options,
                            tree=self.medusa_tree,
                            tokenizer=self.tokenizer,
                        )
                    elif self.medusa_params is not None:
                        from .decode import speculative_decode

                        results = speculative_decode(
                            self.params,
                            self.cfg,
                            None,
                            None,
                            mels,
                            self.options,
                            tokenizer=self.tokenizer,
                            medusa_params=self.medusa_params,
                        )
                    elif self.draft_params is not None:
                        # speculative: identical tokens to plain greedy,
                        # fewer target forwards (decode/speculative.py)
                        from .decode import speculative_decode

                        draft_mels = None
                        if self.draft_cfg.n_mels != self.cfg.n_mels:
                            draft_mels = np.stack(
                                [
                                    log_mel_spectrogram(
                                        g, n_mels=self.draft_cfg.n_mels
                                    )
                                    for g in group
                                ]
                            )
                            if self.mesh is not None:
                                from .parallel.mesh import shard_batch

                                draft_mels = shard_batch(
                                    self.mesh, draft_mels
                                )
                        results = speculative_decode(
                            self.params,
                            self.cfg,
                            self.draft_params,
                            self.draft_cfg,
                            mels,
                            self.options,
                            draft_k=self.draft_k,
                            draft_mel=draft_mels,
                            tokenizer=self.tokenizer,
                        )
                    else:
                        results = decode(
                            self.params,
                            self.cfg,
                            mels,
                            self.options,
                            tokenizer=self.tokenizer,
                        )
                    self._stats["batches"] += 1
                    self._stats["windows"] += n_real
                    for k in range(n_real):
                        owner = group_owners[k]
                        results_per_req[owner].append(results[k])
                        req = batch[owner]
                        if req.on_partial is not None:
                            done = results_per_req[owner]
                            try:
                                req.on_partial(
                                    {
                                        "window": len(done) - 1,
                                        "n_windows": len(req.chunks),
                                        "text": results[k].text,
                                        "partial_text": "".join(
                                            r.text for r in done
                                        ),
                                    }
                                )
                            except Exception:
                                pass  # a slow/broken consumer must not
                                # stall the batch pipeline

                for req, res in zip(batch, results_per_req):
                    text = "".join(r.text for r in res)
                    req.future.set_result(
                        {
                            "text": text,
                            "segments": [
                                {
                                    "id": j,
                                    "text": r.text,
                                    "avg_logprob": r.avg_logprob,
                                    "no_speech_prob": r.no_speech_prob,
                                }
                                for j, r in enumerate(res)
                            ],
                            "latency_sec": time.time() - req.submitted_at,
                        }
                    )
            except Exception as e:  # resolve futures with the error
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

"""Micro-batching transcription service tests (tiny model, CPU)."""

import threading
import time
from dataclasses import replace

import numpy as np
import pytest

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params
from whisper_ipa.serve import TranscriptionService

# full-size audio window contract, tiny transformer dims
CFG = replace(
    CONFIGS["test-tiny"],
    n_audio_state=32,
    n_audio_head=2,
    n_audio_layer=1,
    n_text_state=32,
    n_text_head=2,
    n_text_layer=1,
    n_text_ctx=16,
)


@pytest.fixture(scope="module")
def service():
    params = init_params(CFG, seed=0)
    svc = TranscriptionService(
        params,
        CFG,
        batch_size=2,
        max_wait_ms=30.0,
        language="en",
        bf16=False,
    )
    yield svc
    svc.close()


class TestService:
    def test_single_request(self, service):
        audio = np.zeros(16000, np.float32)
        result = service.transcribe(audio, timeout=600)
        assert "text" in result and isinstance(result["text"], str)
        assert result["latency_sec"] > 0
        assert len(result["segments"]) == 1

    def test_concurrent_requests_batched(self, service):
        audios = [
            0.1 * np.sin(np.linspace(0, 100 + i, 16000)).astype(np.float32)
            for i in range(4)
        ]
        futures = [service.submit(a) for a in audios]
        results = [f.result(timeout=600) for f in futures]
        assert len(results) == 4
        stats = service.stats()
        assert stats["requests"] >= 4
        assert stats["windows"] >= 4

    def test_long_audio_multiple_segments(self, service):
        audio = np.zeros(16000 * 35, np.float32)  # 2 windows
        result = service.transcribe(audio, timeout=600)
        assert len(result["segments"]) == 2


class TestHTTPServer:
    def test_http_roundtrip(self, service):
        import io
        import json as _json
        import threading
        import urllib.request
        import wave
        from http.server import ThreadingHTTPServer

        from whisper_ipa.cli.serve import make_handler

        server = ThreadingHTTPServer(
            ("127.0.0.1", 0), make_handler(service)
        )
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            # health
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30
            ) as r:
                assert _json.loads(r.read())["status"] == "ok"

            # transcribe a WAV body
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(b"\x00\x00" * 8000)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/transcribe",
                data=buf.getvalue(),
                headers={"Content-Type": "audio/wav"},
            )
            with urllib.request.urlopen(req, timeout=600) as r:
                payload = _json.loads(r.read())
            assert "text" in payload

            # stats
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=30
            ) as r:
                stats = _json.loads(r.read())
            assert stats["requests"] >= 1
        finally:
            server.shutdown()


class TestStreamingPartials:
    def test_service_on_partial(self, service):
        """≥2 partials arrive (in order) before the future resolves
        (VERDICT r1 next-step 9)."""
        import queue

        events: "queue.Queue" = queue.Queue()
        order = []
        resolved_at = {}

        audio = np.zeros(16000 * 65, np.float32)  # 3 windows
        fut = service.submit(audio, on_partial=lambda p: (
            order.append((time.time(), dict(p))), events.put(p)))
        result = fut.result(timeout=600)
        resolved_at["t"] = time.time()

        partials = [order[i][1] for i in range(len(order))]
        assert len(partials) == 3
        assert [p["window"] for p in partials] == [0, 1, 2]
        assert all(p["n_windows"] == 3 for p in partials)
        # at least the first two partials strictly precede resolution
        assert order[1][0] <= resolved_at["t"]
        # partial_text accumulates to the final text
        assert partials[-1]["partial_text"] == result["text"]

    def test_http_stream_ndjson(self, service):
        """HTTP /transcribe_stream yields ≥2 partial lines then a final."""
        import io
        import json as _json
        import urllib.request
        import wave
        from http.server import ThreadingHTTPServer

        from whisper_ipa.cli.serve import make_handler

        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes(b"\x00\x00" * (16000 * 65))  # 3 windows
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/transcribe_stream",
                data=buf.getvalue(),
                headers={"Content-Type": "audio/wav"},
            )
            lines = []
            with urllib.request.urlopen(req, timeout=600) as r:
                assert r.headers["Content-Type"] == "application/x-ndjson"
                for raw in r:  # urllib decodes the chunked framing
                    raw = raw.strip()
                    if raw:
                        lines.append(_json.loads(raw))
            partial_lines = [ln for ln in lines if "partial" in ln]
            final_lines = [ln for ln in lines if "final" in ln]
            assert len(partial_lines) >= 2
            assert len(final_lines) == 1
            assert lines[-1] == final_lines[0]  # final arrives last
            assert partial_lines[-1]["partial"]["partial_text"] == (
                final_lines[0]["final"]["text"]
            )
        finally:
            server.shutdown()


class TestQuantizedService:
    def test_int8_service_transcribes(self):
        params = init_params(CFG, seed=0)
        svc = TranscriptionService(
            params,
            CFG,
            batch_size=2,
            max_wait_ms=30.0,
            language="en",
            bf16=False,
            quant_bits=8,
        )
        try:
            blk = svc.params["decoder"]["blocks"][0]["attn"]["query"]
            assert "w_q" in blk and "w" not in blk
            result = svc.transcribe(np.zeros(16000, np.float32), timeout=600)
            assert "text" in result
        finally:
            svc.close()

    def test_int4_service_transcribes(self):
        params = init_params(CFG, seed=0)
        svc = TranscriptionService(
            params,
            CFG,
            batch_size=2,
            max_wait_ms=30.0,
            language="en",
            bf16=False,
            quant_bits=4,
        )
        try:
            blk = svc.params["decoder"]["blocks"][0]["attn"]["query"]
            assert "w_q4" in blk and "w" not in blk
            result = svc.transcribe(np.zeros(16000, np.float32), timeout=600)
            assert "text" in result
        finally:
            svc.close()


class TestSpeculativeService:
    def test_draft_service_matches_plain(self):
        params = init_params(CFG, seed=0)
        draft = init_params(CFG, seed=9)
        audio = np.random.default_rng(0).standard_normal(16000).astype(
            np.float32
        ) * 0.1
        plain = TranscriptionService(
            params, CFG, batch_size=2, language="en", bf16=False
        )
        try:
            ref = plain.transcribe(audio, timeout=600)
        finally:
            plain.close()
        spec = TranscriptionService(
            params, CFG, batch_size=2, language="en", bf16=False,
            draft_params=draft, draft_cfg=CFG, draft_k=2,
        )
        try:
            out = spec.transcribe(audio, timeout=600)
        finally:
            spec.close()
        assert out["text"] == ref["text"]

    def test_medusa_tree_service_matches_plain(self):
        from whisper_ipa.models.medusa import init_medusa_params

        params = init_params(CFG, seed=0)
        heads = init_medusa_params(CFG, n_heads=2, seed=3)
        audio = np.random.default_rng(1).standard_normal(16000).astype(
            np.float32
        ) * 0.1
        plain = TranscriptionService(
            params, CFG, batch_size=2, language="en", bf16=False
        )
        try:
            ref = plain.transcribe(audio, timeout=600)
        finally:
            plain.close()
        tree = TranscriptionService(
            params, CFG, batch_size=2, language="en", bf16=False,
            medusa_params=heads,
            medusa_tree=((-1, 0), (-1, 1), (0, 0)),
        )
        try:
            out = tree.transcribe(audio, timeout=600)
        finally:
            tree.close()
        assert out["text"] == ref["text"]

    def test_draft_excludes_beam(self):
        params = init_params(CFG, seed=0)
        with pytest.raises(ValueError):
            TranscriptionService(
                params, CFG, beam_size=2,
                draft_params=params, draft_cfg=CFG,
            )


class TestShardedService:
    """Multi-chip serving over the virtual 8-device mesh (GSPMD)."""

    def test_dp_tp_service_matches_single_device(self):
        from whisper_ipa.parallel.mesh import make_mesh

        params = init_params(CFG, seed=0)
        audio = (
            np.random.default_rng(11)
            .standard_normal(16000)
            .astype(np.float32)
            * 0.1
        )
        plain = TranscriptionService(
            params, CFG, batch_size=4, max_wait_ms=10.0,
            language="en", bf16=False,
        )
        try:
            want = plain.transcribe(audio, timeout=600)
        finally:
            plain.close()

        mesh = make_mesh(data=2, model=2)
        svc = TranscriptionService(
            params, CFG, batch_size=4, max_wait_ms=10.0,
            language="en", bf16=False,
            mesh=mesh, tensor_parallel=True,
        )
        try:
            got = svc.transcribe(audio, timeout=600)
        finally:
            svc.close()
        assert got["text"] == want["text"]
        assert [s["text"] for s in got["segments"]] == [
            s["text"] for s in want["segments"]
        ]

    def test_batch_must_divide_data_axis(self):
        from whisper_ipa.parallel.mesh import make_mesh

        params = init_params(CFG, seed=0)
        mesh = make_mesh(data=4, model=2)
        with pytest.raises(ValueError, match="divisible"):
            TranscriptionService(
                params, CFG, batch_size=3, language="en", mesh=mesh,
            )

    def test_tp_excludes_quantization(self):
        from whisper_ipa.parallel.mesh import make_mesh

        params = init_params(CFG, seed=0)
        mesh = make_mesh(data=2, model=2)
        with pytest.raises(ValueError, match="tensor_parallel"):
            TranscriptionService(
                params, CFG, batch_size=4, language="en",
                mesh=mesh, tensor_parallel=True, quant_bits=8,
            )


class TestShardedQuantizedService:
    def test_dp_service_with_int8_weights(self):
        """Data-parallel serving composes with weight-only quantization
        (params replicated over the mesh, batches sharded)."""
        from whisper_ipa.parallel.mesh import make_mesh

        params = init_params(CFG, seed=0)
        audio = (
            np.random.default_rng(13)
            .standard_normal(16000)
            .astype(np.float32)
            * 0.1
        )
        mesh = make_mesh(data=4, model=1)
        svc = TranscriptionService(
            params, CFG, batch_size=4, max_wait_ms=10.0,
            language="en", bf16=False, mesh=mesh, quant_bits=8,
        )
        try:
            got = svc.transcribe(audio, timeout=600)
        finally:
            svc.close()
        assert "text" in got and len(got["segments"]) == 1

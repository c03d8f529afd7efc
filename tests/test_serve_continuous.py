"""Continuous (in-flight) batching engine tests.

The load-bearing invariant: a request that joins a RUNNING batch decodes
exactly the same tokens as a standalone greedy decode — joins re-feed
active slots' frontier tokens (identical-KV rewrites) and never disturb
them.
"""

import time
from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.models import init_params
from whisper_ipa.serve_continuous import ContinuousBatcher
from whisper_ipa.tokenizer import get_tokenizer

# full 30 s audio window contract, tiny transformer dims (fast CPU compile)
CFG = replace(
    CONFIGS["test-tiny"],
    n_audio_state=32,
    n_audio_head=2,
    n_audio_layer=1,
    n_text_state=32,
    n_text_head=2,
    n_text_layer=1,
    n_text_ctx=24,
)
MAX_NEW = 8


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def tok():
    return get_tokenizer(multilingual=True, language="en")


@pytest.fixture(scope="module")
def engine(params, tok):
    eng = ContinuousBatcher(
        params,
        CFG,
        slots=2,
        max_new_tokens=MAX_NEW,
        steps_per_sync=2,
        language="en",
        tokenizer=tok,
    )
    yield eng
    eng.close()


def reference_tokens(params, audio, tok):
    """Standalone greedy decode of the same 30 s window."""
    from whisper_ipa.audio import log_mel_spectrogram, pad_or_trim

    mel = log_mel_spectrogram(
        pad_or_trim(np.asarray(audio, np.float32)), n_mels=CFG.n_mels
    )
    res = decode(
        params,
        CFG,
        jnp.asarray(mel)[None],
        DecodingOptions(
            language="en", without_timestamps=True, sample_len=MAX_NEW
        ),
        tokenizer=tok,
    )
    return res[0].tokens


def test_single_request_matches_plain_greedy(engine, params, tok):
    audio = (
        np.random.default_rng(0).standard_normal(16000).astype(np.float32)
        * 0.1
    )
    out = engine.transcribe(audio, timeout=600)
    assert out["tokens"] == reference_tokens(params, audio, tok)
    assert out["latency_sec"] > 0
    # TTFT: first token visible on host after submission, before the end
    if out["tokens"]:
        assert 0 < out["ttft_sec"] <= out["latency_sec"]


def test_join_does_not_disturb_running_request(engine, params, tok):
    rng = np.random.default_rng(1)
    a1 = rng.standard_normal(16000).astype(np.float32) * 0.1
    a2 = rng.standard_normal(16000).astype(np.float32) * 0.1
    f1 = engine.submit(a1)
    time.sleep(0.05)  # let a1 start decoding before a2 joins
    f2 = engine.submit(a2)
    r1 = f1.result(timeout=600)
    r2 = f2.result(timeout=600)
    assert r1["tokens"] == reference_tokens(params, a1, tok)
    assert r2["tokens"] == reference_tokens(params, a2, tok)


def test_more_requests_than_slots(engine, params, tok):
    rng = np.random.default_rng(2)
    audios = [
        rng.standard_normal(16000).astype(np.float32) * 0.1
        for _ in range(5)
    ]
    futs = [engine.submit(a) for a in audios]
    results = [f.result(timeout=600) for f in futs]
    for a, r in zip(audios, results):
        assert r["tokens"] == reference_tokens(params, a, tok)
    assert engine.stats()["requests"] >= 5


def test_join_fast_sync_ab(params, tok):
    """The TTFT fast path (1-round chunk after a join) must be token-
    identical to the fixed-chunk engine and must actually fire."""
    rng = np.random.default_rng(7)
    audios = [
        rng.standard_normal(16000).astype(np.float32) * 0.1
        for _ in range(3)
    ]
    outs = {}
    for fast in (True, False):
        eng = ContinuousBatcher(
            params, CFG, slots=2, max_new_tokens=MAX_NEW,
            steps_per_sync=2, language="en", tokenizer=tok,
            join_fast_sync=fast,
        )
        try:
            futs = []
            for a in audios:
                futs.append(eng.submit(a))
                time.sleep(0.02)  # staggered: joins land mid-flight
            outs[fast] = [f.result(timeout=600)["tokens"] for f in futs]
            st = eng.stats()
            if fast:
                assert st["fast_chunks"] >= 1
            else:
                assert st["fast_chunks"] == 0
        finally:
            eng.close()
    assert outs[True] == outs[False]
    for a, t in zip(audios, outs[True]):
        assert t == reference_tokens(params, a, tok)


def test_prewarm_engine_matches_and_resets_stats(params, tok):
    """prewarm=True compiles every chunk variant (steps_per_sync AND the
    join_fast_sync rounds=1 program) in __init__ — the first request then
    decodes identically with zero phantom chunks in the stats."""
    audio = (
        np.random.default_rng(11).standard_normal(16000).astype(np.float32)
        * 0.1
    )
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en", tokenizer=tok, prewarm=True,
    )
    try:
        st0 = eng.stats()
        assert st0["chunks"] == 0 and st0["fast_chunks"] == 0
        out = eng.transcribe(audio, timeout=600)
        assert out["tokens"] == reference_tokens(params, audio, tok)
    finally:
        eng.close()


def test_token_streaming_callback(engine):
    audio = (
        np.random.default_rng(3).standard_normal(16000).astype(np.float32)
        * 0.1
    )
    seen = []
    out = engine.submit(audio, on_token=seen.append).result(timeout=600)
    assert [s["token"] for s in seen] == out["tokens"]
    if seen:
        assert seen[-1]["text_so_far"] == out["text"]


def test_http_server_over_continuous_engine(engine):
    """cli.serve --continuous: the HTTP handler drives the engine,
    including NDJSON token streaming via the on_partial alias."""
    import io
    import json as _json
    import threading
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    from whisper_ipa.cli.serve import make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(
                (
                    np.random.default_rng(4)
                    .standard_normal(8000) * 3000
                )
                .astype(np.int16)
                .tobytes()
            )
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe",
            data=buf.getvalue(),
            headers={"Content-Type": "audio/wav"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            payload = _json.loads(r.read())
        assert "text" in payload and "tokens" in payload

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe_stream",
            data=buf.getvalue(),
            headers={"Content-Type": "audio/wav"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            lines = [
                _json.loads(ln) for ln in r.read().splitlines() if ln
            ]
        assert "final" in lines[-1]
        partials = [ln for ln in lines if "partial" in ln]
        if payload["tokens"]:
            assert partials  # one NDJSON line per decoded token
            assert "token" in partials[0]["partial"]
    finally:
        server.shutdown()


def test_long_audio_chains_windows(engine, params, tok):
    """Audio longer than 30 s decodes window-by-window in the engine,
    matching per-window standalone greedy decodes."""
    from whisper_ipa.audio import N_SAMPLES

    rng = np.random.default_rng(5)
    audio = rng.standard_normal(N_SAMPLES + 16000).astype(np.float32) * 0.1
    out = engine.transcribe(audio, timeout=600)
    assert out["n_windows"] == 2
    w0 = reference_tokens(params, audio[:N_SAMPLES], tok)
    w1 = reference_tokens(params, audio[N_SAMPLES:], tok)
    assert out["tokens"] == w0 + w1


@pytest.fixture(scope="module")
def spec_engine(params, tok):
    """Engine with in-flight n-gram speculation (draft_k=3)."""
    eng = ContinuousBatcher(
        params,
        CFG,
        slots=2,
        max_new_tokens=MAX_NEW,
        steps_per_sync=2,
        language="en",
        draft_k=3,
        tokenizer=tok,
    )
    yield eng
    eng.close()


def test_speculative_engine_matches_plain_greedy(spec_engine, params, tok):
    """draft_k > 0 changes the schedule (1..K+1 tokens per device round),
    never the tokens: output is identical to standalone greedy decode."""
    audio = (
        np.random.default_rng(6).standard_normal(16000).astype(np.float32)
        * 0.1
    )
    out = spec_engine.transcribe(audio, timeout=600)
    assert out["tokens"] == reference_tokens(params, audio, tok)
    st = spec_engine.stats()
    assert st["spec_rounds"] > 0
    # every round emits at least the correction token for active slots
    assert st["spec_emitted"] >= len(out["tokens"])


def test_speculative_engine_join_and_streaming(spec_engine, params, tok):
    rng = np.random.default_rng(7)
    a1 = rng.standard_normal(16000).astype(np.float32) * 0.1
    a2 = rng.standard_normal(16000).astype(np.float32) * 0.1
    seen = []
    f1 = spec_engine.submit(a1, on_token=seen.append)
    time.sleep(0.02)
    f2 = spec_engine.submit(a2)
    r1 = f1.result(timeout=600)
    r2 = f2.result(timeout=600)
    assert r1["tokens"] == reference_tokens(params, a1, tok)
    assert r2["tokens"] == reference_tokens(params, a2, tok)
    assert [s["token"] for s in seen] == r1["tokens"]


def test_speculative_engine_long_audio(spec_engine, params, tok):
    """Window chaining works under in-flight speculation too."""
    from whisper_ipa.audio import N_SAMPLES

    rng = np.random.default_rng(8)
    audio = rng.standard_normal(N_SAMPLES + 16000).astype(np.float32) * 0.1
    out = spec_engine.transcribe(audio, timeout=900)
    assert out["n_windows"] == 2
    w0 = reference_tokens(params, audio[:N_SAMPLES], tok)
    w1 = reference_tokens(params, audio[N_SAMPLES:], tok)
    assert out["tokens"] == w0 + w1


def test_model_draft_engine_matches_plain_greedy(params, tok):
    """In-flight MODEL-draft speculation (persistent draft KV caches):
    an UNRELATED random draft (near-zero acceptance, the worst case)
    must still yield token-identical output to standalone greedy."""
    draft_params = init_params(CFG, seed=9)
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en", draft_k=3,
        draft_params=draft_params, draft_cfg=CFG, tokenizer=tok,
    )
    try:
        rng = np.random.default_rng(10)
        a1 = rng.standard_normal(16000).astype(np.float32) * 0.1
        a2 = rng.standard_normal(16000).astype(np.float32) * 0.1
        f1 = eng.submit(a1)
        time.sleep(0.02)  # a2 joins the running batch
        f2 = eng.submit(a2)
        r1 = f1.result(timeout=600)
        r2 = f2.result(timeout=600)
        assert r1["tokens"] == reference_tokens(params, a1, tok)
        assert r2["tokens"] == reference_tokens(params, a2, tok)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


def test_model_draft_engine_self_draft_accepts_fully(params, tok):
    """Draft == target: every draft token verifies, so each round
    advances K+1 tokens (where budget allows) and output is unchanged —
    the acceptance ceiling of the persistent-draft path."""
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en", draft_k=3,
        draft_params=params, draft_cfg=CFG, tokenizer=tok,
    )
    try:
        audio = (
            np.random.default_rng(11)
            .standard_normal(16000)
            .astype(np.float32)
            * 0.1
        )
        out = eng.transcribe(audio, timeout=600)
        assert out["tokens"] == reference_tokens(params, audio, tok)
        st = eng.stats()
        assert st["spec_rounds"] > 0
        # full acceptance: K+1 = 4 tokens/round, so the 8-token budget
        # clears in <= 2 rounds = one 2-round chunk (plain greedy would
        # need 4 chunks); EOT can only shorten it further
        assert st["chunks"] <= 2
    finally:
        eng.close()


def test_medusa_engine_matches_plain_greedy(params, tok):
    """In-flight MEDUSA speculation: heads draft in one shot from the
    frontier hidden state (no draft model). Fresh heads (zero-init
    residual -> near-base-head proposals) must still yield
    token-identical output to standalone greedy, including a mid-flight
    join whose frontier hidden is refreshed by _join_step_hidden."""
    from whisper_ipa.models.medusa import init_medusa_params

    medusa_params = init_medusa_params(CFG, n_heads=3, seed=1)
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en",
        medusa_params=medusa_params, tokenizer=tok,
    )
    try:
        assert eng.draft_k == 3  # taken from the head count
        rng = np.random.default_rng(12)
        a1 = rng.standard_normal(16000).astype(np.float32) * 0.1
        a2 = rng.standard_normal(16000).astype(np.float32) * 0.1
        f1 = eng.submit(a1)
        time.sleep(0.02)  # a2 joins the running batch
        f2 = eng.submit(a2)
        r1 = f1.result(timeout=600)
        r2 = f2.result(timeout=600)
        assert r1["tokens"] == reference_tokens(params, a1, tok)
        assert r2["tokens"] == reference_tokens(params, a2, tok)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


def test_medusa_tree_engine_matches_plain_greedy(params, tok):
    """In-flight TREE-medusa: per-round re-feed + tree verification per
    slot. Output must be token-identical to standalone greedy, including
    a mid-flight join."""
    from whisper_ipa.decode.medusa_tree import DEFAULT_TREE
    from whisper_ipa.models.medusa import init_medusa_params

    # DEFAULT_TREE depth 4 > n_prefix-2: exercises the widened tree-mode
    # join (_join_step_tree, W = K+2 = 6 > n_prefix = 4)
    medusa_params = init_medusa_params(CFG, n_heads=4, seed=2)
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en",
        medusa_params=medusa_params, medusa_tree=DEFAULT_TREE,
        tokenizer=tok,
    )
    try:
        rng = np.random.default_rng(13)
        a1 = rng.standard_normal(16000).astype(np.float32) * 0.1
        a2 = rng.standard_normal(16000).astype(np.float32) * 0.1
        f1 = eng.submit(a1)
        time.sleep(0.02)
        f2 = eng.submit(a2)
        r1 = f1.result(timeout=600)
        r2 = f2.result(timeout=600)
        assert r1["tokens"] == reference_tokens(params, a1, tok)
        assert r2["tokens"] == reference_tokens(params, a2, tok)
        assert eng.stats()["spec_rounds"] > 0
    finally:
        eng.close()


def test_medusa_excludes_draft_model(params, tok):
    from whisper_ipa.models.medusa import init_medusa_params

    with pytest.raises(ValueError):
        ContinuousBatcher(
            params, CFG, slots=2,
            medusa_params=init_medusa_params(CFG, n_heads=2, seed=0),
            draft_params=params, draft_cfg=CFG, draft_k=2, tokenizer=tok,
        )


def test_int8_kv_engine_matches_plain_greedy(params, tok):
    """Engine with the int8 cross-KV cache (serving default elsewhere):
    joins/scatter work in the T-minor quantized layout."""
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=MAX_NEW,
        steps_per_sync=2, language="en", kv_int8=True, tokenizer=tok,
    )
    try:
        audio = (
            np.random.default_rng(9).standard_normal(16000)
            .astype(np.float32) * 0.1
        )
        out = eng.transcribe(audio, timeout=900)
        # int8 KV quantization may flip borderline tokens at tiny scale;
        # the load-bearing assertions are mechanical correctness + the
        # first token (most separated logits)
        ref = reference_tokens(params, audio, tok)
        assert len(out["tokens"]) > 0
        assert out["tokens"][0] == ref[0]
    finally:
        eng.close()


def test_engine_fuzz_mixed_arrivals(engine, params, tok):
    """Soak: mixed-length audio under random arrival jitter — every
    request must match its standalone per-window greedy decode."""
    from whisper_ipa.audio import N_SAMPLES

    rng = np.random.default_rng(14)
    audios = []
    for i in range(6):
        n = int(rng.integers(8000, N_SAMPLES + 24000))
        audios.append(rng.standard_normal(n).astype(np.float32) * 0.1)
    futs = []
    for a in audios:
        futs.append(engine.submit(a))
        time.sleep(float(rng.uniform(0, 0.03)))
    results = [f.result(timeout=900) for f in futs]
    for a, r in zip(audios, results):
        want = []
        for s in range(0, len(a), N_SAMPLES):
            want.extend(reference_tokens(params, a[s : s + N_SAMPLES], tok))
        assert r["tokens"] == want


def test_device_budget_freeze_truncates_exactly(params, tok):
    """Regression (r3 advisor): the plain-greedy engine must enforce
    max_new ON DEVICE. With steps_per_sync > max_new, one chunk used to
    advance lens past the cache end (start-clamped KV writes corrupted
    the frontier row) and the host appended the over-budget tokens."""
    eng = ContinuousBatcher(
        params, CFG, slots=2, max_new_tokens=3,
        steps_per_sync=6, language="en", tokenizer=tok,
    )
    try:
        audio = (
            np.random.default_rng(0).standard_normal(16000)
            .astype(np.float32) * 0.1
        )
        ref = reference_tokens(params, audio, tok)  # sample_len=8 decode
        out = eng.transcribe(audio, timeout=900)
        assert out["tokens"] == ref[: 3]
        assert out["truncated"] == (len(ref) > 3)
    finally:
        eng.close()


def test_dp_sharded_engine_matches_plain_greedy(params, tok):
    """Engine with its SLOT axis sharded over the mesh 'data' axis
    (multi-chip serving): same tokens as the standalone greedy decode,
    and the persistent state STAYS sharded across joins/chunks/retires
    (no silent re-replication of the KV cache)."""
    from whisper_ipa.parallel import make_mesh

    mesh = make_mesh()  # 8 virtual devices
    eng = ContinuousBatcher(
        params,
        CFG,
        slots=8,
        max_new_tokens=MAX_NEW,
        steps_per_sync=2,
        language="en",
        tokenizer=tok,
        mesh=mesh,
    )
    try:
        rng = np.random.default_rng(7)
        audios = [
            rng.standard_normal(16000).astype(np.float32) * 0.1
            for _ in range(4)
        ]
        futs = [eng.submit(a) for a in audios]
        results = [f.result(timeout=600) for f in futs]
        for a, r in zip(audios, results):
            assert r["tokens"] == reference_tokens(params, a, tok)
        import jax

        for leaf in jax.tree.leaves(eng.cache):
            assert "data" in tuple(leaf.sharding.spec), (
                f"cache leaf lost its slot sharding: {leaf.sharding}"
            )
        assert "data" in tuple(eng.lens.sharding.spec)
    finally:
        eng.close()


def test_dp_engine_rejects_indivisible_slots(params, tok):
    from whisper_ipa.parallel import make_mesh

    with pytest.raises(ValueError, match="divide"):
        ContinuousBatcher(
            params, CFG, slots=6, max_new_tokens=MAX_NEW,
            tokenizer=tok, mesh=make_mesh(),
        )


def test_max_pending_backpressure(engine):
    """submit() rejects with EngineOverloaded at the queue bound and the
    HTTP layer maps it to 503 (production load shedding)."""
    from whisper_ipa.serve_continuous import EngineOverloaded

    audio = np.zeros(8000, np.float32)
    engine.max_pending = 0  # every submit sees a "full" queue
    try:
        with pytest.raises(EngineOverloaded):
            engine.submit(audio)
        assert engine.stats()["rejected"] >= 1
    finally:
        engine.max_pending = None


def test_cancel_queued_request(engine, params, tok):
    """A cancelled Future never occupies a slot; the engine keeps
    serving everyone else correctly."""
    rng = np.random.default_rng(21)
    audio = rng.standard_normal(16000).astype(np.float32) * 0.1
    fut = engine.submit(np.zeros(16000, np.float32))
    assert fut.cancel()
    out = engine.transcribe(audio, timeout=600)  # engine still healthy
    assert out["tokens"] == reference_tokens(params, audio, tok)
    assert engine.stats()["cancelled"] >= 1
    with pytest.raises(Exception):
        fut.result(timeout=0)


def test_expired_deadline_resolves_before_decode(engine):
    """A request whose deadline passed while queued resolves with
    timed_out=True and an empty transcript — it never pays the encode."""
    audio = np.zeros(16000, np.float32)
    out = engine.submit(audio, deadline_sec=0).result(timeout=600)
    assert out["timed_out"] is True
    assert out["tokens"] == []
    assert out["queue_sec"] is None  # never started
    assert engine.stats()["timed_out"] >= 1


def test_inflight_deadline_returns_partial(engine, params, tok):
    """A deadline that expires MID-DECODE resolves at the next sync with
    the tokens decoded so far (partial transcript, timed_out flag)."""
    import time as _time

    rng = np.random.default_rng(22)
    audio = rng.standard_normal(16000).astype(np.float32) * 0.1
    ref = reference_tokens(params, audio, tok)
    fut = engine.submit(audio, deadline_sec=3600)
    # wait for admission, then pull the deadline into the past
    deadline = _time.time() + 120
    hit = False
    while _time.time() < deadline:
        for s in engine._slots:
            if s is not None and s.deadline is not None:
                s.deadline = 0.0
                hit = True
                break
        if hit or fut.done():
            break
        _time.sleep(0.001)
    out = fut.result(timeout=600)
    if out["timed_out"]:
        # partial: a prefix of the reference tokens
        assert out["tokens"] == ref[: len(out["tokens"])]
    else:
        # raced to completion before the reaper saw it — still exact
        assert out["tokens"] == ref
    # engine remains healthy for the next request
    audio2 = rng.standard_normal(16000).astype(np.float32) * 0.1
    out2 = engine.transcribe(audio2, timeout=600)
    assert out2["tokens"] == reference_tokens(params, audio2, tok)


def test_queued_deadline_resolves_while_slots_full(engine, params, tok):
    """An expired queued request resolves promptly even when every slot
    is busy (the _reap queue sweep — without it the client would wait
    for a slot to free, the unbounded latency deadlines must prevent).
    Long-audio requests keep both slots occupied across windows."""
    from whisper_ipa.audio import N_SAMPLES

    rng = np.random.default_rng(23)
    n = N_SAMPLES + 16000  # 31 s -> 2 windows per request
    long1 = rng.standard_normal(n).astype(np.float32) * 0.1
    long2 = rng.standard_normal(n).astype(np.float32) * 0.1
    f1 = engine.submit(long1)
    f2 = engine.submit(long2)
    fq = engine.submit(np.zeros(16000, np.float32), deadline_sec=0)
    out = fq.result(timeout=120)  # resolves while f1/f2 still decode
    assert out["timed_out"] is True and out["tokens"] == []
    # the engine finishes the real requests untouched
    assert f1.result(timeout=600)["n_windows"] == 2
    assert f2.result(timeout=600)["n_windows"] == 2


def test_tp_sharded_engine_matches_plain_greedy(params, tok):
    """Engine with Megatron-TP weights (mesh 'model' axis): the KV
    caches inherit the head-axis sharding from the projections and the
    output stays token-identical — serving models too big for one chip."""
    import jax

    from whisper_ipa.parallel import make_mesh

    mesh = make_mesh(model=2, devices=jax.devices()[:2])  # data=1 x tp=2
    eng = ContinuousBatcher(
        params,
        CFG,
        slots=2,
        max_new_tokens=MAX_NEW,
        steps_per_sync=2,
        language="en",
        tokenizer=tok,
        mesh=mesh,
        tensor_parallel=True,
    )
    try:
        rng = np.random.default_rng(31)
        audios = [
            rng.standard_normal(16000).astype(np.float32) * 0.1
            for _ in range(3)
        ]
        futs = [eng.submit(a) for a in audios]
        for a, f in zip(audios, futs):
            assert f.result(timeout=600)["tokens"] == reference_tokens(
                params, a, tok
            )
        # the weights are actually sharded (not silently replicated)
        q = eng.params["decoder"]["blocks"][0]["attn"]["query"]["w"]
        assert "model" in tuple(q.sharding.spec)
    finally:
        eng.close()


def test_dp_tp_sharded_engine_matches_plain_greedy(params, tok):
    """dp x tp engine: slot axis over 'data', weights over 'model'."""
    from whisper_ipa.parallel import make_mesh

    mesh = make_mesh(model=2)  # data=4 x model=2 on the virtual 8
    eng = ContinuousBatcher(
        params,
        CFG,
        slots=4,
        max_new_tokens=MAX_NEW,
        steps_per_sync=2,
        language="en",
        tokenizer=tok,
        mesh=mesh,
        tensor_parallel=True,
    )
    try:
        rng = np.random.default_rng(32)
        audios = [
            rng.standard_normal(16000).astype(np.float32) * 0.1
            for _ in range(4)
        ]
        futs = [eng.submit(a) for a in audios]
        for a, f in zip(audios, futs):
            assert f.result(timeout=600)["tokens"] == reference_tokens(
                params, a, tok
            )
        import jax

        # both axes live on the persistent cache
        specs = [
            tuple(x.sharding.spec) for x in jax.tree.leaves(eng.cache)
        ]
        assert any("data" in s for s in specs)
        assert any("model" in s for s in specs)
    finally:
        eng.close()


def test_adaptive_sync_matches_and_fires(params, tok):
    """adaptive_sync long chunks must be token-identical to the fixed
    engine (the on-device early exit changes nothing but wall time) and
    must actually take long chunks when the queue is empty."""
    rng = np.random.default_rng(13)
    audios = [
        rng.standard_normal(16000).astype(np.float32) * 0.1
        for _ in range(3)
    ]
    outs = {}
    for adaptive in (True, False):
        eng = ContinuousBatcher(
            params, CFG, slots=2, max_new_tokens=MAX_NEW,
            steps_per_sync=2, language="en", tokenizer=tok,
            adaptive_sync=adaptive,
        )
        try:
            futs = [eng.submit(a) for a in audios]
            outs[adaptive] = [f.result(timeout=600)["tokens"] for f in futs]
            if adaptive:
                assert eng.stats()["long_chunks"] >= 1
        finally:
            eng.close()
    assert outs[True] == outs[False]
    for a, t in zip(audios, outs[True]):
        assert t == reference_tokens(params, a, tok)

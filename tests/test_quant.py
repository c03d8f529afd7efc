"""Weight-only int8 quantization tests."""

from dataclasses import replace

import numpy as np
import pytest

import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.decode import DecodingOptions, decode
from whisper_ipa.models import init_params
from whisper_ipa.models.layers import linear
from whisper_ipa.models.whisper import decoder_logits, encode
from whisper_ipa.ops.quant import (
    quantize_linear,
    quantize_params,
    quantized_bytes,
)
from whisper_ipa.tokenizer import get_tokenizer

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)


class TestQuantizeLinear:
    def test_roundtrip_error_bounded(self):
        rng = np.random.default_rng(0)
        w = rng.standard_normal((64, 128)).astype(np.float32)
        p = {"w": w, "b": np.zeros(128, np.float32)}
        q = quantize_linear(p)
        assert q["w_q"].dtype == jnp.int8
        deq = np.asarray(q["w_q"], np.float32) * np.asarray(q["w_s"])
        # per-channel symmetric int8: max error is s/2 = max|w|/254
        max_err = np.abs(deq - w).max(axis=0)
        bound = np.abs(w).max(axis=0) / 127.0
        assert (max_err <= bound * 0.5 + 1e-7).all()

    def test_linear_apply_matches(self):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((32, 48)).astype(np.float32)
        x = rng.standard_normal((4, 32)).astype(np.float32)
        p = {"w": jnp.asarray(w), "b": jnp.zeros(48)}
        q = quantize_linear(p)
        y_full = np.asarray(linear(jnp.asarray(x), p))
        y_quant = np.asarray(linear(jnp.asarray(x), q))
        rel = np.abs(y_quant - y_full).max() / (np.abs(y_full).max() + 1e-9)
        assert rel < 0.02

    def test_zero_column_safe(self):
        p = {"w": np.zeros((8, 4), np.float32)}
        q = quantize_linear(p)
        assert np.isfinite(np.asarray(q["w_s"])).all()


class TestQuantizedModel:
    @pytest.fixture(scope="class")
    def params(self):
        return init_params(CFG, seed=0)

    @pytest.fixture(scope="class")
    def qparams(self, params):
        return quantize_params(params)

    def test_size_reduction(self, params, qparams):
        # compare the transformer blocks (the toy config's embedding table
        # dwarfs its 2 layers; real models are block-dominated)
        full = quantized_bytes(params["decoder"]["blocks"])
        quant = quantized_bytes(qparams["decoder"]["blocks"])
        assert quant < full * 0.35  # int8 + scales vs float32

    def test_forward_close(self, params, qparams):
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        tokens = jnp.asarray([[50258, 50259, 50359, 50363]])
        feats_f = encode(params, CFG, mel)
        feats_q = encode(qparams, CFG, mel)
        lf = np.asarray(decoder_logits(params, CFG, tokens, feats_f))
        lq = np.asarray(decoder_logits(qparams, CFG, tokens, feats_q))
        rel = np.abs(lq - lf).max() / (np.abs(lf).max() + 1e-9)
        assert rel < 0.1

    def test_quantized_decode_runs(self, qparams):
        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        results = decode(
            qparams,
            CFG,
            mel,
            DecodingOptions(
                language="en", without_timestamps=True, sample_len=4
            ),
            tokenizer=tok,
        )
        assert len(results) == 1
        assert np.isfinite(results[0].avg_logprob)


class TestInt4:
    def test_pack_unpack_roundtrip(self):
        from whisper_ipa.models.layers import _unpack_int4
        from whisper_ipa.ops.quant import pack_int4

        rng = np.random.default_rng(0)
        q = rng.integers(-8, 8, size=(64, 48)).astype(np.int8)
        packed = pack_int4(q)
        assert packed.shape == (32, 48)
        s = jnp.ones((1, 48), jnp.float32)  # identity scales, one group
        w = np.asarray(_unpack_int4(jnp.asarray(packed), s, jnp.float32))
        np.testing.assert_array_equal(w, q.astype(np.float32))

    def test_roundtrip_error_bounded(self):
        from whisper_ipa.ops.quant import quantize_linear_int4

        rng = np.random.default_rng(1)
        w = rng.standard_normal((128, 96)).astype(np.float32)
        p = {"w": w, "b": np.zeros(96, np.float32)}
        q = quantize_linear_int4(p, group=64)
        assert q["w_q4"].shape == (64, 96)
        assert q["w_s4"].shape == (2, 96)
        from whisper_ipa.models.layers import _unpack_int4

        deq = np.asarray(
            _unpack_int4(q["w_q4"], q["w_s4"], jnp.float32)
        )
        # per-group symmetric int4: max error is s/2 = groupmax/14
        err = np.abs(deq - w).reshape(2, 64, 96).max(axis=1)
        bound = np.abs(w).reshape(2, 64, 96).max(axis=1) / 7.0
        assert (err <= bound * 0.5 + 1e-6).all()

    def test_linear_apply_close(self):
        from whisper_ipa.models.layers import linear
        from whisper_ipa.ops.quant import quantize_linear_int4

        rng = np.random.default_rng(2)
        w = rng.standard_normal((128, 64)).astype(np.float32)
        x = rng.standard_normal((4, 128)).astype(np.float32)
        p = {"w": jnp.asarray(w), "b": jnp.zeros(64)}
        q = quantize_linear_int4(p, group=64)
        y_full = np.asarray(linear(jnp.asarray(x), p))
        y_q = np.asarray(linear(jnp.asarray(x), q))
        rel = np.abs(y_q - y_full).max() / (np.abs(y_full).max() + 1e-9)
        assert rel < 0.12  # 4-bit: ~5x coarser than int8

    def test_stochastic_rounding_unbiased(self):
        from whisper_ipa.models.layers import _unpack_int4
        from whisper_ipa.ops.quant import quantize_linear_int4

        # constant 0.25-of-a-step offsets: nearest rounding is biased by
        # exactly -0.25 steps, stochastic rounding's bias -> 0
        w = np.full((2048, 8), 1.0, np.float32)
        w[0] = 7.0  # pins the group scale to 1.0
        w[1:] = 2.25
        p = {"w": w}
        deq_sr = np.asarray(
            _unpack_int4(
                *[
                    quantize_linear_int4(p, group=2048, stochastic=True,
                                         seed=5)[k]
                    for k in ("w_q4", "w_s4")
                ],
                jnp.float32,
            )
        )
        mean_sr = deq_sr[1:].mean()
        deq_rn = np.asarray(
            _unpack_int4(
                *[
                    quantize_linear_int4(p, group=2048)[k]
                    for k in ("w_q4", "w_s4")
                ],
                jnp.float32,
            )
        )
        mean_rn = deq_rn[1:].mean()
        assert abs(mean_sr - 2.25) < 0.03  # unbiased
        assert abs(mean_rn - 2.25) > 0.2  # nearest rounds all to 2.0

    def test_int4_model_decode_runs(self):
        from whisper_ipa.ops.quant import quantize_params, quantized_bytes

        params = init_params(CFG, seed=0)
        q4 = quantize_params(params, bits=4, group=64)
        q8 = quantize_params(params, bits=8)
        b4 = quantized_bytes(q4["decoder"]["blocks"])
        b8 = quantized_bytes(q8["decoder"]["blocks"])
        assert b4 < b8 * 0.7  # packed nibbles + group scales vs int8

        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        results = decode(
            q4,
            CFG,
            mel,
            DecodingOptions(
                language="en", without_timestamps=True, sample_len=4
            ),
            tokenizer=tok,
        )
        assert np.isfinite(results[0].avg_logprob)


class TestStochasticQuantDevice:
    def test_fallback_roundtrip_and_unbiased(self):
        from whisper_ipa.ops.sr_quant import stochastic_quantize_int8

        rng = np.random.default_rng(0)
        w = rng.standard_normal((256, 64)).astype(np.float32)
        q, s = stochastic_quantize_int8(jnp.asarray(w), seed=3)
        assert q.dtype == jnp.int8 and s.shape == (64,)
        deq = np.asarray(q, np.float32) * np.asarray(s)
        # SR error is bounded by one full step (not half)
        bound = np.abs(w).max(axis=0) / 127.0
        assert (np.abs(deq - w).max(axis=0) <= bound + 1e-6).all()
        # unbiasedness on quarter-step offsets
        w2 = np.full((4096, 8), 0.25, np.float32)
        w2[0] = 127.0  # scale = 1.0
        q2, s2 = stochastic_quantize_int8(jnp.asarray(w2), seed=11)
        deq2 = np.asarray(q2[1:], np.float32) * np.asarray(s2)
        assert abs(deq2.mean() - 0.25) < 0.02

    def test_quantize_params_device_layout(self):
        from whisper_ipa.ops.sr_quant import quantize_params_device

        params = init_params(CFG, seed=0)
        qp = quantize_params_device(params)
        blk = qp["decoder"]["blocks"][0]["attn"]["query"]
        assert "w_q" in blk and "w_s" in blk and "w" not in blk
        # consumable by the standard linear() path end-to-end
        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((1, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        results = decode(
            qp,
            CFG,
            mel,
            DecodingOptions(
                language="en", without_timestamps=True, sample_len=4
            ),
            tokenizer=tok,
        )
        assert np.isfinite(results[0].avg_logprob)


class TestInt4CrossKV:
    """Opt-in nibble-packed int4 cross-attention KV cache."""

    def _setup(self):
        from dataclasses import replace

        import jax.numpy as jnp

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)
        rng = np.random.default_rng(0)
        feats = jnp.asarray(
            rng.standard_normal((2, 32, cfg.n_audio_state)).astype(
                np.float32
            )
        )
        return cfg, params, feats

    def test_int4_attention_close_to_fp(self):
        """One cross-attention through the packed path vs the fp path."""
        import jax.numpy as jnp

        from whisper_ipa.models.layers import (
            multi_head_attention,
            multi_head_attention_int8kv,
        )
        from whisper_ipa.models.whisper import init_cache

        cfg, params, feats = self._setup()
        cache4 = init_cache(params, cfg, feats, max_len=8,
                            cross_kv_int4=True)
        cache_fp = init_cache(params, cfg, feats, max_len=8)
        rng = np.random.default_rng(1)
        q = jnp.asarray(
            rng.standard_normal((2, 1, cfg.n_text_state)).astype(np.float32)
        )
        ref = multi_head_attention(
            q, cache_fp.cross_k[0], cache_fp.cross_v[0], cfg.n_text_head
        )
        got = multi_head_attention_int8kv(
            q,
            cache4.cross_k[0],
            cache4.cross_k_scale[0],
            cache4.cross_v[0],
            cache4.cross_v_scale[0],
            cfg.n_text_head,
        )
        err = float(
            np.abs(np.asarray(got) - np.asarray(ref)).max()
            / np.abs(np.asarray(ref)).max()
        )
        assert err < 0.15, err  # int4 noise, bounded

    def test_int4_decode_runs_and_tracks_fp(self):
        """Full greedy decode with kv_int4: runs under jit and the first
        decoded token matches the fp path (weak but meaningful — the
        first step sees the most uniform logits)."""
        import jax.numpy as jnp

        from whisper_ipa.decode import DecodingOptions, decode
        from whisper_ipa.tokenizer import get_tokenizer

        cfg, params, _ = self._setup()
        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(2)
        mel = jnp.asarray(
            rng.standard_normal((2, 64, cfg.n_mels)).astype(np.float32)
        )
        fp = decode(
            params, cfg, mel,
            DecodingOptions(language="en", without_timestamps=True,
                            sample_len=4),
            tokenizer=tok,
        )
        q4 = decode(
            params, cfg, mel,
            DecodingOptions(language="en", without_timestamps=True,
                            sample_len=4, kv_int4=True),
            tokenizer=tok,
        )
        assert len(q4) == len(fp)
        assert [r.tokens[0] for r in q4] == [r.tokens[0] for r in fp]

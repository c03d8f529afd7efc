"""Model forward-pass tests: shapes, cache parity, checkpoint round-trips."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.config import CONFIGS, get_config, n_mels_for_model
from whisper_ipa.models import (
    decode_step,
    decoder_logits,
    encode,
    flatten_params,
    init_cache,
    init_params,
    load_checkpoint_model,
    overlay_decoder_weights,
    params_from_flat,
    save_safetensors,
    to_mlx_flat,
    unflatten_params,
)
from whisper_ipa.models.whisper import count_parameters

from dataclasses import replace

# tiny contexts: full architecture, fast compiles on the 1-CPU test host
CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
N_MEL_FRAMES = CFG.n_audio_ctx * 2


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def mel():
    rng = np.random.default_rng(0)
    return jnp.asarray(
        rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)
    )


class TestConfig:
    def test_registry(self):
        small = get_config("small")
        assert small.n_audio_state == 768
        assert small.n_text_layer == 12
        assert get_config("mlx-community/whisper-small-mlx").name == "small"
        assert get_config("openai/whisper-large-v3").n_mels == 128
        assert get_config("large-v3").n_vocab == 51866

    def test_n_mels_rule(self):
        assert n_mels_for_model("whisper-small") == 80
        assert n_mels_for_model("whisper-large-v3") == 128

    def test_decoder_param_count_small(self):
        # reference-measured: whisper-small decoder = 153,580,800 trainable
        # params (reference benchmark_models_simple.py:52)
        small = get_config("small")
        p = init_params(small, seed=0)
        n_dec = count_parameters(p["decoder"])
        assert n_dec == 153_580_800


class TestForward:
    def test_encode_shape(self, params, mel):
        feats = encode(params, CFG, mel)
        assert feats.shape == (2, CFG.n_audio_ctx, CFG.n_audio_state)
        assert np.isfinite(np.asarray(feats)).all()

    def test_decoder_logits_shape(self, params, mel):
        feats = encode(params, CFG, mel)
        tokens = jnp.array([[50258, 50259, 50359, 50363], [50258, 50259, 50359, 50363]])
        out = decoder_logits(params, CFG, tokens, feats)
        assert out.shape == (2, 4, CFG.n_vocab)

    def test_causality(self, params, mel):
        """Changing a later token must not affect earlier logits."""
        feats = encode(params, CFG, mel[:1])
        t1 = jnp.array([[50258, 50259, 50359, 50363]])
        t2 = jnp.array([[50258, 50259, 50359, 999]])
        l1 = decoder_logits(params, CFG, t1, feats)
        l2 = decoder_logits(params, CFG, t2, feats)
        np.testing.assert_allclose(
            np.asarray(l1[:, :3]), np.asarray(l2[:, :3]), atol=1e-5
        )
        assert not np.allclose(np.asarray(l1[:, 3]), np.asarray(l2[:, 3]))


class TestKVCache:
    def test_cached_matches_uncached(self, params, mel):
        """Incremental decode must reproduce teacher-forced logits."""
        feats = encode(params, CFG, mel)
        tokens = jnp.array(
            [[50258, 50259, 50359, 50363, 100, 200],
             [50258, 50259, 50359, 50363, 300, 400]]
        )
        full = decoder_logits(params, CFG, tokens, feats)

        cache = init_cache(params, CFG, feats, max_len=16)
        # feed the 4-token prefix at once, then one token at a time
        l_prefix, cache = decode_step(params, CFG, tokens[:, :4], cache, 0)
        np.testing.assert_allclose(
            np.asarray(l_prefix), np.asarray(full[:, :4]), atol=2e-2
        )
        l4, cache = decode_step(params, CFG, tokens[:, 4:5], cache, 4)
        l5, cache = decode_step(params, CFG, tokens[:, 5:6], cache, 5)
        np.testing.assert_allclose(
            np.asarray(l4[:, 0]), np.asarray(full[:, 4]), atol=2e-2
        )
        np.testing.assert_allclose(
            np.asarray(l5[:, 0]), np.asarray(full[:, 5]), atol=2e-2
        )

    def test_block_step_matches_multipos(self, params, mel):
        """decode_step_block with a causal mask, consecutive per-token
        positions, and a full write reduces exactly to
        decode_step_multipos (the tree-verification primitive's oracle)."""
        from whisper_ipa.models.whisper import (
            decode_step_block,
            decode_step_multipos_hidden,
        )

        feats = encode(params, CFG, mel)
        cache0 = init_cache(params, CFG, feats, max_len=16)
        prefix = jnp.array(
            [[50258, 50259, 50359, 50363], [50258, 50259, 50359, 50363]]
        )
        _, cache0 = decode_step(params, CFG, prefix, cache0, 0)

        B, S = 2, 3
        tokens = jnp.array([[100, 200, 300], [400, 500, 600]])
        pos_vec = jnp.array([4, 4], jnp.int32)

        l_ref, cache_ref, h_ref = decode_step_multipos_hidden(
            params, CFG, tokens, cache0, pos_vec
        )

        pos_tok = pos_vec[:, None] + jnp.arange(S)[None, :]
        blk = jnp.arange(S)
        causal = jnp.where(
            blk[None, :] <= blk[:, None], 0.0, -jnp.inf
        ).astype(jnp.float32)
        l_blk, cache_blk, h_blk = decode_step_block(
            params, CFG, tokens, cache0, pos_tok, pos_vec, causal,
            write_len=S,
        )
        np.testing.assert_allclose(
            np.asarray(l_blk), np.asarray(l_ref), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(h_blk), np.asarray(h_ref), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(cache_blk.self_k), np.asarray(cache_ref.self_k),
            atol=1e-4,
        )

    def test_jit_decode_step(self, params, mel):
        feats = encode(params, CFG, mel[:1])
        cache = init_cache(params, CFG, feats, max_len=8)
        step = jax.jit(
            lambda t, c, p: decode_step(params, CFG, t, c, p),
        )
        logits1, cache = step(jnp.array([[50258]]), cache, 0)
        logits2, cache = step(jnp.array([[100]]), cache, 1)
        assert logits1.shape == (1, 1, CFG.n_vocab)
        assert np.isfinite(np.asarray(logits2)).all()

    def test_cast_decoder_blocks(self, params, mel):
        """Hoisted bf16 pre-cast == linear()'s per-use cast, bit-exact.

        The decode loops cast the decoder block tree ONCE at the jitted
        entry (models/whisper.cast_decoder_blocks) instead of letting
        ``linear`` re-convert f32 weights per layer per token step; the
        logits must be identical because the same single f32->bf16
        rounding happens either way.
        """
        from whisper_ipa.models.whisper import cast_decoder_blocks
        from whisper_ipa.ops.quant import quantize_tree

        cast = cast_decoder_blocks(params, jnp.bfloat16)
        b0 = cast["decoder"]["blocks"][0]
        # matmul weights/biases go bf16; layernorm + embeddings stay f32
        assert b0["attn"]["query"]["w"].dtype == jnp.bfloat16
        assert b0["mlp1"]["b"].dtype == jnp.bfloat16
        assert b0["attn_ln"]["g"].dtype == jnp.float32
        assert cast["decoder"]["token_embedding"].dtype == jnp.float32
        # f32 request is a no-op (same object)
        assert cast_decoder_blocks(params, jnp.float32) is params
        # quantized leaves keep their stored dtypes
        qp = dict(params)
        qp["decoder"] = dict(params["decoder"])
        qp["decoder"]["blocks"] = [
            {
                k: (quantize_tree(v) if k == "mlp1" else v)
                for k, v in blk.items()
            }
            for blk in params["decoder"]["blocks"]
        ]
        qcast = cast_decoder_blocks(qp, jnp.bfloat16)
        assert qcast["decoder"]["blocks"][0]["mlp1"]["w_q"].dtype == jnp.int8
        assert (
            qcast["decoder"]["blocks"][0]["mlp1"]["w_s"].dtype
            == qp["decoder"]["blocks"][0]["mlp1"]["w_s"].dtype
        )

        # bit-exact logits: per-use cast (uncast params, bf16 activations)
        # vs hoisted pre-cast
        feats = encode(params, CFG, mel[:1])
        tokens = jnp.array([[50258, 50259, 50359, 50363]])
        cache_a = init_cache(
            params, CFG, feats, max_len=8, dtype=jnp.bfloat16
        )
        la, _ = decode_step(
            params, CFG, tokens, cache_a, 0, dtype=jnp.bfloat16
        )
        cache_b = init_cache(
            cast, CFG, feats, max_len=8, dtype=jnp.bfloat16
        )
        lb, _ = decode_step(
            cast, CFG, tokens, cache_b, 0, dtype=jnp.bfloat16
        )
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


class TestCheckpointInterop:
    def test_flatten_roundtrip(self, params):
        flat = flatten_params(params)
        tree = unflatten_params(flat)
        flat2 = flatten_params(tree)
        assert set(flat) == set(flat2)
        for k in flat:
            np.testing.assert_array_equal(np.asarray(flat[k]), np.asarray(flat2[k]))

    def test_mlx_names(self, params):
        mlx = to_mlx_flat(params)
        assert "decoder.token_embedding.weight" in mlx
        assert "decoder.positional_embedding" in mlx
        assert "encoder.blocks.0.attn.query.weight" in mlx
        assert "encoder.conv1.weight" in mlx
        # MLX layouts: linear (out, in); conv (O, W, I)
        assert mlx["decoder.blocks.0.attn.query.weight"].shape == (
            CFG.n_text_state,
            CFG.n_text_state,
        )
        assert mlx["encoder.conv1.weight"].shape == (
            CFG.n_audio_state,
            3,
            CFG.n_mels,
        )
        # key projection has no bias (Whisper convention)
        assert "encoder.blocks.0.attn.key.bias" not in mlx

    def test_safetensors_roundtrip(self, params, tmp_path):
        path = str(tmp_path / "model.safetensors")
        save_safetensors(path, params)
        from whisper_ipa.models import load_safetensors_flat

        flat = load_safetensors_flat(path)
        rebuilt = params_from_flat(flat, fmt="mlx")
        orig = flatten_params(params)
        new = flatten_params(rebuilt)
        assert set(orig) == set(new)
        for k in orig:
            np.testing.assert_allclose(
                np.asarray(orig[k]), np.asarray(new[k]), atol=0
            )

    def test_decoder_overlay(self, params, tmp_path, mel):
        """Reference contract: only decoder.* keys are overlaid."""
        trained = init_params(CFG, seed=1)
        path = str(tmp_path / "ckpt")
        import os

        os.makedirs(path, exist_ok=True)
        save_safetensors(os.path.join(path, "model.safetensors"), trained)

        merged, n_loaded = load_checkpoint_model(path, params)
        assert n_loaded > 0
        mf = flatten_params(merged)
        tf = flatten_params(trained)
        pf = flatten_params(params)
        # decoder weights come from the checkpoint
        np.testing.assert_array_equal(
            np.asarray(mf["decoder.token_embedding"]),
            np.asarray(tf["decoder.token_embedding"]),
        )
        # encoder weights stay from the base model
        np.testing.assert_array_equal(
            np.asarray(mf["encoder.conv1.w"]), np.asarray(pf["encoder.conv1.w"])
        )

    def test_full_overlay(self, params, tmp_path, mel):
        """full=True overlays the ENCODER too — the load path for
        checkpoints from full fine-tunes (train --unfreeze-encoder),
        where the decoder-only contract would hide a random encoder."""
        trained = init_params(CFG, seed=1)
        path = str(tmp_path / "ckpt_full")
        import os

        os.makedirs(path, exist_ok=True)
        save_safetensors(os.path.join(path, "model.safetensors"), trained)

        merged, n_full = load_checkpoint_model(path, params, full=True)
        _, n_dec = load_checkpoint_model(path, params)
        assert n_full > n_dec
        mf = flatten_params(merged)
        tf = flatten_params(trained)
        np.testing.assert_array_equal(
            np.asarray(mf["encoder.conv1.w"]),
            np.asarray(tf["encoder.conv1.w"]),
        )
        np.testing.assert_array_equal(
            np.asarray(mf["decoder.token_embedding"]),
            np.asarray(tf["decoder.token_embedding"]),
        )

    def test_auto_overlay_mode(self, params, tmp_path):
        """load_checkpoint_auto reads freeze_encoder from the run's
        training_config.json: full-fine-tune runs get the full overlay,
        frozen/metadata-less runs keep the decoder-only contract."""
        import json
        import os

        from whisper_ipa.models import (
            checkpoint_overlay_mode,
            load_checkpoint_auto,
        )

        trained = init_params(CFG, seed=1)
        run = tmp_path / "run"
        ckpt = run / "best-checkpoint"
        os.makedirs(ckpt)
        save_safetensors(str(ckpt / "model.safetensors"), trained)

        # no metadata -> None -> decoder-only
        assert checkpoint_overlay_mode(str(ckpt)) is None
        _, n_auto = load_checkpoint_auto(str(ckpt), params)
        _, n_dec = load_checkpoint_model(str(ckpt), params)
        assert n_auto == n_dec

        for frozen, expect in ((True, False), (False, True)):
            with open(run / "training_config.json", "w") as f:
                json.dump(
                    {"training_args": {"freeze_encoder": frozen}}, f
                )
            assert checkpoint_overlay_mode(str(ckpt)) is expect
        # freeze_encoder=false -> full overlay: encoder comes from ckpt
        merged, n_full = load_checkpoint_auto(str(ckpt), params)
        assert n_full > n_dec
        np.testing.assert_array_equal(
            np.asarray(flatten_params(merged)["encoder.conv1.w"]),
            np.asarray(flatten_params(trained)["encoder.conv1.w"]),
        )
        # explicit override beats metadata
        _, n_forced = load_checkpoint_auto(str(ckpt), params, full=False)
        assert n_forced == n_dec

    def test_hf_conversion(self):
        """Synthetic HF-named dict converts to working params."""
        rng = np.random.default_rng(0)
        d, v, nctx = CFG.n_text_state, CFG.n_vocab, CFG.n_text_ctx
        hf = {}
        hf["model.encoder.conv1.weight"] = rng.standard_normal(
            (d, CFG.n_mels, 3)
        ).astype(np.float32)
        hf["model.encoder.conv1.bias"] = np.zeros(d, np.float32)
        hf["model.decoder.embed_tokens.weight"] = rng.standard_normal(
            (v, d)
        ).astype(np.float32)
        hf["model.decoder.embed_positions.weight"] = np.zeros(
            (nctx, d), np.float32
        )
        hf["model.decoder.layers.0.self_attn.q_proj.weight"] = (
            rng.standard_normal((d, d)).astype(np.float32)
        )
        hf["model.decoder.layers.0.self_attn.q_proj.bias"] = np.zeros(
            d, np.float32
        )
        tree = params_from_flat(hf)
        assert tree["decoder"]["token_embedding"].shape == (v, d)
        assert tree["encoder"]["conv1"]["w"].shape == (3, CFG.n_mels, d)
        q = tree["decoder"]["blocks"][0]["attn"]["query"]
        np.testing.assert_allclose(
            np.asarray(q["w"]),
            hf["model.decoder.layers.0.self_attn.q_proj.weight"].T,
        )

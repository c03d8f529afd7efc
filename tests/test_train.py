"""Training tests: EOT mask, jitted step, freezing, checkpoints, DP mesh."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import flatten_params, init_params
from whisper_ipa.parallel import make_mesh, shard_batch
from whisper_ipa.train import (
    TrainState,
    compute_loss,
    create_train_state,
    eot_loss_mask,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    train_step,
)

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=16, n_text_ctx=32)
N_MEL_FRAMES = CFG.n_audio_ctx * 2
EOT = 50257


@pytest.fixture()
def params():
    # function-scoped: train_step donates its input state, so each test
    # needs fresh parameter buffers
    return init_params(CFG, seed=0)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mel = jnp.asarray(
        rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(np.float32)
    )
    tokens = jnp.asarray(
        [
            [50258, 50259, 50359, 50363, 100, 200, EOT, EOT],
            [50258, 50259, 50359, 50363, 300, EOT, EOT, EOT],
        ],
        jnp.int32,
    )
    return mel, tokens


class TestEOTMask:
    def test_keeps_first_eot_only(self):
        """The cumsum trick (reference train_whisper_ipa.py:240-247)."""
        targets = jnp.asarray([[5, 6, EOT, EOT, EOT]])
        mask = eot_loss_mask(targets, EOT)
        np.testing.assert_array_equal(
            np.asarray(mask[0]), [True, True, True, False, False]
        )

    def test_no_eot(self):
        targets = jnp.asarray([[5, 6, 7]])
        assert np.asarray(eot_loss_mask(targets, EOT)).all()

    def test_eot_at_start(self):
        targets = jnp.asarray([[EOT, EOT, 5]])
        np.testing.assert_array_equal(
            np.asarray(eot_loss_mask(targets, EOT)[0]), [True, False, True]
        )


class TestTrainStep:
    def test_loss_finite_and_positive(self, params, batch):
        mel, tokens = batch
        loss = compute_loss(params, CFG, mel, tokens, EOT)
        assert np.isfinite(float(loss))
        assert float(loss) > 0

    def test_loss_decreases_overfit(self, params, batch):
        """A few steps on one tiny batch must reduce the loss."""
        mel, tokens = batch
        state, tx = create_train_state(params, learning_rate=1e-3)
        losses = []
        for _ in range(5):
            state, loss = train_step(state, mel, tokens, CFG, tx, EOT)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_encoder_frozen(self, params, batch):
        """Decoder-only training: encoder params must not change."""
        mel, tokens = batch
        state, tx = create_train_state(params, learning_rate=1e-3)
        before = jax.tree.map(np.asarray, state.params["encoder"])
        for _ in range(2):
            state, _ = train_step(state, mel, tokens, CFG, tx, EOT)
        after = state.params["encoder"]
        for k, b in flatten_params(before).items():
            a = np.asarray(flatten_params(after)[k])
            np.testing.assert_array_equal(a, b)

    def test_decoder_updates(self, params, batch):
        mel, tokens = batch
        state, tx = create_train_state(params, learning_rate=1e-3)
        before = np.asarray(state.params["decoder"]["token_embedding"])
        state, _ = train_step(state, mel, tokens, CFG, tx, EOT)
        after = np.asarray(state.params["decoder"]["token_embedding"])
        assert not np.array_equal(before, after)


class TestCheckpointResume:
    def test_save_restore_roundtrip(self, params, batch, tmp_path):
        mel, tokens = batch
        state, tx = create_train_state(params, learning_rate=1e-3)
        state, loss = train_step(state, mel, tokens, CFG, tx, EOT)
        state, loss = train_step(state, mel, tokens, CFG, tx, EOT)

        out = str(tmp_path)
        save_checkpoint(state, 2, float(loss), out, learning_rate=1e-3)
        ckpt = latest_checkpoint(out)
        assert ckpt and ckpt.endswith("checkpoint-2")

        template, _ = create_train_state(params, learning_rate=1e-3)
        restored, meta = restore_checkpoint(ckpt, template)
        assert int(restored.step) == 2
        assert meta["step"] == 2

        # params identical
        a = flatten_params(state.params)
        b = flatten_params(restored.params)
        for k in a:
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), atol=0
            )

        # optimizer moments restored: next step must match exactly
        s1, l1 = train_step(state, mel, tokens, CFG, tx, EOT)
        s2, l2 = train_step(restored, mel, tokens, CFG, tx, EOT)
        assert float(l1) == pytest.approx(float(l2), abs=1e-6)
        np.testing.assert_allclose(
            np.asarray(s1.params["decoder"]["token_embedding"]),
            np.asarray(s2.params["decoder"]["token_embedding"]),
            atol=1e-6,
        )

    def test_training_state_json(self, params, batch, tmp_path):
        mel, tokens = batch
        state, tx = create_train_state(params)
        out = str(tmp_path)
        save_checkpoint(state, 1, 2.5, out, learning_rate=1e-5)
        with open(os.path.join(out, "checkpoint-1", "training_state.json")) as f:
            meta = json.load(f)
        assert meta["loss"] == 2.5
        assert meta["learning_rate"] == 1e-5


class TestDataParallel:
    def test_eight_device_mesh_step(self, params, batch):
        """DP train step over the virtual 8-device CPU mesh."""
        assert jax.device_count() == 8, "conftest must force 8 CPU devices"
        mesh = make_mesh()
        assert mesh is not None and mesh.devices.size == 8

        rng = np.random.default_rng(1)
        mel = jnp.asarray(
            rng.standard_normal((8, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
        )
        tokens = jnp.tile(
            jnp.asarray(
                [[50258, 50259, 50359, 50363, 77, EOT, EOT, EOT]], jnp.int32
            ),
            (8, 1),
        )
        mel_s, tokens_s = shard_batch(mesh, mel, tokens)

        # sharded-batch loss must equal the unsharded computation
        # (before train_step donates the param buffers)
        loss_ref = float(compute_loss(params, CFG, mel, tokens, EOT))
        loss_sharded = float(compute_loss(params, CFG, mel_s, tokens_s, EOT))
        assert loss_ref == pytest.approx(loss_sharded, rel=1e-5)

        state, tx = create_train_state(params, learning_rate=1e-3)
        state, loss = train_step(state, mel_s, tokens_s, CFG, tx, EOT)
        assert np.isfinite(float(loss))


class TestScheduleAndAccumulation:
    def test_make_schedule_shapes(self):
        from whisper_ipa.train.optimizer import make_schedule

        s = make_schedule(1e-4, warmup_steps=10, decay="cosine", total_steps=100)
        assert float(s(0)) == 0.0
        assert float(s(10)) == pytest.approx(1e-4, rel=1e-5)
        assert float(s(100)) < 1e-5

    def test_gradient_accumulation(self, params, batch):
        """With accum=2, params change only every second step."""
        mel, tokens = batch
        state, tx = create_train_state(
            params, learning_rate=1e-3, accum_steps=2
        )
        emb0 = np.asarray(state.params["decoder"]["token_embedding"]).copy()
        state, _ = train_step(state, mel, tokens, CFG, tx, EOT)
        emb1 = np.asarray(state.params["decoder"]["token_embedding"])
        np.testing.assert_array_equal(emb0, emb1)  # accumulating, no update
        state, _ = train_step(state, mel, tokens, CFG, tx, EOT)
        emb2 = np.asarray(state.params["decoder"]["token_embedding"])
        assert not np.array_equal(emb1, emb2)  # update applied


class TestOrbaxBackend:
    def test_orbax_roundtrip(self, params, batch, tmp_path):
        from whisper_ipa.train.checkpoints import (
            restore_checkpoint_orbax,
            save_checkpoint_orbax,
        )

        mel, tokens = batch
        state, tx = create_train_state(params, learning_rate=1e-3)
        state, _ = train_step(state, mel, tokens, CFG, tx, EOT)
        path = save_checkpoint_orbax(state, 1, str(tmp_path))

        template, _ = create_train_state(init_params(CFG, seed=0))
        restored = restore_checkpoint_orbax(path, template)
        np.testing.assert_allclose(
            np.asarray(restored.params["decoder"]["token_embedding"]),
            np.asarray(state.params["decoder"]["token_embedding"]),
            atol=0,
        )
        assert int(restored.step) == int(state.step)


class TestMemoryOptions:
    def test_mu_dtype_bf16_moments(self, params, batch):
        mel, tokens = batch
        state, tx = create_train_state(
            params, learning_rate=1e-3, mu_dtype="bfloat16"
        )
        state, loss = train_step(state, mel, tokens, CFG, tx, EOT)
        # find a mu leaf and check its dtype
        leaves = jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
        mus = [
            l for p, l in leaves if ".mu" in jax.tree_util.keystr(p)
            and hasattr(l, "dtype") and l.ndim >= 2
        ]
        assert mus and all(l.dtype == jnp.bfloat16 for l in mus)
        assert np.isfinite(float(loss))

    def test_encoder_bf16_cast(self, params):
        from whisper_ipa.models.convert import cast_tree_dtype

        enc = cast_tree_dtype(params["encoder"], jnp.bfloat16)
        assert enc["conv1"]["w"].dtype == jnp.bfloat16
        # forward still works with bf16 encoder params
        from whisper_ipa.models.whisper import encode

        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((1, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
        )
        p2 = dict(params)
        p2["encoder"] = enc
        feats = encode(p2, CFG, mel, dtype=jnp.bfloat16)
        assert np.isfinite(np.asarray(feats, np.float32)).all()


class TestTrainChunk:
    """train_chunk: C optimizer steps per dispatch == C train_step calls."""

    def _batches(self, n, widths=None):
        rng = np.random.default_rng(7)
        out = []
        for i in range(n):
            mel = rng.standard_normal((2, N_MEL_FRAMES, CFG.n_mels)).astype(
                np.float32
            )
            w = widths[i] if widths else 8
            tokens = np.full((2, w), EOT, np.int64)
            tokens[:, :4] = [50258, 50259, 50359, 50363]
            tokens[0, 4] = 100 + i
            tokens[1, 4 : min(6, w)] = 200 + i
            out.append((mel, tokens))
        return out

    def test_matches_sequential_steps(self, batch):
        from whisper_ipa.train import train_chunk

        batches = self._batches(3)
        p1 = init_params(CFG, seed=0)
        p2 = init_params(CFG, seed=0)

        state_a, tx = create_train_state(p1, learning_rate=1e-3)
        seq_losses = []
        for mel, tokens in batches:
            state_a, loss = train_step(
                state_a, jnp.asarray(mel), jnp.asarray(tokens), CFG, tx, EOT
            )
            seq_losses.append(float(loss))

        state_b, tx2 = create_train_state(p2, learning_rate=1e-3)
        mels = jnp.asarray(np.stack([m for m, _ in batches]))
        toks = jnp.asarray(np.stack([t for _, t in batches]))
        state_b, losses = train_chunk(state_b, mels, toks, CFG, tx2, EOT)

        assert int(state_b.step) == int(state_a.step) == 3
        np.testing.assert_allclose(
            np.asarray(losses), np.asarray(seq_losses), rtol=1e-6
        )
        a = flatten_params(state_a.params)
        b = flatten_params(state_b.params)
        for k in a:
            np.testing.assert_allclose(
                np.asarray(a[k]), np.asarray(b[k]), atol=1e-7,
                err_msg=f"param {k} diverged between chunked and sequential",
            )

    def test_trailing_eot_pad_is_loss_exact(self, batch):
        """Chunk-wide EOT right-pad must not change any step's loss."""
        from whisper_ipa.train import train_chunk

        batches = self._batches(2, widths=[8, 12])
        p1 = init_params(CFG, seed=0)
        p2 = init_params(CFG, seed=0)

        state_a, tx = create_train_state(p1, learning_rate=1e-3)
        seq_losses = []
        for mel, tokens in batches:
            state_a, loss = train_step(
                state_a, jnp.asarray(mel), jnp.asarray(tokens), CFG, tx, EOT
            )
            seq_losses.append(float(loss))

        # pad batch 0's tokens from 8 -> 12 with EOT (what the loop does)
        padded = np.full((2, 12), EOT, np.int64)
        padded[:, :8] = batches[0][1]
        mels = jnp.asarray(np.stack([batches[0][0], batches[1][0]]))
        toks = jnp.asarray(np.stack([padded, batches[1][1]]))
        state_b, tx2 = create_train_state(p2, learning_rate=1e-3)
        state_b, losses = train_chunk(state_b, mels, toks, CFG, tx2, EOT)

        np.testing.assert_allclose(
            np.asarray(losses), np.asarray(seq_losses), rtol=1e-6
        )

    def test_sharded_chunk_matches(self, batch):
        """(C, B, ...) chunk sharded over the 8-device 'data' axis."""
        from whisper_ipa.parallel.mesh import shard_chunk
        from whisper_ipa.train import train_chunk

        mesh = make_mesh()
        rng = np.random.default_rng(3)
        mels = rng.standard_normal(
            (2, 8, N_MEL_FRAMES, CFG.n_mels)
        ).astype(np.float32)
        toks = np.full((2, 8, 8), EOT, np.int64)
        toks[..., :4] = [50258, 50259, 50359, 50363]
        toks[..., 4] = 99

        p1 = init_params(CFG, seed=0)
        p2 = init_params(CFG, seed=0)
        state_a, tx = create_train_state(p1, learning_rate=1e-3)
        state_a, losses_ref = train_chunk(
            state_a, jnp.asarray(mels), jnp.asarray(toks), CFG, tx, EOT
        )

        mel_s, tok_s = shard_chunk(mesh, mels, toks)
        state_b, tx2 = create_train_state(p2, learning_rate=1e-3)
        state_b, losses_s = train_chunk(state_b, mel_s, tok_s, CFG, tx2, EOT)

        np.testing.assert_allclose(
            np.asarray(losses_s), np.asarray(losses_ref), rtol=1e-5
        )

    def test_chunk_len_boundaries(self):
        """The loop's chunk sizing: power-of-two, never crossing a
        validation/checkpoint boundary (mirrors _chunk_len in train())."""

        def chunk_len(step, num_steps, validate_every, save_every, spc):
            dist = num_steps - step
            for period in (validate_every, save_every):
                if period:
                    dist = min(dist, period - step % period)
            n = max(1, min(spc, dist))
            while n & (n - 1):
                n &= n - 1
            return n

        # boundary at 10 (validate): from step 7 only 2 steps (pow2 of 3)
        assert chunk_len(7, 100, 10, 50, 8) == 2
        assert chunk_len(8, 100, 10, 50, 8) == 2
        assert chunk_len(10, 100, 10, 50, 8) == 8
        # end of run caps the chunk
        assert chunk_len(98, 100, 0, 0, 8) == 2
        # walk a full schedule: every boundary must be hit exactly
        step, hits = 0, []
        while step < 40:
            n = chunk_len(step, 40, 10, 8, 8)
            step += n
            if step % 10 == 0:
                hits.append(step)
        assert hits == [10, 20, 30, 40]


class TestBF16Upload:
    def test_host_bf16_cast_upload_is_exact(self, params, batch):
        """The loop uploads bf16 mels when compute_dtype=bfloat16; host
        RN-even cast must equal the on-device mel.astype(bfloat16)."""
        import ml_dtypes

        mel, tokens = batch
        from whisper_ipa.train import compute_loss

        l_f32_upload = float(
            compute_loss(params, CFG, mel, tokens, EOT, dtype=jnp.bfloat16)
        )
        mel_host = jnp.asarray(np.asarray(mel).astype(ml_dtypes.bfloat16))
        l_bf16_upload = float(
            compute_loss(
                params, CFG, mel_host, tokens, EOT, dtype=jnp.bfloat16
            )
        )
        assert l_f32_upload == l_bf16_upload


class TestZero1Loop:
    @pytest.mark.slow
    def test_zero1_train_loop_checkpoint_resume_matches_replicated(
        self, tmp_path
    ):
        """The full train() loop with --zero1 on the 8-device mesh:
        trains, checkpoints the SHARDED optimizer state, resumes (restored
        moments re-placed sharded), and lands on the same losses as the
        replicated-state loop run with an identical 4+4 phase schedule."""
        import sys

        import whisper_ipa.config as config_mod
        from whisper_ipa.train.loop import train

        sys.path.insert(0, os.path.dirname(__file__))
        from test_dataset import make_synthetic_dataset

        data_json = make_synthetic_dataset(str(tmp_path / "ds"))
        config_mod.CONFIGS["test-micro-z1"] = replace(
            CONFIGS["test-tiny"],
            name="test-micro-z1",
            n_audio_state=32,
            n_audio_layer=1,
            n_text_state=32,
            n_text_layer=1,
            n_text_ctx=48,
        )
        try:

            def run(out_dir, zero1, **kw):
                common = dict(
                    model_name="test-micro-z1",
                    train_data_path=data_json,
                    test_data_path=data_json,
                    output_dir=str(tmp_path / out_dir),
                    batch_size=8,
                    learning_rate=1e-3,
                    validate_every=1000,  # > num_steps: no validation
                    save_every=4,
                    resume=True,
                    final_validate=False,
                    zero1=zero1,
                    **kw,
                )
                train(num_steps=4, **common)  # phase 1 -> checkpoint-4
                return train(num_steps=8, **common)  # phase 2: resume

            z = run("z1", zero1=True)
            assert os.path.isdir(str(tmp_path / "z1" / "checkpoint-8"))
            r = run("rep", zero1=False)
            assert z["final_loss"] == pytest.approx(
                r["final_loss"], rel=1e-5
            )
            # FSDP through the same loop: checkpoint saves the SHARDED
            # params, resume re-places them per the FSDP specs, and the
            # final loss still matches the replicated run
            f = run("fsdp", zero1=False, fsdp=True)
            assert os.path.isdir(str(tmp_path / "fsdp" / "checkpoint-8"))
            assert f["final_loss"] == pytest.approx(
                r["final_loss"], rel=1e-5
            )
        finally:
            config_mod.CONFIGS.pop("test-micro-z1", None)

    @pytest.mark.slow
    def test_tp_train_loop_matches_replicated(self, tmp_path):
        """train() with --tensor-parallel 2 (+ ZeRO-1 composition) on the
        virtual mesh: the Megatron-sharded production loop must land on
        the same losses as the plain replicated loop."""
        import sys

        import whisper_ipa.config as config_mod
        from whisper_ipa.train.loop import train

        sys.path.insert(0, os.path.dirname(__file__))
        from test_dataset import make_synthetic_dataset

        data_json = make_synthetic_dataset(str(tmp_path / "ds"))
        config_mod.CONFIGS["test-micro-tp"] = replace(
            CONFIGS["test-tiny"],
            name="test-micro-tp",
            n_audio_state=32,
            n_audio_layer=1,
            n_text_state=32,
            n_text_layer=1,
            n_text_ctx=48,
        )
        try:

            def run(out_dir, **kw):
                return train(
                    model_name="test-micro-tp",
                    train_data_path=data_json,
                    test_data_path=data_json,
                    output_dir=str(tmp_path / out_dir),
                    num_steps=4,
                    batch_size=8,
                    learning_rate=1e-3,
                    validate_every=1000,
                    save_every=1000,
                    final_validate=False,
                    **kw,
                )

            r = run("rep")
            tp = run("tp2", tensor_parallel=2)
            tpz = run("tp2z1", tensor_parallel=2, zero1=True)
            # --no-data-parallel + TP: a pure-model mesh (data=1), no
            # implicit DP over the remaining devices
            tpo = run("tp_only", tensor_parallel=2, data_parallel=False)
            assert tp["final_loss"] == pytest.approx(
                r["final_loss"], rel=1e-4
            )
            assert tpz["final_loss"] == pytest.approx(
                r["final_loss"], rel=1e-4
            )
            assert tpo["final_loss"] == pytest.approx(
                r["final_loss"], rel=1e-4
            )
        finally:
            config_mod.CONFIGS.pop("test-micro-tp", None)

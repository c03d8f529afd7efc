"""Mesh/distributed helper tests on the virtual 8-device mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.parallel import (
    batch_sharding,
    global_batch_from_local,
    local_shard_indices,
    make_mesh,
    param_shardings,
    process_info,
    replicate,
    shard_params,
    spec_for_param,
)
from jax.sharding import PartitionSpec as P


class TestMesh:
    def test_make_mesh_shapes(self):
        mesh = make_mesh()
        assert mesh.shape == {"data": 8, "model": 1}
        mesh2 = make_mesh(model=2)
        assert mesh2.shape == {"data": 4, "model": 2}
        with pytest.raises(ValueError):
            make_mesh(model=3)

    def test_single_device_mesh_none(self):
        mesh = make_mesh(devices=jax.devices()[:1])
        assert mesh is None

    def test_tp_rules(self):
        assert spec_for_param("decoder.blocks.0.attn.query.w") == P(None, "model")
        assert spec_for_param("decoder.blocks.3.mlp2.w") == P("model", None)
        assert spec_for_param("decoder.blocks.0.attn_ln.g") == P()
        assert spec_for_param("encoder.conv1.w") == P()

    def test_replicate_and_shard(self):
        mesh = make_mesh()
        x = jnp.ones((8, 4))
        xs = jax.device_put(x, batch_sharding(mesh, 2))
        assert xs.sharding.spec == P("data", None)
        tree = {"a": jnp.ones((4, 4))}
        rt = replicate(mesh, tree)
        assert rt["a"].sharding.spec == P()

    def test_shard_params_tp(self):
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=16, n_text_ctx=16)
        params = init_params(cfg, seed=0)
        mesh = make_mesh(model=2)
        sharded = shard_params(mesh, params, tensor_parallel=True)
        q = sharded["decoder"]["blocks"][0]["attn"]["query"]["w"]
        assert q.sharding.spec == P(None, "model")


class TestDistributed:
    def test_process_info_single(self):
        info = process_info()
        assert info["process_count"] == 1
        assert info["global_device_count"] == 8

    def test_local_shard_indices_single_host(self):
        idx = local_shard_indices(10)
        assert idx == list(range(10))

    def test_global_batch_from_local(self):
        mesh = make_mesh()
        local = np.arange(16, dtype=np.float32).reshape(8, 2)
        arr = global_batch_from_local(mesh, local)
        assert arr.shape == (8, 2)
        np.testing.assert_array_equal(np.asarray(arr), local)


class TestTensorParallelInference:
    def test_tp_sharded_decode(self):
        """Greedy decode with TP-sharded params over the virtual mesh."""
        from dataclasses import replace

        import jax.numpy as jnp

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.decode import DecodingOptions, decode
        from whisper_ipa.models import init_params
        from whisper_ipa.tokenizer import get_tokenizer

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)
        mesh = make_mesh(model=2)
        sharded = shard_params(mesh, params, tensor_parallel=True)

        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((2, 64, cfg.n_mels)).astype(np.float32)
        )
        plain = decode(
            params,
            cfg,
            mel,
            DecodingOptions(
                language="en", without_timestamps=True, sample_len=4
            ),
            tokenizer=tok,
        )
        tp = decode(
            sharded,
            cfg,
            mel,
            DecodingOptions(
                language="en", without_timestamps=True, sample_len=4
            ),
            tokenizer=tok,
        )
        # TP-sharded execution must produce the same tokens
        assert [r.tokens for r in tp] == [r.tokens for r in plain]

    def test_tp_sharded_beam_decode(self):
        """Beam search (reorder-free v2 path: ancestry-masked attention,
        shared cross cache) under TP sharding must match the replicated
        run exactly — the new einsums have no other multi-chip oracle."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.decode import DecodingOptions, decode
        from whisper_ipa.models import init_params
        from whisper_ipa.tokenizer import get_tokenizer

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)
        mesh = make_mesh(model=2)
        sharded = shard_params(mesh, params, tensor_parallel=True)

        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((2, 64, cfg.n_mels)).astype(np.float32)
        )
        opts = DecodingOptions(
            language="en", without_timestamps=True, sample_len=4,
            beam_size=3, length_penalty=1.0,
        )
        plain = decode(params, cfg, mel, opts, tokenizer=tok)
        tp = decode(sharded, cfg, mel, opts, tokenizer=tok)
        assert [r.tokens for r in tp] == [r.tokens for r in plain]

    def test_tp_train_step_matches_unsharded(self):
        """TP TRAIN-STEP numeric oracle (round-3 verdict gap): loss AND
        the updated params through the Megatron column/row backward +
        GSPMD reductions must match the unsharded step over 3 steps,
        for dp=1 x tp=2 and dp=2 x tp=2."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import shard_batch
        from whisper_ipa.train import create_train_state, train_step

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 4
        rng = np.random.default_rng(3)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)

        def run(mesh):
            # fresh params per run: train_step donates its input state
            params = init_params(cfg, seed=0)
            if mesh is not None:
                from whisper_ipa.parallel import shard_params

                params = shard_params(mesh, params, tensor_parallel=True)
            state, tx = create_train_state(
                params, learning_rate=1e-3, freeze_encoder=False
            )
            mel = jnp.asarray(mel_np)
            tokens = jnp.asarray(tokens_np)
            if mesh is not None:
                mel, tokens = shard_batch(mesh, mel, tokens)
            losses = []
            for _ in range(3):
                state, loss = train_step(
                    state, mel, tokens, cfg, tx, eot, freeze_encoder=False
                )
                losses.append(float(loss))
            return losses, jax.device_get(state.params)

        ref_losses, ref_params = run(None)
        for n_dev in (2, 4):  # dp=1 x tp=2, dp=2 x tp=2
            mesh = make_mesh(model=2, devices=jax.devices()[:n_dev])
            tp_losses, tp_params = run(mesh)
            np.testing.assert_allclose(
                tp_losses, ref_losses, rtol=1e-4,
                err_msg=f"TP loss drift over 3 steps ({n_dev} devices)",
            )
            jax.tree.map(
                lambda a, b: np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-3, atol=2e-5
                ),
                tp_params,
                ref_params,
            )

    def test_zero1_spec_rules(self):
        from whisper_ipa.parallel.mesh import zero1_spec

        # largest divisible axis gets 'data'
        assert zero1_spec((384, 1536), 8) == P(None, "data")
        assert zero1_spec((1536, 384), 8) == P("data")
        # composes with a TP spec: 'data' goes on the largest FREE axis
        assert zero1_spec((384, 1536), 8, P(None, "model")) == P(
            "data", "model"
        )
        # nothing divisible -> unchanged
        assert zero1_spec((7, 5), 8) == P()
        assert zero1_spec((), 8) == P()

    def test_zero1_opt_state_sharded_and_matches_unsharded(self):
        """ZeRO-1 oracle: the sharded-optimizer step must (a) hold exactly
        1/N of the AdamW moments per device with no replication, (b) keep
        that layout across steps, and (c) produce bit-comparable losses and
        params to the plain replicated-state step."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import shard_batch
        from whisper_ipa.train import (
            create_train_state,
            create_train_state_zero1,
            make_zero1_step,
            train_step,
        )

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 8
        rng = np.random.default_rng(7)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)

        # reference: plain replicated-state steps on one device
        params = init_params(cfg, seed=0)
        state, tx = create_train_state(
            params, learning_rate=1e-3, freeze_encoder=False
        )
        ref_losses = []
        for _ in range(3):
            state, loss = train_step(
                state,
                jnp.asarray(mel_np),
                jnp.asarray(tokens_np),
                cfg,
                tx,
                eot,
                freeze_encoder=False,
            )
            ref_losses.append(float(loss))
        ref_params = jax.device_get(state.params)
        ref_opt_bytes = sum(
            leaf.nbytes
            for leaf in jax.tree.leaves(jax.device_get(state.opt_state))
            if hasattr(leaf, "nbytes")
        )

        # ZeRO-1 over dp=8
        mesh = make_mesh()
        params = replicate(mesh, init_params(cfg, seed=0))
        zstate, ztx, opt_sh = create_train_state_zero1(
            mesh, params, learning_rate=1e-3, freeze_encoder=False
        )

        # (a) every moment tensor is sharded: per-device bytes == total/8
        mu_leaves = [
            x
            for x in jax.tree.leaves(zstate.opt_state)
            if hasattr(x, "sharding") and x.ndim >= 1 and x.size >= 64
        ]
        assert mu_leaves, "no shardable optimizer-state leaves found"
        for leaf in mu_leaves:
            assert "data" in tuple(leaf.sharding.spec), (
                f"unsharded optimizer leaf {leaf.shape}"
            )
            shard = leaf.addressable_shards[0].data
            assert shard.size * 8 == leaf.size
        # total opt-state footprint is unchanged (sharded, not copied):
        # sum of per-device shard bytes == unsharded total
        per_device = sum(
            leaf.addressable_shards[0].data.nbytes
            for leaf in jax.tree.leaves(zstate.opt_state)
            if hasattr(leaf, "addressable_shards")
        )
        assert per_device <= ref_opt_bytes / 8 + 4096

        step_fn = make_zero1_step(
            mesh, cfg, ztx, eot, opt_sh, freeze_encoder=False
        )
        mel, tokens = shard_batch(
            mesh, jnp.asarray(mel_np), jnp.asarray(tokens_np)
        )
        z_losses = []
        for _ in range(3):
            zstate, loss = step_fn(zstate, mel, tokens)
            z_losses.append(float(loss))

        # (b) layout survived the steps (no silent re-replication)
        for leaf in jax.tree.leaves(zstate.opt_state):
            if hasattr(leaf, "sharding") and leaf.ndim >= 1 and leaf.size >= 64:
                assert "data" in tuple(leaf.sharding.spec)

        # (c) numerics match the replicated-state reference
        np.testing.assert_allclose(z_losses, ref_losses, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
            ),
            jax.device_get(zstate.params),
            ref_params,
        )

    def test_zero1_composes_with_tp(self):
        """dp=4 x tp=2 with ZeRO-1: moments shard over BOTH axes ('data'
        added on the largest free axis of the TP spec) and the loss still
        matches the unsharded step."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import shard_batch
        from whisper_ipa.train import (
            create_train_state,
            create_train_state_zero1,
            make_zero1_step,
            train_step,
        )

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 8
        rng = np.random.default_rng(11)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)

        params = init_params(cfg, seed=0)
        state, tx = create_train_state(
            params, learning_rate=1e-3, freeze_encoder=False
        )
        ref_losses = []
        for _ in range(2):
            state, loss = train_step(
                state,
                jnp.asarray(mel_np),
                jnp.asarray(tokens_np),
                cfg,
                tx,
                eot,
                freeze_encoder=False,
            )
            ref_losses.append(float(loss))

        mesh = make_mesh(model=2)  # data=4 x model=2
        tp_params = shard_params(
            mesh, init_params(cfg, seed=0), tensor_parallel=True
        )
        zstate, ztx, opt_sh = create_train_state_zero1(
            mesh,
            tp_params,
            learning_rate=1e-3,
            freeze_encoder=False,
            tensor_parallel=True,
        )
        # a TP-sharded param's moment composes both axes
        mu_specs = [
            tuple(leaf.sharding.spec)
            for leaf in jax.tree.leaves(zstate.opt_state)
            if hasattr(leaf, "sharding") and leaf.ndim == 2
        ]
        assert any(
            "data" in spec and "model" in spec for spec in mu_specs
        ), f"no dp+tp composed moment found: {mu_specs[:8]}"

        from whisper_ipa.parallel import param_shardings as tp_shardings

        step_fn = make_zero1_step(
            mesh,
            cfg,
            ztx,
            eot,
            opt_sh,
            param_shardings=tp_shardings(mesh, tp_params),
            freeze_encoder=False,
        )
        mel, tokens = shard_batch(
            mesh, jnp.asarray(mel_np), jnp.asarray(tokens_np)
        )
        z_losses = []
        for _ in range(2):
            zstate, loss = step_fn(zstate, mel, tokens)
            z_losses.append(float(loss))
        np.testing.assert_allclose(z_losses, ref_losses, rtol=1e-4)

    def test_tp_sharded_decode_int8_kv(self):
        """TP-sharded decode with the int8 head-split cross-KV cache: GSPMD
        must propagate the model-axis sharding through quantization and the
        head-split attention (multi-chip serving path)."""
        from dataclasses import replace

        import jax.numpy as jnp

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.decode import DecodingOptions, decode
        from whisper_ipa.models import init_params
        from whisper_ipa.tokenizer import get_tokenizer

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)
        mesh = make_mesh(model=2)
        sharded = shard_params(mesh, params, tensor_parallel=True)

        tok = get_tokenizer(multilingual=True, language="en")
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((2, 64, cfg.n_mels)).astype(np.float32)
        )
        opts = DecodingOptions(
            language="en", without_timestamps=True, sample_len=4,
            kv_int8=True,
        )
        plain = decode(params, cfg, mel, opts, tokenizer=tok)
        tp = decode(sharded, cfg, mel, opts, tokenizer=tok)
        assert [r.tokens for r in tp] == [r.tokens for r in plain]


class TestZero1OptimizerVariants:
    def test_zero1_with_accum_and_bf16_moments_and_frozen_encoder(self):
        """ZeRO-1 shardings must map every optimizer wrapper we ship:
        multi_transform (frozen encoder -> MaskedNode leaves),
        MultiSteps (acc_grads mirror the params), and bfloat16 first
        moments — and the step must still match the replicated run."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import shard_batch
        from whisper_ipa.train import (
            create_train_state,
            create_train_state_zero1,
            make_zero1_step,
            train_step,
        )

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 8
        rng = np.random.default_rng(5)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)
        kw = dict(
            learning_rate=1e-3,
            freeze_encoder=True,
            accum_steps=2,
            mu_dtype="bfloat16",
        )

        params = init_params(cfg, seed=0)
        state, tx = create_train_state(params, **kw)
        ref_losses = []
        for _ in range(4):  # 2 accumulation cycles
            state, loss = train_step(
                state, jnp.asarray(mel_np), jnp.asarray(tokens_np), cfg,
                tx, eot,
            )
            ref_losses.append(float(loss))
        ref_params = jax.device_get(state.params)

        mesh = make_mesh()
        zparams = replicate(mesh, init_params(cfg, seed=0))
        zstate, ztx, opt_sh = create_train_state_zero1(mesh, zparams, **kw)
        # bf16 moments + acc_grads are sharded like everything else
        n_sharded = sum(
            1
            for leaf in jax.tree.leaves(zstate.opt_state)
            if hasattr(leaf, "sharding")
            and "data" in tuple(leaf.sharding.spec)
        )
        assert n_sharded > 0
        step_fn = make_zero1_step(mesh, cfg, ztx, eot, opt_sh)
        mel, tokens = shard_batch(
            mesh, jnp.asarray(mel_np), jnp.asarray(tokens_np)
        )
        z_losses = []
        for _ in range(4):
            zstate, loss = step_fn(zstate, mel, tokens)
            z_losses.append(float(loss))
        np.testing.assert_allclose(z_losses, ref_losses, rtol=1e-5)
        jax.tree.map(
            # bf16 first moments: tiny order-of-ops differences round
            # visibly, so the param tolerance is looser than the fp32 test
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a, np.float32),
                np.asarray(b, np.float32),
                rtol=1e-3,
                atol=1e-5,
            ),
            jax.device_get(zstate.params),
            ref_params,
        )


class TestFSDP:
    def test_fsdp_param_sharding_specs(self):
        """Every divisible parameter gets 'data' on its largest free axis;
        under TP the Megatron spec is preserved and 'data' composes on a
        free axis; indivisible tensors stay replicated."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.models.convert import flatten_params
        from whisper_ipa.parallel import fsdp_param_shardings

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)

        mesh = make_mesh()  # data=8
        flat_sh = flatten_params(fsdp_param_shardings(mesh, params))
        flat_p = flatten_params(params)
        n_sharded = 0
        for k, sh in flat_sh.items():
            shape = flat_p[k].shape
            spec = tuple(sh.spec)
            if any(d % 8 == 0 and d > 0 for d in shape):
                assert "data" in spec, f"{k} {shape} not FSDP-sharded"
                n_sharded += 1
            else:
                assert "data" not in spec, f"indivisible {k} {shape} sharded"
        assert n_sharded > 10

        # composes with TP: qkv keeps P(None, 'model') and adds 'data'
        mesh2 = make_mesh(model=2)  # data=4 x model=2
        flat_tp = flatten_params(
            fsdp_param_shardings(mesh2, params, tensor_parallel=True)
        )
        qkv = [
            tuple(sh.spec)
            for k, sh in flat_tp.items()
            if k.endswith("attn.query.w")
        ]
        assert qkv and all(
            "model" in spec and "data" in spec for spec in qkv
        ), f"TP+FSDP composition missing: {qkv[:4]}"

    def test_fsdp_step_matches_unsharded(self):
        """FSDP oracle: with parameters sharded over data=8, (a) each
        device holds ~1/8 of the weight bytes, (b) the layout survives
        steps (out_shardings pin), and (c) losses AND updated params match
        the single-device step — the all-gather/reduce-scatter schedule
        GSPMD derives must be numerically invisible."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import fsdp_param_shardings, shard_batch
        from whisper_ipa.train import (
            create_train_state,
            create_train_state_zero1,
            make_zero1_step,
            train_step,
        )

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 8
        rng = np.random.default_rng(13)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)

        params = init_params(cfg, seed=0)
        state, tx = create_train_state(
            params, learning_rate=1e-3, freeze_encoder=False
        )
        ref_losses = []
        for _ in range(3):
            state, loss = train_step(
                state, jnp.asarray(mel_np), jnp.asarray(tokens_np), cfg,
                tx, eot, freeze_encoder=False,
            )
            ref_losses.append(float(loss))
        ref_params = jax.device_get(state.params)
        total_param_bytes = sum(
            leaf.nbytes for leaf in jax.tree.leaves(ref_params)
        )

        mesh = make_mesh()  # data=8
        fsdp_sh = fsdp_param_shardings(mesh, init_params(cfg, seed=0))
        fparams = jax.tree.map(
            jax.device_put, init_params(cfg, seed=0), fsdp_sh
        )
        fstate, ftx, opt_sh = create_train_state_zero1(
            mesh, fparams, learning_rate=1e-3, freeze_encoder=False
        )

        # (a) per-device weight residency ~ total/8 (+ small replicated
        # tensors that don't divide by 8)
        per_device = sum(
            leaf.addressable_shards[0].data.nbytes
            for leaf in jax.tree.leaves(fstate.params)
        )
        assert per_device <= total_param_bytes / 8 * 1.25, (
            f"per-device {per_device} vs total/8 "
            f"{total_param_bytes / 8:.0f}"
        )

        step_fn = make_zero1_step(
            mesh, cfg, ftx, eot, opt_sh,
            param_shardings=fsdp_sh, freeze_encoder=False,
        )
        mel, tokens = shard_batch(
            mesh, jnp.asarray(mel_np), jnp.asarray(tokens_np)
        )
        f_losses = []
        for _ in range(3):
            fstate, loss = step_fn(fstate, mel, tokens)
            f_losses.append(float(loss))

        # (b) params are still FSDP-sharded after the steps
        n_sharded = sum(
            1
            for leaf in jax.tree.leaves(fstate.params)
            if "data" in tuple(leaf.sharding.spec)
        )
        assert n_sharded > 10, "params silently re-replicated"

        # (c) numerics match the single-device reference (atol 1e-5: the
        # grad reduce-scatter sums partial grads in a different order
        # than the replicated all-reduce — pure fp32 rounding, observed
        # max |diff| ~8e-6 on 1/16k elements)
        np.testing.assert_allclose(f_losses, ref_losses, rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5
            ),
            jax.device_get(fstate.params),
            ref_params,
        )

    def test_fsdp_composes_with_tp(self):
        """dp=4 x tp=2 with FSDP: weights shard over BOTH mesh axes and
        the loss still matches the unsharded step."""
        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params
        from whisper_ipa.parallel import fsdp_param_shardings, shard_batch
        from whisper_ipa.train import (
            create_train_state,
            create_train_state_zero1,
            make_zero1_step,
            train_step,
        )

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        eot = 50257
        batch = 8
        rng = np.random.default_rng(17)
        mel_np = rng.standard_normal((batch, 64, cfg.n_mels)).astype(
            np.float32
        )
        tokens_np = np.tile(
            [[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (batch, 1)
        ).astype(np.int32)

        params = init_params(cfg, seed=0)
        state, tx = create_train_state(
            params, learning_rate=1e-3, freeze_encoder=False
        )
        ref_losses = []
        for _ in range(2):
            state, loss = train_step(
                state, jnp.asarray(mel_np), jnp.asarray(tokens_np), cfg,
                tx, eot, freeze_encoder=False,
            )
            ref_losses.append(float(loss))

        mesh = make_mesh(model=2)  # data=4 x model=2
        fsdp_sh = fsdp_param_shardings(
            mesh, params, tensor_parallel=True
        )
        fparams = jax.tree.map(
            jax.device_put, init_params(cfg, seed=0), fsdp_sh
        )
        fstate, ftx, opt_sh = create_train_state_zero1(
            mesh, fparams, learning_rate=1e-3, freeze_encoder=False,
            tensor_parallel=True,
        )
        step_fn = make_zero1_step(
            mesh, cfg, ftx, eot, opt_sh,
            param_shardings=fsdp_sh, freeze_encoder=False,
        )
        mel, tokens = shard_batch(
            mesh, jnp.asarray(mel_np), jnp.asarray(tokens_np)
        )
        f_losses = []
        for _ in range(2):
            fstate, loss = step_fn(fstate, mel, tokens)
            f_losses.append(float(loss))
        np.testing.assert_allclose(f_losses, ref_losses, rtol=1e-4)


class TestDataParallelEvaluation:
    def test_dp_validate_matches_single_device(self, tmp_path):
        """validate(mesh=...) shards decode batches over 'data' (with
        zero-padded tails) and must score identically to the unsharded
        run — the offline-evaluation throughput scaling path."""
        import sys, os

        from dataclasses import replace

        from whisper_ipa.config import CONFIGS
        from whisper_ipa.data import create_data_loader
        from whisper_ipa.models import init_params
        from whisper_ipa.train.loop import validate

        sys.path.insert(0, os.path.dirname(__file__))
        from test_dataset import make_synthetic_dataset

        data_json = make_synthetic_dataset(str(tmp_path / "ds"))
        # full 1500-frame audio ctx (the dataset emits 30 s mels) but
        # micro model dims to keep the CPU compile quick
        cfg = replace(
            CONFIGS["test-tiny"],
            n_audio_state=32,
            n_audio_layer=1,
            n_text_state=32,
            n_text_layer=1,
            n_text_ctx=48,
        )
        params = init_params(cfg, seed=0)
        dataset = create_data_loader(data_json, n_mels=cfg.n_mels)
        tok = dataset.tokenizer

        # batch 4 over 6 samples: a full batch (pad 4->8) and a tail
        # batch of 2 (pad 2->8) both exercise the padding path on dp=8
        plain = validate(
            params, cfg, dataset, tok, num_samples=6, val_batch_size=4
        )
        mesh = make_mesh()
        dp = validate(
            replicate(mesh, init_params(cfg, seed=0)),
            cfg, dataset, tok, num_samples=6, val_batch_size=4, mesh=mesh,
        )
        assert dp["per"] == pytest.approx(plain["per"], abs=1e-9)
        assert dp["pfer"] == pytest.approx(plain["pfer"], abs=1e-9)
        assert dp["num_samples"] == plain["num_samples"] == 6

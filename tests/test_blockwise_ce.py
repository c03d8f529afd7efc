"""Blockwise cross-entropy: value and gradient parity with the dense loss."""

from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params
from whisper_ipa.ops.blockwise_ce import blockwise_cross_entropy
from whisper_ipa.train.loss import compute_loss

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=16, n_text_ctx=32)
EOT = 50257


def dense_ce(x, emb, targets, mask):
    logits = x @ emb.T
    lp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    tl = jnp.take_along_axis(lp, targets[:, None], axis=-1)[:, 0]
    m = mask.astype(jnp.float32)
    return -(tl * m).sum() / jnp.maximum(m.sum(), 1)


class TestBlockwiseCE:
    @pytest.fixture(scope="class")
    def data(self):
        rng = np.random.default_rng(0)
        N, d, V = 10, 32, 51865
        x = jnp.asarray(rng.standard_normal((N, d)).astype(np.float32) * 0.3)
        emb = jnp.asarray(
            rng.standard_normal((V, d)).astype(np.float32) * 0.1
        )
        targets = jnp.asarray(
            rng.integers(0, V, size=N).astype(np.int32)
        )
        mask = jnp.asarray([True] * 7 + [False] * 3)
        return x, emb, targets, mask

    def test_value_matches_dense(self, data):
        x, emb, targets, mask = data
        a = float(blockwise_cross_entropy(x, emb, targets, mask))
        b = float(dense_ce(x, emb, targets, mask))
        assert a == pytest.approx(b, rel=1e-5)

    def test_grads_match_dense(self, data):
        x, emb, targets, mask = data
        ga = jax.grad(blockwise_cross_entropy, argnums=(0, 1))(
            x, emb, targets, mask
        )
        gb = jax.grad(dense_ce, argnums=(0, 1))(x, emb, targets, mask)
        np.testing.assert_allclose(
            np.asarray(ga[0]), np.asarray(gb[0]), atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(ga[1]), np.asarray(gb[1]), atol=2e-6
        )

    def test_all_masked(self, data):
        x, emb, targets, _ = data
        mask = jnp.zeros(x.shape[0], bool)
        assert float(blockwise_cross_entropy(x, emb, targets, mask)) == 0.0


class TestBlockwiseLoss:
    def test_matches_dense_compute_loss(self):
        params = init_params(CFG, seed=0)
        rng = np.random.default_rng(0)
        mel = jnp.asarray(
            rng.standard_normal((2, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        tokens = jnp.asarray(
            [[50258, 50259, 50359, 50363, 100, 200, EOT, EOT]] * 2, jnp.int32
        )
        dense = float(compute_loss(params, CFG, mel, tokens, EOT))
        blockwise = float(
            compute_loss(params, CFG, mel, tokens, EOT, blockwise=True)
        )
        assert blockwise == pytest.approx(dense, rel=1e-5)


class TestBf16Head:
    """bf16-operand logits GEMM: loss parity + finite, aligned grads."""

    def _setup(self):
        params = init_params(CFG, seed=0)
        rng = np.random.default_rng(1)
        mel = jnp.asarray(
            rng.standard_normal((2, CFG.n_audio_ctx * 2, CFG.n_mels)).astype(
                np.float32
            )
        )
        tokens = jnp.asarray(
            [[50258, 50259, 50359, 50363, 100, 200, EOT, EOT]] * 2, jnp.int32
        )
        return params, mel, tokens

    def test_loss_close_to_f32_head(self):
        params, mel, tokens = self._setup()
        f32 = float(compute_loss(params, CFG, mel, tokens, EOT))
        bf16 = float(
            compute_loss(params, CFG, mel, tokens, EOT, bf16_head=True)
        )
        # operands round to bf16 (~2^-8 relative); the loss is a log-sum
        # over ~51k logits so errors average out further
        assert bf16 == pytest.approx(f32, rel=5e-3)

    def test_grads_finite_and_aligned(self):
        params, mel, tokens = self._setup()

        def loss_fn(p, bf16_head):
            return compute_loss(
                p, CFG, mel, tokens, EOT, bf16_head=bf16_head
            )

        g32 = jax.grad(loss_fn)(params, False)
        g16 = jax.grad(loss_fn)(params, True)
        a = jnp.concatenate(
            [x.ravel() for x in jax.tree_util.tree_leaves(g32)]
        )
        b = jnp.concatenate(
            [x.ravel() for x in jax.tree_util.tree_leaves(g16)]
        )
        assert bool(jnp.all(jnp.isfinite(b)))
        cos = jnp.vdot(a, b) / (
            jnp.linalg.norm(a) * jnp.linalg.norm(b) + 1e-12
        )
        assert float(cos) > 0.999

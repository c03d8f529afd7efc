"""Minimal fine-tuning proof-of-concept on dummy data.

The JAX equivalent of the reference's MLX PoC
(scripts/experimental/finetune_mlx.py): build a tiny model, run a few
jitted train steps on random mel/token batches, watch the loss fall.

  python examples/minimal_finetune.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax.numpy as jnp

    from whisper_ipa.config import CONFIGS
    from whisper_ipa.models import init_params
    from whisper_ipa.train import create_train_state, train_step

    cfg = CONFIGS["test-tiny"]
    params = init_params(cfg, seed=0)
    state, tx = create_train_state(params, learning_rate=1e-3)

    rng = np.random.default_rng(0)
    eot = 50257
    mel = jnp.asarray(
        rng.standard_normal((2, cfg.n_audio_ctx * 2, cfg.n_mels)).astype(
            np.float32
        )
    )
    tokens = jnp.asarray(
        [[50258, 50259, 50359, 50363, 100, 200, eot, eot]] * 2, jnp.int32
    )

    for step in range(5):
        state, loss = train_step(state, mel, tokens, cfg, tx, eot)
        print(f"step {step + 1}: loss {float(loss):.4f}")
    print("done — loss should be decreasing (overfitting one batch)")


if __name__ == "__main__":
    main()

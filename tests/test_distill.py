"""Draft distillation (train/loss.compute_distill_loss + cli/distill_draft).

The property that matters for speculation: distilling toward the
teacher's logits pulls the student's greedy choices toward the
teacher's (draft-target AGREEMENT), which independent data training
does not do (measured r3: 1.06 tokens/round).
"""

import json
import os
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params
from whisper_ipa.train.loss import compute_distill_loss, compute_loss

CFG = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
EOT = 50257


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    mel = jnp.asarray(
        rng.standard_normal((2, 64, CFG.n_mels)).astype(np.float32)
    )
    tok = np.full((2, 8), EOT, np.int32)
    tok[:, :4] = [50258, 50259, 50359, 50363]
    tok[0, 4:6] = [100, 200]
    tok[1, 4:7] = [300, 400, 500]
    return mel, jnp.asarray(tok)


class TestDistillLoss:
    def test_self_distillation_is_pure_ce(self, batch):
        """KL(teacher || student) == 0 when they are the same model, so
        the loss reduces to (1 - alpha) * CE."""
        mel, tokens = batch
        params = init_params(CFG, seed=0)
        ce = float(compute_loss(params, CFG, mel, tokens, EOT,
                                freeze_encoder=False))
        d = float(
            compute_distill_loss(
                params, params, CFG, CFG, mel, tokens, EOT, alpha=0.5
            )
        )
        assert d == pytest.approx(0.5 * ce, rel=1e-4)

    def test_kl_pulls_student_toward_teacher(self, batch):
        """A few KL-only steps must increase student/teacher greedy
        agreement on the training positions."""
        import optax

        from whisper_ipa.models.whisper import decoder_logits, encode

        mel, tokens = batch
        teacher = init_params(CFG, seed=1)
        student = init_params(CFG, seed=2)

        def agreement(sp):
            args = (tokens[:, :-1],)
            t_l = decoder_logits(
                teacher, CFG, *args, encode(teacher, CFG, mel)
            )
            s_l = decoder_logits(sp, CFG, *args, encode(sp, CFG, mel))
            return float(
                (jnp.argmax(t_l, -1) == jnp.argmax(s_l, -1)).mean()
            )

        before = agreement(student)
        tx = optax.adam(1e-3)
        opt = tx.init(student)

        @jax.jit
        def step(sp, opt):
            loss, g = jax.value_and_grad(
                lambda q: compute_distill_loss(
                    q, teacher, CFG, CFG, mel, tokens, EOT, alpha=1.0
                )
            )(sp)
            up, opt = tx.update(g, opt, sp)
            return optax.apply_updates(sp, up), opt, loss

        losses = []
        for _ in range(30):
            student, opt, loss = step(student, opt)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.9  # KL is being minimized
        assert agreement(student) >= before

    def test_vocab_mismatch_rejected(self, batch):
        mel, tokens = batch
        params = init_params(CFG, seed=0)
        other = replace(CFG, n_vocab=CFG.n_vocab + 1)
        with pytest.raises(ValueError):
            compute_distill_loss(
                params, params, CFG, other, mel, tokens, EOT
            )


class TestDistillCLI:
    def test_end_to_end_micro(self, tmp_path, monkeypatch):
        """The CLI runs against a saved teacher checkpoint and writes a
        loadable student checkpoint."""
        from whisper_ipa.audio import write_wav
        from whisper_ipa.cli.distill_draft import main
        from whisper_ipa.data.synth import synthesize_ipa
        from whisper_ipa.train.checkpoints import save_checkpoint
        from whisper_ipa.train.step import create_train_state

        # teacher checkpoint (random test-tiny weights, standard format)
        teacher_dir = tmp_path / "teacher"
        state, _ = create_train_state(init_params(CONFIGS["test-tiny"],
                                                  seed=0))
        save_checkpoint(state, 1, 1.0, str(teacher_dir),
                        save_opt_state=False)

        # two-utterance dataset
        data = []
        for i, ipa in enumerate(["pat", "tak"]):
            path = str(tmp_path / f"u{i}.wav")
            write_wav(path, synthesize_ipa(ipa, seed=i))
            data.append(
                {"audio_path": path, "ipa_transcription": ipa,
                 "speaker_id": str(i), "dataset_source": "synthetic"}
            )
        data_json = str(tmp_path / "train.json")
        with open(data_json, "w") as f:
            json.dump(data, f)

        out = str(tmp_path / "draft")
        main([
            "--student", "test-tiny", "--teacher", "test-tiny",
            "--teacher-checkpoint", str(teacher_dir / "checkpoint-1"),
            "--train-data", data_json, "--output-dir", out,
            "--steps", "2", "--batch-size", "2", "--token-len", "16",
            "--save-every", "0", "--log-every", "1",
        ])
        assert os.path.isfile(
            os.path.join(out, "checkpoint-2", "model.safetensors")
        )

        # the run metadata must mark the encoder TRAINED so consumers
        # (serve --draft-checkpoint, bench) auto-pick the FULL overlay —
        # a decoder-only load would run the draft on a random encoder
        # and silently floor acceptance (r3 regression class)
        from whisper_ipa.models.convert import checkpoint_overlay_mode

        assert checkpoint_overlay_mode(
            os.path.join(out, "checkpoint-2")
        ) is True

"""Distill a DRAFT model from a fine-tuned target (speculation-aligned).

Independent training is not enough: a whisper-tiny trained on the SAME
data as its whisper-small target accepted little more than one token
per round — acceptance measures draft-target AGREEMENT, so the draft
must learn the target's distribution. This CLI trains a student against a frozen teacher checkpoint with
train/loss.compute_distill_loss ((1-a)*CE + a*T^2*KL) and writes a
standard checkpoint usable as `bench.py --draft-checkpoint` or
`cli/serve --continuous --draft-model <student>`.

  python -m whisper_ipa.cli.distill_draft \
      --student tiny --teacher small \
      --teacher-checkpoint ckpts/best-checkpoint --full-checkpoint \
      --train-data data/train_ipa.json --steps 2000 \
      --output-dir ckpts/draft-tiny
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Distill a speculative-decoding draft model"
    )
    p.add_argument("--student", default="tiny")
    p.add_argument("--teacher", default="small")
    p.add_argument("--teacher-checkpoint", required=True)
    p.add_argument(
        "--full-checkpoint", action="store_true",
        help="overlay ALL teacher tensors (encoder included) — required "
        "for checkpoints from full fine-tunes",
    )
    p.add_argument("--student-checkpoint", default=None,
                   help="warm-start the student from a checkpoint")
    p.add_argument("--train-data", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--alpha", type=float, default=0.7,
                   help="KL weight (1-alpha on data CE)")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--language", default="en")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--token-len", type=int, default=128,
                   help="fixed token width (one compiled step program)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--steps-per-call", type=int, default=8,
        help="optimizer steps per device dispatch (lax.scan over stacked "
        "batches; amortizes host dispatch + upload)",
    )
    p.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (micro-student distillation)",
    )
    args = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ..config import get_config
    from ..data.dataset import create_data_loader
    from ..models import load_checkpoint_model
    from ..train.checkpoints import save_checkpoint
    from ..train.step import TrainState
    from ..train.loop import load_or_init_params
    from ..train.loss import compute_distill_loss
    from ..train.optimizer import clip_by_per_tensor_norm

    s_cfg = get_config(args.student)
    t_cfg = get_config(args.teacher)
    if s_cfg.n_mels != t_cfg.n_mels:
        raise SystemExit(
            "student and teacher must share the mel size "
            f"({s_cfg.n_mels} vs {t_cfg.n_mels})"
        )

    teacher = load_or_init_params(args.teacher, t_cfg, None)
    teacher, n = load_checkpoint_model(
        args.teacher_checkpoint, teacher, full=args.full_checkpoint
    )
    print(f"Teacher: {n} tensors from {args.teacher_checkpoint}")
    student = load_or_init_params(args.student, s_cfg, None)
    if args.student_checkpoint:
        student, n = load_checkpoint_model(
            args.student_checkpoint, student, full=True
        )
        print(f"Student warm start: {n} tensors")

    dataset = create_data_loader(
        args.train_data,
        multilingual=s_cfg.multilingual,
        n_mels=s_cfg.n_mels,
        language=args.language,
        mel_cache_dir=args.mel_cache_dir,
    )
    print(f"{len(dataset)} training samples")
    eot = dataset.tokenizer.eot

    # Run metadata: the student trains its FULL tree (encoder included,
    # from random init — no pretrained weights exist offline), so every
    # consumer must use the full overlay, not the decoder-only reference
    # contract. checkpoint_overlay_mode() reads this from the parent of
    # each checkpoint-N dir, making load_checkpoint_auto (serve
    # --draft-checkpoint, eval CLIs) pick the right mode without
    # per-consumer hardcodes.
    import json as _json
    import os as _os

    _os.makedirs(args.output_dir, exist_ok=True)
    with open(
        _os.path.join(args.output_dir, "training_config.json"), "w"
    ) as f:
        _json.dump(
            {
                "training_args": {
                    "freeze_encoder": False,
                    "distilled_from": args.teacher_checkpoint,
                    "teacher_model": args.teacher,
                    "student_model": args.student,
                    "steps": args.steps,
                    "batch_size": args.batch_size,
                    "learning_rate": args.learning_rate,
                }
            },
            f,
            indent=2,
        )

    tx = optax.chain(
        clip_by_per_tensor_norm(1.0),
        optax.adamw(args.learning_rate),
    )
    opt_state = tx.init(student)

    @jax.jit
    def step(student, teacher, opt_state, mel, tokens):
        def loss_fn(sp):
            return compute_distill_loss(
                sp, teacher, s_cfg, t_cfg, mel, tokens, eot,
                alpha=args.alpha, temperature=args.temperature,
                dtype=jnp.bfloat16,
            )

        loss, grads = jax.value_and_grad(loss_fn)(student)
        updates, opt_state = tx.update(grads, opt_state, student)
        return optax.apply_updates(student, updates), opt_state, loss

    def pad_tokens(tok):
        """Fixed width -> one compiled step program across batches."""
        if tok.shape[1] >= args.token_len:
            out = tok[:, : args.token_len].copy()
            out[:, -1] = eot  # keep a terminal EOT on truncation
            return out
        pad = np.full(
            (tok.shape[0], args.token_len - tok.shape[1]), eot, np.int32
        )
        return np.concatenate([tok, pad], axis=1)

    # C steps per dispatch (fixed token width -> one stacked shape):
    # amortizes the host upload + dispatch, numerically the
    # same scan of the identical step body
    @jax.jit
    def chunk(student, teacher, opt_state, mels, toks):
        def body(carry, xs):
            st, os_ = carry
            mel_i, tok_i = xs
            st, os_, loss = step(st, teacher, os_, mel_i, tok_i)
            return (st, os_), loss

        (student, opt_state), losses = jax.lax.scan(
            body, (student, opt_state), (mels, toks)
        )
        return student, opt_state, losses

    from ..train.chunking import pow2_floor, stack_pad_batches

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    loss = None
    i = 0
    spc = max(1, args.steps_per_call)
    while i < args.steps:
        n = args.steps - i
        if args.save_every:
            n = min(n, args.save_every - i % args.save_every)
        n = pow2_floor(min(n, spc))
        batches = []
        for _ in range(n):
            idx = rng.choice(
                len(dataset), args.batch_size,
                replace=args.batch_size > len(dataset),
            )
            b = dataset.get_batch(idx.tolist())
            b["tokens"] = pad_tokens(np.asarray(b["tokens"]))
            batches.append(b)
        # bf16 mels: compute_distill_loss runs bf16 (entry-cast-exact)
        mels, toks = stack_pad_batches(batches, eot, bf16_mels=True)
        student, opt_state, losses = chunk(
            student, teacher, opt_state, jnp.asarray(mels),
            jnp.asarray(toks),
        )
        loss = losses[-1]
        prev, i = i, i + n
        if i % args.log_every < n or prev == 0:
            print(
                f"step {i}/{args.steps}: distill loss {float(loss):.4f} "
                f"({(time.time() - t0) / i:.2f} s/step)",
                flush=True,
            )
        if args.save_every and i % args.save_every == 0:
            save_checkpoint(
                TrainState(step=jnp.asarray(i), params=student,
                           opt_state=opt_state),
                i, float(loss), args.output_dir, save_opt_state=False,
            )

    path = save_checkpoint(
        TrainState(
            step=jnp.asarray(args.steps), params=student,
            opt_state=opt_state,
        ),
        args.steps, float(loss) if loss is not None else None,
        args.output_dir, save_opt_state=False,
    )
    print(f"Distilled draft saved -> {path}")


if __name__ == "__main__":
    main()

"""Train Medusa draft heads on a fine-tuned model's own data.

The base model stays FROZEN: each step teacher-forces one batch through
the decoder once, then fits the K residual heads (models/medusa.py) to
predict tokens k+2 positions ahead from the final hidden states. The
heads land in their own safetensors file, consumed by
`cli.serve --draft-model medusa --medusa-weights <file>` — the base
checkpoint format (reference scripts/train_whisper_ipa.py:410-443) is
untouched.

Usage:
  python -m whisper_ipa.cli.train_medusa \
      --model small --checkpoint checkpoints/best-checkpoint \
      --train-data data/train_ipa.json --steps 2000 \
      --n-heads 4 --output medusa_heads.safetensors
"""

from __future__ import annotations

import argparse
import time


def measure_head_accuracy(
    params,
    cfg,
    medusa,
    dataset,
    eot,
    batch_size: int = 8,
    seed: int = 0,
    top_c: int = 4,
    n_batches: int = 4,
    hidden_fn=None,
):
    """Per-head top-C hit rates on batches drawn from ``dataset``.

    Head k conditioned on h_t proposes the token at t+k+2; hits are
    counted against the actual tokens, masked past the first EOT.
    Returns a (n_heads x top_c) nested list — the payload
    decode.medusa_tree.optimize_tree maximizes expected acceptance
    from. Exposed standalone (--measure-only) so heads trained before
    the sidecar existed can get accuracy-optimized trees.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..models.medusa import medusa_propose_topk, valid_target_mask
    from ..models.whisper import decoder_hidden, encode

    if hidden_fn is None:
        hidden_fn = jax.jit(
            lambda p, mel, tok: decoder_hidden(
                p, cfg, tok, encode(p, cfg, mel, dtype=jnp.bfloat16),
                dtype=jnp.bfloat16,
            )
        )
    n_heads = len(medusa["heads"])
    hits = np.zeros((n_heads, top_c))
    totals = np.zeros(n_heads)
    eval_rng = np.random.default_rng(seed + 1)
    for _ in range(n_batches):
        idx = eval_rng.choice(len(dataset), batch_size, replace=True)
        batch = dataset.get_batch(idx)
        mel = jnp.asarray(batch["mel_features"])
        tokens = jnp.asarray(batch["tokens"])
        hidden = hidden_fn(params, mel, tokens)  # (B, T, d)
        B, T = tokens.shape
        topk = jax.vmap(
            lambda h: medusa_propose_topk(
                medusa, params, h, top_c, jnp.bfloat16
            ),
            in_axes=1, out_axes=1,
        )(hidden)  # (B, T, K, C)
        valid = np.asarray(valid_target_mask(tokens, eot))  # (B, T)
        topk_np = np.asarray(topk)
        tok_np = np.asarray(tokens)
        for k in range(n_heads):
            tgt_pos = np.arange(T) + k + 2
            ok = tgt_pos < T
            tgt = tok_np[:, np.minimum(tgt_pos, T - 1)]  # (B, T)
            mask = valid[:, np.minimum(tgt_pos, T - 1)] & ok[None, :]
            match = topk_np[:, :, k, :] == tgt[:, :, None]  # (B, T, C)
            for c in range(top_c):
                hits[k, c] += float((match[:, :, c] & mask).sum())
            totals[k] += float(mask.sum())
    return (hits / np.maximum(totals, 1.0)[:, None]).tolist()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train Medusa speculative-decoding heads "
        "(frozen base model)"
    )
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument(
        "--full-checkpoint", action="store_true",
        help="overlay ALL tensors from --checkpoint (encoder included) "
        "instead of the decoder-only reference contract — required for "
        "checkpoints from full fine-tunes (train --unfreeze-encoder), "
        "else the heads fit hidden states from a random encoder",
    )
    p.add_argument("--weights", default=None)
    p.add_argument("--train-data", required=True)
    p.add_argument("--output", default="medusa_heads.safetensors")
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--language", default="en")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--log-every", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--steps-per-call", type=int, default=8,
        help="head-optimizer steps per device dispatch (lax.scan over "
        "stacked batches; amortizes host dispatch + upload)",
    )
    p.add_argument(
        "--save-every", type=int, default=250,
        help="periodic head snapshot to <output>.partial (a killed run "
        "keeps its progress); 0 disables",
    )
    p.add_argument(
        "--measure-only", action="store_true",
        help="skip training: load EXISTING heads from --output, measure "
        "per-head top-C accuracy on --train-data, and (re)write the "
        "<output>.accuracy.json sidecar that tree_for_heads optimizes "
        "the verification tree from",
    )
    p.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend (head accuracy is "
        "hardware-independent, so --measure-only runs fine there)",
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
    from ..models.medusa import (
        init_medusa_params,
        save_medusa,
        train_medusa_step,
    )
    from ..models.whisper import decoder_hidden, encode
    from ..train.loop import load_or_init_params

    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights)
    if args.checkpoint:
        params, n = load_checkpoint_model(
            args.checkpoint, params, full=args.full_checkpoint
        )
        scope = "model" if args.full_checkpoint else "decoder"
        print(f"Loaded {n} {scope} tensors from {args.checkpoint}")

    dataset = create_data_loader(
        args.train_data,
        multilingual=cfg.multilingual,
        n_mels=cfg.n_mels,
        language=args.language,
        mel_cache_dir=args.mel_cache_dir,
    )
    print(f"{len(dataset)} training samples")

    eot = dataset.tokenizer.eot
    if args.measure_only:
        from ..decode.medusa_tree import optimize_tree
        from ..models.medusa import load_medusa

        medusa = load_medusa(args.output)
        probs = measure_head_accuracy(
            params, cfg, medusa, dataset, eot,
            batch_size=args.batch_size, seed=args.seed,
        )
        import json as _json

        sidecar = args.output + ".accuracy.json"
        with open(sidecar, "w") as f:
            _json.dump({"head_topk_accuracy": probs, "top_c": 4}, f)
        print(
            "head top-1 accuracy: "
            + ", ".join(f"{p[0]:.3f}" for p in probs)
            + f" -> {sidecar}"
        )
        print(f"optimized tree (12 nodes): {optimize_tree(probs, 12)}")
        return

    medusa = init_medusa_params(cfg, n_heads=args.n_heads, seed=args.seed)
    tx = optax.adam(args.learning_rate)
    opt_state = tx.init(medusa)

    # one frozen-model forward per batch; heads fit on the hidden states
    hidden_fn = jax.jit(
        lambda p, mel, tok: decoder_hidden(
            p, cfg, tok, encode(p, cfg, mel, dtype=jnp.bfloat16),
            dtype=jnp.bfloat16,
        )
    )
    # The frozen model params are explicit jit ARGUMENTS everywhere:
    # closing over them would embed ~1 GB of weight constants in the
    # lowered program.
    step_fn = jax.jit(
        lambda fp, mp, os, h, t: train_medusa_step(
            mp, os, tx, fp, cfg, h, t, eot
        )
    )

    # C steps per dispatch: the frozen-model forward + head update scan
    # on device over C stacked batches — one upload + one dispatch per
    # chunk instead of 2C (hidden_fn, step_fn) round trips. Trailing EOT
    # token pad is loss-exact (medusa_losses masks past the first EOT).
    def chunk_steps(fp, mp, os_, mels, toks):
        def body(carry, xs):
            mp, os_ = carry
            mel_i, tok_i = xs
            h = decoder_hidden(
                fp, cfg, tok_i,
                encode(fp, cfg, mel_i, dtype=jnp.bfloat16),
                dtype=jnp.bfloat16,
            )
            mp, os_, loss = train_medusa_step(
                mp, os_, tx, fp, cfg, h, tok_i, eot
            )
            return (mp, os_), loss

        (mp, os_), losses = jax.lax.scan(body, (mp, os_), (mels, toks))
        return mp, os_, losses

    chunk_fn = jax.jit(chunk_steps)

    from ..train.chunking import pow2_floor, stack_pad_batches

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    step = 0
    spc = max(1, args.steps_per_call)
    while step < args.steps:
        n = pow2_floor(min(spc, args.steps - step))
        batches = []
        for _ in range(n):
            idx = rng.choice(len(dataset), args.batch_size, replace=True)
            batches.append(dataset.get_batch(idx))
        if n == 1:
            mel = jnp.asarray(batches[0]["mel_features"])
            tokens = jnp.asarray(batches[0]["tokens"])
            hidden = hidden_fn(params, mel, tokens)
            medusa, opt_state, loss = step_fn(
                params, medusa, opt_state, hidden, tokens
            )
        else:
            mels, toks = stack_pad_batches(batches, eot, bf16_mels=True)
            medusa, opt_state, losses = chunk_fn(
                params, medusa, opt_state,
                jnp.asarray(mels), jnp.asarray(toks),
            )
            loss = losses[-1]
        prev, step = step, step + n
        if step % args.log_every < n or prev == 0:
            print(
                f"step {step}/{args.steps}: head loss {float(loss):.4f} "
                f"({(time.time() - t0) / step:.2f} s/step)",
                flush=True,
            )
        if args.save_every and step % args.save_every < n:
            # a run killed midway should cost minutes of head training,
            # not the whole run (heads are ~MBs)
            save_medusa(args.output + ".partial", medusa)

    save_medusa(args.output, medusa)
    print(f"saved {args.n_heads} heads -> {args.output}")

    # measure per-head top-C hit rates on held-back batches and write the
    # sidecar that decode.medusa_tree.tree_for_heads optimizes the
    # verification tree from (expected-acceptance-maximal static tree)
    import json as _json

    probs = measure_head_accuracy(
        params, cfg, medusa, dataset, eot,
        batch_size=args.batch_size, seed=args.seed,
        hidden_fn=hidden_fn,
    )
    sidecar = args.output + ".accuracy.json"
    with open(sidecar, "w") as f:
        _json.dump({"head_topk_accuracy": probs, "top_c": 4}, f)
    print(
        "head top-1 accuracy: "
        + ", ".join(f"{p[0]:.3f}" for p in probs)
        + f" -> {sidecar}"
    )


if __name__ == "__main__":
    main()

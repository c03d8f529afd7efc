"""Capture an XLA profile of the inference (or train) hot path and
print a per-op time table.

The reference has no profiler tooling at all (its speed story is the
out-of-process monitor, reference calculate_real_speed.py); this wraps
one traced execution in ``jax.profiler.trace`` and digests the xplane
protobuf into the op table that xprof/tensorboard would show — usable
headless over SSH.

Usage:
  python -m whisper_ipa.cli.profile_inference \
      --model small --batch 8 --sample-len 32 [--train] [--top 25] \
      [--logdir /tmp/whisper_prof] [--json out.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _op_table(logdir: str):
    """xplane.pb -> list of per-op rows (device ops, sorted by time)."""
    files = sorted(
        glob.glob(os.path.join(logdir, "**/*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    try:
        from xprof.convert import raw_to_tool_data as conv
    except ImportError:  # older wheel name
        from tensorboard_plugin_profile.convert import (
            raw_to_tool_data as conv,
        )
    data, _ = conv.xspace_to_tool_data([files[-1]], "framework_op_stats", {})
    tables = json.loads(data if isinstance(data, str) else data.decode())
    rows = []
    # the converter emits two tables (with/without IDLE) holding the same
    # device rows — read only the first that has any
    for table in tables:
        for r in table.get("rows", []):
            vals = [c.get("v") for c in r["c"]]
            if vals[1] != "Device":
                continue
            rows.append(
                {
                    "op": vals[3],
                    "type": vals[2],
                    "occurrences": int(vals[4] or 0),
                    # SELF time: wrapper rows (while/scan) report their
                    # whole body under total time and would double-count
                    "self_ms": (vals[7] or 0.0) / 1000.0,
                    "avg_us": vals[8] or 0.0,
                    "gbytes_per_sec": vals[15] or 0.0,
                    "gflops_per_sec": vals[14] or 0.0,
                    "bound_by": vals[17],
                }
            )
        if rows:
            break
    rows.sort(key=lambda r: -r["self_ms"])
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Profile the decode (or train) hot path on the "
        "current accelerator and print a per-op time table"
    )
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--sample-len", type=int, default=32)
    p.add_argument("--beam", type=int, default=0,
                   help="profile beam search at this width (0 = greedy)")
    p.add_argument("--train", action="store_true",
                   help="profile one train step instead of decode")
    p.add_argument("--cached-features", action="store_true",
                   help="with --train: feed precomputed encoder outputs "
                   "(the cache_encoder=True fine-tune regime)")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--logdir", default="/tmp/whisper_ipa_profile")
    p.add_argument("--json", default=None,
                   help="also write the full op table to this JSON file")
    args = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..audio import N_SAMPLES
    from ..config import get_config
    from ..models import init_params
    from ..audio.mel import log_mel_spectrogram_jax
    from ..tokenizer import get_tokenizer

    cfg = get_config(args.model)
    params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)

    if args.train:
        from ..train import create_train_state, train_step

        mel = jnp.asarray(
            rng.standard_normal((args.batch, 3000, cfg.n_mels)).astype(
                np.float32
            )
        )
        tok = np.full((args.batch, 48), 300, np.int32)
        tok[:, :4] = [50258, 50259, 50359, 50363]
        tok[:, -1] = 50257
        tokens = jnp.asarray(tok)
        if args.cached_features:
            from ..models.whisper import encode

            mel = jax.jit(
                lambda p, m: encode(p, cfg, m, dtype=jnp.bfloat16)
            )(params, mel)
        state, tx = create_train_state(params, learning_rate=1e-5,
                                       freeze_encoder=True)

        def run(state):
            state, loss = train_step(
                state, mel, tokens, cfg, tx, 50257,
                freeze_encoder=True, dtype_name="bfloat16",
                inputs_are_features=args.cached_features,
            )
            float(loss)
            return state

        t0 = time.time()
        state = run(state)  # compile
        print(f"# compiled in {time.time()-t0:.0f}s", file=sys.stderr)
        with jax.profiler.trace(args.logdir):
            run(state)
    else:
        from ..decode import DecodingOptions, decode

        tokenizer = get_tokenizer(
            multilingual=cfg.multilingual,
            num_languages=cfg.num_languages, language="en",
        )
        audio = jnp.asarray(
            rng.standard_normal((args.batch, N_SAMPLES)).astype(np.float32)
            * 0.1
        )
        mel = jax.jit(
            lambda a: log_mel_spectrogram_jax(a, n_mels=cfg.n_mels)
        )(audio)
        options = DecodingOptions(
            language="en", without_timestamps=True,
            sample_len=args.sample_len,
            suppress_tokens=[-1, tokenizer.eot],
            fp16=True, kv_int8=True,
            beam_size=args.beam or None,
            length_penalty=1.0 if args.beam else None,
        )
        t0 = time.time()
        decode(params, cfg, mel, options, tokenizer=tokenizer)  # compile
        print(f"# compiled in {time.time()-t0:.0f}s", file=sys.stderr)
        with jax.profiler.trace(args.logdir):
            decode(params, cfg, mel, options, tokenizer=tokenizer)

    rows = _op_table(args.logdir)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    total = sum(r["self_ms"] for r in rows)
    print(f"{'total device ms':>15s}: {total:9.1f}   "
          f"(device {jax.devices()[0].device_kind})")
    print(f"{'ms':>9s} {'n':>6s} {'GB/s':>6s} {'bound':>8s}  op")
    for r in rows[: args.top]:
        name = r["op"]
        if len(name) > 80:
            name = "…" + name[-79:]
        print(
            f"{r['self_ms']:9.1f} {r['occurrences']:6d} "
            f"{r['gbytes_per_sec']:6.0f} {str(r['bound_by']):>8s}  {name}"
        )


if __name__ == "__main__":
    main()

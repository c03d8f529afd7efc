"""Per-language held-out report for a corpus-scale checkpoint.

The multipa paper (IPA_PAPER.pdf Tables 3-4; reference
scripts/evaluate_model.py:235-268 restates the overall targets) reports
recognition quality PER LANGUAGE; the production validate() path only
aggregates. This script decodes the full held-out split with a trained
checkpoint and breaks PER/PFER down by locale, plus the top phone
confusions (metrics/analysis.py), writing a JSON artifact next to the
checkpoint.

Run (add --cpu to force the CPU backend):
  python examples/corpus_report.py --run-dir /tmp/corpus_cputiny/run_tiny \
      --data /tmp/corpus/data/test.json --model tiny \
      --mel-cache-dir /tmp/corpus/melcache --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="default: <run-dir>/best-checkpoint")
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="tiny")
    p.add_argument("--mel-cache-dir", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--sample-len", type=int, default=None,
                   help="decode cap (default: model n_text_ctx budget)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=None,
                   help="default: <run-dir>/corpus_report.json")
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from whisper_ipa.config import get_config
    from whisper_ipa.data.dataset import create_data_loader
    from whisper_ipa.decode import DecodingOptions, decode
    from whisper_ipa.metrics.analysis import confusion_analysis
    from whisper_ipa.metrics.evaluate import evaluate_batch
    from whisper_ipa.models import load_checkpoint_model
    from whisper_ipa.train.loop import load_or_init_params

    ckpt = args.checkpoint or os.path.join(args.run_dir, "best-checkpoint")
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, None)
    params, n_loaded = load_checkpoint_model(ckpt, params, full=True)
    print(f"loaded {n_loaded} tensors from {ckpt}")

    ds = create_data_loader(
        args.data, n_mels=cfg.n_mels, mel_cache_dir=args.mel_cache_dir
    )
    entries = ds.data  # locales come from the same parsed list
    n = min(args.num_samples or len(ds), len(ds))
    options = DecodingOptions(
        language=None,
        without_timestamps=True,
        length_penalty=1.0,
        **({"sample_len": args.sample_len} if args.sample_len else {}),
    )

    refs, hyps, locales = [], [], []
    t0 = time.time()
    for start in range(0, n, args.batch):
        idx = list(range(start, min(start + args.batch, n)))
        # pad the tail batch to the full batch size (repeat the last
        # index) so every decode call shares ONE compiled program —
        # decode() compiles per batch shape, and a greedy compile costs
        # tens of seconds; pad rows are dropped below
        n_real = len(idx)
        padded = idx + [idx[-1]] * (args.batch - n_real)
        batch = ds.get_batch(padded)
        results = decode(
            params, cfg, jnp.asarray(batch["mel_features"]), options,
            tokenizer=ds.tokenizer,
        )
        for k, i in enumerate(idx):
            refs.append(batch["ipa_texts"][k].strip())
            hyps.append(results[k].text.strip())
            locales.append(entries[i].get("locale") or "unknown")
        done = start + len(idx)
        rate = done / (time.time() - t0)
        print(
            f"  {done}/{n} decoded ({rate:.2f} utt/s, "
            f"eta {(n - done) / rate:.0f}s)",
            flush=True,
        )

    overall = evaluate_batch(refs, hyps)
    by_locale = {}
    groups = defaultdict(list)
    for r, h, loc in zip(refs, hyps, locales):
        groups[loc].append((r, h))
    for loc in sorted(groups):
        pairs = groups[loc]
        m = evaluate_batch([r for r, _ in pairs], [h for _, h in pairs])
        by_locale[loc] = {
            "per": m["per"], "pfer": m["pfer"], "n": len(pairs),
        }

    conf = confusion_analysis(refs, hyps)

    report = {
        "checkpoint": ckpt,
        "model": args.model,
        "n_scored": len(refs),
        "overall": {"per": overall["per"], "pfer": overall["pfer"],
                    "per_std": overall["per_std"],
                    "pfer_std": overall["pfer_std"]},
        "by_locale": by_locale,
        "phone_accuracy": conf["phone_accuracy"],
        "top_substitutions": [
            [r, h, c] for (r, h), c in conf["top_substitutions"]
        ],
        "top_insertions": [[h, c] for h, c in conf["top_insertions"]],
        "top_deletions": [[r, c] for r, c in conf["top_deletions"]],
        "per_dist": conf["per"],
        "pfer_dist": conf["pfer"],
    }
    out = args.out or os.path.join(args.run_dir, "corpus_report.json")
    with open(out, "w") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)

    print(f"\n{'locale':<10} {'n':>5} {'PER%':>8} {'PFER%':>8}")
    for loc, m in sorted(by_locale.items()):
        print(f"{loc:<10} {m['n']:>5} {m['per']:>8.2f} {m['pfer']:>8.2f}")
    print(
        f"{'OVERALL':<10} {len(refs):>5} {overall['per']:>8.2f} "
        f"{overall['pfer']:>8.2f}"
    )
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()

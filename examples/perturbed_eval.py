"""Acoustic train/test decoupling: evaluate a trained checkpoint on
perturbed versions of the held-out synthetic test split.

Every corpus-scale learning number so far used the SAME formant
synthesizer for train and test audio. The paper's zero-shot setting is natural speech — unreachable
offline — so the closest offline proxy is ACOUSTIC MISMATCH: corrupt the
held-out split with conditions the model never saw (additive noise at
several SNRs, synthetic room reverb, unseen speaker realizations via
f0/duration jitter + fresh synthesis seeds) and measure the PER/PFER
degradation through the exact evaluate path (round-5 verdict item 6;
ref anchor PROJECT_PLAN.md:5, the 21.2% zero-shot PFER target).

Run:
  python examples/perturbed_eval.py \
      --run-dir artifacts/corpus/run_small --model small \
      --data artifacts/corpus/data/test.json --batch 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def add_noise(audio: np.ndarray, snr_db: float, rng) -> np.ndarray:
    p_sig = float(np.mean(audio**2)) + 1e-12
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return audio + rng.standard_normal(len(audio)).astype(np.float32) * (
        p_noise**0.5
    )


def add_reverb(audio: np.ndarray, rt60: float = 0.3, sr: int = 16000,
               rng=None) -> np.ndarray:
    """Synthetic room impulse response: exponentially-decaying noise."""
    n = int(rt60 * sr)
    t = np.arange(n) / sr
    rir = (rng.standard_normal(n) * np.exp(-6.9 * t / rt60)).astype(
        np.float32
    )
    rir[0] = 1.0  # direct path
    rir /= np.sqrt(np.sum(rir**2))
    wet = np.convolve(audio, rir)[: len(audio)].astype(np.float32)
    peak = np.max(np.abs(wet)) + 1e-9
    return wet / peak * (np.max(np.abs(audio)) + 1e-9)


def resynth_speaker(entry: dict, idx: int) -> np.ndarray:
    """Unseen speaker realization: jittered f0/duration, fresh seed."""
    from whisper_ipa.data.synth import synthesize_ipa

    rng = np.random.default_rng(777_000 + idx)
    f0 = float(rng.uniform(70.0, 260.0))  # outside no one speaker's range
    dur = float(rng.uniform(0.08, 0.16))
    return synthesize_ipa(
        entry["ipa_transcription"], duration=dur, f0=f0,
        seed=999_000_000 + idx,  # disjoint from every training seed
    ).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run-dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--sample-len", type=int, default=64)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument(
        "--conditions", nargs="+",
        default=["clean", "snr20", "snr10", "snr5", "reverb",
                 "snr10+reverb", "speaker"],
    )
    args = p.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from whisper_ipa.audio import load_audio, log_mel_spectrogram, pad_or_trim
    from whisper_ipa.config import get_config
    from whisper_ipa.decode import DecodingOptions, decode
    from whisper_ipa.metrics.evaluate import evaluate_batch
    from whisper_ipa.models import load_checkpoint_model
    from whisper_ipa.tokenizer import get_tokenizer
    from whisper_ipa.train.loop import load_or_init_params

    ckpt = args.checkpoint or os.path.join(args.run_dir, "best-checkpoint")
    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, None)
    params, n_loaded = load_checkpoint_model(ckpt, params, full=True)
    print(f"loaded {n_loaded} tensors from {ckpt}")
    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual, num_languages=cfg.num_languages
    )

    with open(args.data) as f:
        entries = json.load(f)
    if args.num_samples:
        entries = entries[: args.num_samples]
    n = len(entries)
    options = DecodingOptions(
        language=None, without_timestamps=True, length_penalty=1.0,
        sample_len=args.sample_len,
    )

    def perturb(audio: np.ndarray, cond: str, idx: int) -> np.ndarray:
        rng = np.random.default_rng(123_000 + idx)
        for part in cond.split("+"):
            if part == "clean":
                pass
            elif part.startswith("snr"):
                audio = add_noise(audio, float(part[3:]), rng)
            elif part == "reverb":
                audio = add_reverb(audio, rng=rng)
            elif part == "speaker":
                audio = resynth_speaker(entries[idx], idx)
            else:
                raise ValueError(f"unknown condition {part!r}")
        return audio

    report = {"checkpoint": ckpt, "model": args.model, "n": n,
              "conditions": {}}
    for cond in args.conditions:
        refs, hyps = [], []
        t0 = time.time()
        for start in range(0, n, args.batch):
            idx = list(range(start, min(start + args.batch, n)))
            n_real = len(idx)
            padded = idx + [idx[-1]] * (args.batch - n_real)
            mels = []
            for i in padded:
                audio = load_audio(entries[i]["audio_path"])
                if cond != "clean":
                    audio = perturb(audio, cond, i)
                mels.append(
                    log_mel_spectrogram(
                        pad_or_trim(audio), n_mels=cfg.n_mels
                    )
                )
            results = decode(
                params, cfg, jnp.asarray(np.stack(mels)), options,
                tokenizer=tokenizer,
            )
            for k, i in enumerate(idx):
                refs.append(entries[i]["ipa_transcription"].strip())
                hyps.append(results[k].text.strip())
        m = evaluate_batch(refs, hyps)
        dt = time.time() - t0
        report["conditions"][cond] = {
            "per": m["per"], "pfer": m["pfer"],
            "per_std": m["per_std"], "pfer_std": m["pfer_std"],
            "elapsed_s": round(dt, 1),
        }
        print(
            f"{cond:>12}: PER {m['per']:.2f}%  PFER {m['pfer']:.2f}%  "
            f"({n} utts, {dt:.0f}s)",
            flush=True,
        )

    out = args.out or os.path.join(args.run_dir, "perturbed_eval.json")
    with open(out, "w") as f:
        json.dump(report, f, ensure_ascii=False, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

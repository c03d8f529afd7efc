"""End-to-end A/B of weight-quantized greedy decode on the local device.

Measures `decode()` at serving shapes (whisper-small, batch 16, forced
sample_len) across weight formats: f32, int8 weight-only and int4
(models/layers.linear dequantizes in the consuming matmul).

  python -m whisper_ipa.cli.bench_quant_decode --batch 16
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="small")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--sample-len", type=int, default=32)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--modes", default="f32,int8,int4",
        help="comma list of f32,int8,int4",
    )
    args = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..audio import N_SAMPLES
    from ..config import get_config
    from ..decode import DecodingOptions, decode
    from ..models import init_params
    from ..audio.mel import log_mel_spectrogram_jax
    from ..ops.quant import quantize_params
    from ..tokenizer import get_tokenizer

    cfg = get_config(args.model)
    params = init_params(cfg, seed=0)
    tokenizer = get_tokenizer(
        multilingual=True, num_languages=cfg.num_languages, language="en"
    )
    rng = np.random.default_rng(0)
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
        suppress_tokens=[-1, tokenizer.eot],  # full-length decode
        fp16=True,
    )

    variants = {}
    for mode in args.modes.split(","):
        if mode == "f32":
            variants[mode] = params
        elif mode == "int8":
            variants[mode] = quantize_params(params, bits=8)
        elif mode == "int4":
            variants[mode] = quantize_params(params, bits=4)
        else:
            raise SystemExit(f"unknown mode {mode}")

    for name, pp in variants.items():
        t0 = time.time()
        decode(pp, cfg, mel, options, tokenizer=tokenizer)
        compile_s = time.time() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            decode(pp, cfg, mel, options, tokenizer=tokenizer)
            best = min(best, time.time() - t0)
        print(
            f"{name:12s} {best * 1000:7.1f} ms/decode "
            f"({best / args.sample_len * 1000:6.2f} ms/token, "
            f"compile {compile_s:.0f}s)"
        )


if __name__ == "__main__":
    main()

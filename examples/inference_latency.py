"""Transcription latency probe on synthesized audio.

The JAX equivalent of the reference's MLX inference PoC
(scripts/experimental/inference_mlx.py): synthesize a dummy waveform,
transcribe it, report latency (first call includes XLA compile).

  python examples/inference_latency.py [model]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from whisper_ipa.config import CONFIGS, get_config
    from whisper_ipa.data.synth import synthesize_ipa
    from whisper_ipa.decode import transcribe
    from whisper_ipa.models import init_params

    name = sys.argv[1] if len(sys.argv) > 1 else "test-tiny"
    cfg = CONFIGS.get(name) or get_config(name)
    params = init_params(cfg, seed=0)

    audio = synthesize_ipa("kæt siː ʃuː aːm")
    print(f"model={cfg.name}, audio {len(audio) / 16000:.2f}s")

    t0 = time.time()
    result = transcribe(params, cfg, audio, language="en", temperature=0.0)
    print(f"first call (incl. compile): {time.time() - t0:.1f}s")

    t0 = time.time()
    result = transcribe(params, cfg, audio, language="en", temperature=0.0)
    dt = time.time() - t0
    print(f"steady state: {dt * 1e3:.0f} ms "
          f"({len(audio) / 16000 / dt:.1f}x realtime)")
    print(f"text (random weights => gibberish): {result['text'][:60]!r}")


if __name__ == "__main__":
    main()

"""CLI: transcribe arbitrary-length audio files (chunked, batched).

General entry point over decode.transcribe(): splits audio into 30 s
windows, runs them as ONE device batch, applies the temperature-fallback
ladder, prints text or JSON. (The reference exposed this only through
mlx_whisper.transcribe inside evaluate_model.py:114.)
"""

import argparse
import json as _json

from ..config import get_config
from ..decode import transcribe
from ..models import load_checkpoint_auto
from ..train.loop import load_or_init_params


def main(argv=None):
    p = argparse.ArgumentParser(description="Transcribe audio to IPA/text")
    p.add_argument("audio", nargs="+", help="Audio file(s)")
    p.add_argument("--model", default="small")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--language", default="en")
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--json", action="store_true", help="Emit JSON per file")
    from . import add_overlay_flags

    add_overlay_flags(p)
    args = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = get_config(args.model)
    params = load_or_init_params(args.model, cfg, args.weights)
    if args.checkpoint:
        params, n = load_checkpoint_auto(
            args.checkpoint, params, args.full_ckpt
        )
        print(f"# loaded {n} tensors from {args.checkpoint}")

    for path in args.audio:
        result = transcribe(
            params,
            cfg,
            path,
            language=args.language,
            temperature=args.temperature,
            beam_size=args.beam_size,
            fp16=args.bf16,
        )
        if args.json:
            print(_json.dumps({"file": path, **result}, ensure_ascii=False))
        else:
            print(f"{path}\t{result['text']}")


if __name__ == "__main__":
    main()

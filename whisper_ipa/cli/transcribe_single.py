"""CLI: single-utterance checkpoint -> IPA transcription.

Reference surface: scripts/transcribe_single.py (which hard-codes its
checkpoint/audio paths; here they are proper arguments with the same
defaults).
"""

import argparse

from ..audio import load_audio, log_mel_spectrogram, pad_or_trim
from ..config import get_config
from ..decode import DecodingOptions, decode
from ..models import load_checkpoint_auto
from ..tokenizer import get_tokenizer
from ..train.loop import load_or_init_params


def transcribe_file(params, cfg, audio_path: str, language: str = "en") -> str:
    print(f"Transcribing {audio_path}...")
    audio = pad_or_trim(load_audio(audio_path))
    mel = log_mel_spectrogram(audio, n_mels=cfg.n_mels)[None]
    tokenizer = get_tokenizer(
        multilingual=cfg.multilingual,
        num_languages=cfg.num_languages,
        language=language,
    )
    options = DecodingOptions(language=language, without_timestamps=True)
    result = decode(params, cfg, mel, options, tokenizer=tokenizer)
    return result[0].text.strip()


def main(argv=None):
    p = argparse.ArgumentParser(description="Transcribe one file to IPA")
    p.add_argument(
        "--checkpoint", type=str, default="checkpoints/whisper-ipa/checkpoint-8000"
    )
    p.add_argument(
        "--base-model", type=str, default="mlx-community/whisper-large-v3-mlx"
    )
    p.add_argument("--audio", type=str, default="4.wav")
    p.add_argument("--language", type=str, default="en")
    p.add_argument("--weights", type=str, default=None)
    from . import add_overlay_flags

    add_overlay_flags(p)
    args = p.parse_args(argv)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = get_config(args.base_model)
    params = load_or_init_params(args.base_model, cfg, args.weights)
    params, n_loaded = load_checkpoint_auto(
        args.checkpoint, params, args.full_ckpt
    )
    print(f"Loaded {n_loaded} tensors")

    transcription = transcribe_file(params, cfg, args.audio, args.language)
    print("\n" + "=" * 50)
    print(f"Audio: {args.audio}")
    print(f"Prediction: {transcription}")
    print("=" * 50)


if __name__ == "__main__":
    main()

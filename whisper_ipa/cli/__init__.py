"""Command-line entry points (python -m whisper_ipa.cli.<name>).

Mirrors the reference's script surface:
  train_whisper_ipa      training loop
  evaluate_model         checkpoint evaluation + base-model comparison
  transcribe_single      single-utterance transcription
  evaluate_ipa           metric self-test
  compute_iaa            inter-annotator agreement oracle
  parse_zeroshot_test    zero-shot test set assembly
  prepare_datasets       corpus preparation subcommands
  calculate_real_speed   out-of-process training monitor
  benchmark_models       model-size parameter/throughput benchmarks

Beyond the reference surface:
  serve                  batching/continuous HTTP inference server
  profile_inference      xprof capture + per-op time table (headless)
  train_medusa           fit speculative-decoding draft heads (frozen base)
  error_analysis         phone-confusion analysis
  transcribe / convert_weights / check_vocab / evaluate_zeroshot
"""


def add_overlay_flags(parser):
    """--full-checkpoint / --decoder-only on checkpoint-loading CLIs.

    Default (neither flag) auto-detects from the run's
    training_config.json (models.convert.checkpoint_overlay_mode):
    full-fine-tune checkpoints get the full overlay, reference-style
    frozen-encoder checkpoints keep the decoder-only contract.
    """
    g = parser.add_mutually_exclusive_group()
    g.add_argument(
        "--full-checkpoint", dest="full_ckpt", action="store_true",
        default=None,
        help="overlay ALL tensors (encoder included) — for checkpoints "
        "from full fine-tunes (freeze_encoder=false); default: auto",
    )
    g.add_argument(
        "--decoder-only", dest="full_ckpt", action="store_false",
        help="force the decoder-only reference overlay contract",
    )
    return parser

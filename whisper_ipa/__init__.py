"""whisper_ipa: a JAX speech-to-IPA framework.

A ground-up JAX/XLA re-design of the capabilities of the
barathanaslan/whisper-ipa research pipeline (fine-tuning Whisper to emit IPA
phonetic transcriptions): audio frontend, Whisper encoder/decoder, KV-cached
decoding, decoder-only fine-tuning, phonetic metrics (PER/PFER), dataset
preparation, and data- and tensor-parallel training over device meshes.

Layout:
  audio/      host audio IO + log-mel frontend (NumPy reference + JAX)
  tokenizer/  Whisper BPE tokenizer (tiktoken-rank compatible) + special tokens
  models/     pure-JAX Whisper encoder/decoder + weight conversion
  ops/        plain-JAX ops: blockwise CE, weight quantization
  decode/     KV-cached greedy/beam decoding under jit
  train/      loss, jitted train step, optimizer, checkpoints, training loop
  parallel/   device mesh construction + sharding rules (DP/TP/FSDP)
  metrics/    IPA segmentation, PER, PFER (Hamming + cosine), feature table
  data/       JSON datasets, batching/prefetch, corpus preparation (prep/)
  cli/        command-line entry points mirroring the reference scripts
"""

__version__ = "0.1.0"

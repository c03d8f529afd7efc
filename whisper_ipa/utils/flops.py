"""Analytic FLOP model for Whisper forward/decode/train steps.

Used by bench.py and the training benchmark to report MFU (model FLOPs
utilization = achieved FLOP/s over the chip's peak) alongside wall-clock
numbers. Counts multiply-accumulates as 2 FLOPs, the standard convention
(PaLM appendix B / "How to Scale Your Model" accounting).

The reference repo reports only samples/s and RTF
(scripts/experimental/benchmark_models_simple.py:50-53); MFU is the
chip-utilization ground truth those numbers hide.
"""

from __future__ import annotations

from typing import Optional

from ..config import WhisperConfig

# Dense bf16 tensor-core peak FLOP/s (no sparsity), keyed on JAX's
# device_kind. Source: NVIDIA H100 Tensor Core GPU data sheet, whose
# figures are quoted with sparsity and are halved here. A device missing
# from the table has no peak: MFU is then reported as null.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756.5e12,
}


def peak_flops(device_kind: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s for a jax device_kind string, None if unknown."""
    return PEAK_BF16_FLOPS.get(device_kind)


def mel_flops(cfg: WhisperConfig, n_frames: int = 3000) -> float:
    """Log-mel frontend (matmul-DFT formulation) per utterance."""
    n_fft = 400
    n_bins = n_fft // 2 + 1
    dft = 2.0 * n_frames * n_fft * n_bins * 2  # real+imag matmuls
    mel = 2.0 * n_frames * n_bins * cfg.n_mels
    return dft + mel


def encoder_flops(cfg: WhisperConfig) -> float:
    """Full encoder forward per utterance (convs + transformer stack)."""
    T = cfg.n_audio_ctx  # 1500
    d = cfg.n_audio_state
    conv1 = 2.0 * (2 * T) * 3 * cfg.n_mels * d  # k=3, stride 1, 3000 frames
    conv2 = 2.0 * T * 3 * d * d  # k=3, stride 2 -> 1500 frames
    per_layer = (
        8.0 * T * d * d  # q,k,v,o projections
        + 4.0 * T * T * d  # scores + attention-weighted values
        + 16.0 * T * d * d  # MLP (d -> 4d -> d)
    )
    return conv1 + conv2 + cfg.n_audio_layer * per_layer


def decoder_flops(
    cfg: WhisperConfig, n_tokens: int, n_prefix: int = 4
) -> float:
    """KV-cached autoregressive decode of n_tokens after an n_prefix prompt.

    Counts the one-time cross-attention K/V projection of the encoder
    output, the per-token projections/MLP/logits, and the growing
    self-attention window.
    """
    T_enc = cfg.n_audio_ctx
    d = cfg.n_text_state
    L = cfg.n_text_layer
    n = n_prefix + n_tokens

    cross_kv_once = 4.0 * T_enc * d * d * L  # k,v proj over encoder output
    per_token_layer = (
        8.0 * d * d  # self q,k,v,o
        + 4.0 * d * d  # cross q,o
        + 16.0 * d * d  # MLP
        + 4.0 * T_enc * d  # cross scores + values
    )
    # self-attention window grows 1..n: sum t = n(n+1)/2
    self_window = 4.0 * d * (n * (n + 1) / 2.0) * L
    logits = 2.0 * d * cfg.n_vocab * n
    return cross_kv_once + per_token_layer * L * n + self_window + logits


def inference_flops(
    cfg: WhisperConfig,
    n_tokens: int,
    n_prefix: int = 4,
    with_mel: bool = True,
) -> float:
    """Whole pipeline per 30 s utterance: mel + encoder + greedy decode."""
    total = encoder_flops(cfg) + decoder_flops(cfg, n_tokens, n_prefix)
    if with_mel:
        total += mel_flops(cfg)
    return total


def train_step_flops(
    cfg: WhisperConfig, token_len: int, freeze_encoder: bool = True
) -> float:
    """One teacher-forced train step per sample (frozen-encoder fine-tune).

    Forward-only encoder (frozen) + decoder forward and backward (backward
    ~2x forward for matmul-dominated stacks, the standard estimate).
    """
    T_enc = cfg.n_audio_ctx
    d = cfg.n_text_state
    L = cfg.n_text_layer
    n = token_len

    dec_fwd = (
        4.0 * T_enc * d * d * L  # cross k,v over encoder output
        + (28.0 * d * d + 4.0 * T_enc * d) * L * n  # proj/MLP/cross scores
        + 4.0 * d * (n * n / 2.0) * L  # causal self-attention
        + 2.0 * d * cfg.n_vocab * n  # logits
    )
    enc = encoder_flops(cfg)
    enc_total = enc if freeze_encoder else 3.0 * enc
    return enc_total + 3.0 * dec_fwd

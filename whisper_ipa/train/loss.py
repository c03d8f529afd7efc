"""Teacher-forced cross-entropy with the first-EOT-kept mask.

The subtlety (reference scripts/train_whisper_ipa.py:238-247): padding uses
the EOT token, so the loss must keep exactly the FIRST EOT of each target
row (the model must learn to stop) while masking the rest. A cumulative sum
over the EOT indicator implements "is the first EOT" as cumsum == 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import WhisperConfig
from ..models.whisper import decoder_logits, encode


def eot_loss_mask(target_tokens, eot: int):
    """True where loss is computed: non-EOT tokens plus the first EOT."""
    is_eot = target_tokens == eot
    eot_cumsum = jnp.cumsum(is_eot.astype(jnp.int32), axis=1)
    return (~is_eot) | (eot_cumsum == 1)


def masked_cross_entropy(logits, targets, mask):
    """Mean CE over masked positions. logits float32 (B, T, V)."""
    logprobs = jax.nn.log_softmax(logits, axis=-1)
    token_lp = jnp.take_along_axis(
        logprobs, targets[..., None], axis=-1
    )[..., 0]
    losses = -token_lp * mask.astype(logits.dtype)
    num_valid = jnp.maximum(mask.sum(), 1)
    return losses.sum() / num_valid


def compute_loss(
    params,
    cfg: WhisperConfig,
    mel,
    tokens,
    eot: int,
    *,
    audio_features=None,
    freeze_encoder: bool = True,
    dtype=jnp.float32,
    remat: bool = False,
    blockwise: bool = False,
    bf16_head: bool = False,
):
    """CE loss for a batch (reference compute_loss surface).

    mel: (B, 3000, n_mels); tokens: (B, S) with SOT sequence + IPA + EOT
    padding. When freeze_encoder (the reference's decoder-only regime), the
    encoder runs under stop_gradient so no encoder grads are materialized.
    """
    if audio_features is None:
        audio_features = encode(
            params, cfg, mel, dtype=dtype,
            remat=remat and not freeze_encoder,
        )
        if freeze_encoder:
            audio_features = jax.lax.stop_gradient(audio_features)

    decoder_input = tokens[:, :-1]
    target_tokens = tokens[:, 1:]
    mask = eot_loss_mask(target_tokens, eot)

    if blockwise:
        # memory-efficient path: never materializes (B, T, V) logits
        from ..models.whisper import decoder_hidden
        from ..ops.blockwise_ce import blockwise_cross_entropy

        hidden = decoder_hidden(
            params, cfg, decoder_input, audio_features, dtype=dtype,
            remat=remat,
        )
        B, T, d = hidden.shape
        return blockwise_cross_entropy(
            hidden.astype(jnp.float32).reshape(B * T, d),
            params["decoder"]["token_embedding"],
            target_tokens.reshape(B * T),
            mask.reshape(B * T),
        )

    logits = decoder_logits(
        params, cfg, decoder_input, audio_features, dtype=dtype,
        remat=remat, bf16_head=bf16_head,
    )
    return masked_cross_entropy(logits, target_tokens, mask)


def compute_distill_loss(
    student_params,
    teacher_params,
    student_cfg: WhisperConfig,
    teacher_cfg: WhisperConfig,
    mel,
    tokens,
    eot: int,
    *,
    alpha: float = 0.5,
    temperature: float = 2.0,
    dtype=jnp.float32,
):
    """Draft distillation: CE to the data + KL to the TEACHER's logits.

    A draft trained independently on the same data accepted little more
    than one token per round against the target — both models were wrong
    in their own ways. Speculative acceptance measures draft-TARGET
    agreement, so the draft must be trained toward the target's own
    distribution, not just the data: loss = (1-alpha) * CE(student,
    data) + alpha * T^2 * KL(teacher_T || student_T) over the same
    first-EOT-kept mask (Hinton et al. 2015 scaling).

    The teacher runs under stop_gradient (frozen); models may differ in
    size but must share the tokenizer and mel shape.
    """
    if student_cfg.n_vocab != teacher_cfg.n_vocab:
        raise ValueError("student and teacher must share the vocabulary")

    decoder_input = tokens[:, :-1]
    target_tokens = tokens[:, 1:]
    mask = eot_loss_mask(target_tokens, eot)

    s_feats = encode(student_params, student_cfg, mel, dtype=dtype)
    s_logits = decoder_logits(
        student_params, student_cfg, decoder_input, s_feats, dtype=dtype
    )

    t_feats = encode(teacher_params, teacher_cfg, mel, dtype=dtype)
    t_logits = decoder_logits(
        teacher_params, teacher_cfg, decoder_input, t_feats, dtype=dtype
    )
    t_logits = jax.lax.stop_gradient(t_logits)

    ce = masked_cross_entropy(s_logits, target_tokens, mask)

    T = temperature
    t_lp = jax.nn.log_softmax(t_logits / T, axis=-1)
    s_lp = jax.nn.log_softmax(s_logits / T, axis=-1)
    kl_tok = (jnp.exp(t_lp) * (t_lp - s_lp)).sum(-1)  # (B, T)
    num_valid = jnp.maximum(mask.sum(), 1)
    kl = (kl_tok * mask.astype(kl_tok.dtype)).sum() / num_valid

    return (1.0 - alpha) * ce + alpha * (T * T) * kl

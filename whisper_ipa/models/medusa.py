"""Medusa-style draft heads: one-shot multi-token proposals for
speculative decoding.

K small residual heads sit on the decoder's final hidden state h_t; head
k predicts token t+k+1 through the tied embedding (Medusa-1, Cai et al.
2024 — the reference repo has no speculative machinery at all; this is a
extension over reference scripts/evaluate_model.py's greedy
loop). Heads are a SEPARATE parameter tree stored in their own
safetensors file, so the reference checkpoint contract
(reference scripts/train_whisper_ipa.py:410-443) is untouched.

Training (train_medusa_step) freezes the base model: one teacher-forced
decoder pass produces hidden states, and each head gets a CE loss
against the (k+1)-shifted targets. Decoding exactness never depends on
head quality — verification accepts only tokens that match the target's
own greedy choices (decode/speculative.py) — so badly-trained heads cost
speed, never correctness.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig
from .layers import gelu


def init_medusa_params(
    cfg: WhisperConfig, n_heads: int = 4, seed: int = 0
) -> Dict:
    """K residual heads: h + W2 @ gelu(W1 @ h), tied output embedding."""
    key = jax.random.PRNGKey(seed)
    d = cfg.n_text_state
    heads = []
    for k in range(n_heads):
        key, k1, k2 = jax.random.split(key, 3)
        heads.append(
            {
                "w1": (jax.random.normal(k1, (d, d)) * (d**-0.5)).astype(
                    jnp.float32
                ),
                "b1": jnp.zeros((d,), jnp.float32),
                # zero-init the residual projection: heads start as the
                # identity over h (predicting like the base lm head)
                "w2": jnp.zeros((d, d), jnp.float32),
                "b2": jnp.zeros((d,), jnp.float32),
            }
        )
    return {"heads": heads}


def _head_hidden(h, head, dtype):
    """h: (..., d) -> residual head hidden (..., d)."""
    w1 = head["w1"].astype(dtype)
    w2 = head["w2"].astype(dtype)
    z = gelu(h @ w1 + head["b1"].astype(dtype))
    return h + z @ w2 + head["b2"].astype(dtype)


def medusa_propose(
    medusa_params: Dict,
    params: Dict,
    hidden,  # (B, d) final-LN hidden at each element's frontier
    dtype=jnp.float32,
):
    """Greedy one-shot proposals: (B, K) int32 draft tokens."""
    emb = params["decoder"]["token_embedding"]
    drafts = []
    for head in medusa_params["heads"]:
        hh = _head_hidden(hidden.astype(dtype), head, dtype)
        logits = hh.astype(jnp.float32) @ emb.T.astype(jnp.float32)
        drafts.append(jnp.argmax(logits, axis=-1).astype(jnp.int32))
    return jnp.stack(drafts, axis=1)  # (B, K)


def medusa_propose_topk(
    medusa_params: Dict,
    params: Dict,
    hidden,  # (B, d) final-LN hidden at each element's frontier
    top_c: int,
    dtype=jnp.float32,
):
    """Top-C proposals per head: (B, K, C) int32, candidates sorted by
    head probability. Tree-structured verification draws each node's
    token from here (decode/medusa_tree.py)."""
    import jax

    emb = params["decoder"]["token_embedding"]
    drafts = []
    for head in medusa_params["heads"]:
        hh = _head_hidden(hidden.astype(dtype), head, dtype)
        logits = hh.astype(jnp.float32) @ emb.T.astype(jnp.float32)
        _, tok = jax.lax.top_k(logits, top_c)
        drafts.append(tok.astype(jnp.int32))
    return jnp.stack(drafts, axis=1)  # (B, K, C)


def valid_target_mask(tokens, eot: int):
    """(B, T) bool: positions that are valid training targets.

    Valid = up to and INCLUDING the first EOT — heads must learn to
    predict end-of-sequence, so the first EOT is itself a target; only
    positions strictly past it (EOT padding) are excluded. cumsum -
    is_eot counts the EOTs strictly BEFORE each position.
    """
    is_eot = (tokens == eot).astype(jnp.int32)
    return (jnp.cumsum(is_eot, axis=1) - is_eot) == 0


def medusa_losses(
    medusa_params: Dict,
    params: Dict,
    cfg: WhisperConfig,
    hidden,  # (B, T, d) teacher-forced decoder hidden states
    tokens,  # (B, T) int32 inputs whose hidden states these are
    eot: int,
    dtype=jnp.float32,
) -> jax.Array:
    """Per-head CE: head k at position t predicts tokens[t + k + 1].

    Positions whose target lies past the first EOT (or off the end) are
    masked out. Returns the scalar mean loss over heads.
    """
    emb = params["decoder"]["token_embedding"]
    B, T = tokens.shape
    after_eot = ~valid_target_mask(tokens, eot)
    total = jnp.float32(0.0)
    for k, head in enumerate(medusa_params["heads"]):
        shift = k + 2  # hidden at t predicts token t+1; head k: t+k+2
        if shift >= T:
            continue
        hh = _head_hidden(hidden[:, : T - shift].astype(dtype), head, dtype)
        logits = hh.astype(jnp.float32) @ emb.T.astype(jnp.float32)
        targets = tokens[:, shift:]
        mask = ~after_eot[:, shift:]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[
            ..., 0
        ]
        total = total + jnp.sum(nll * mask) / jnp.maximum(
            jnp.sum(mask), 1
        )
    return total / max(len(medusa_params["heads"]), 1)


def train_medusa_step(
    medusa_params: Dict,
    opt_state,
    tx,
    params: Dict,
    cfg: WhisperConfig,
    hidden,
    tokens,
    eot: int,
) -> Tuple[Dict, object, jax.Array]:
    """One optimizer step on the heads only (base model frozen)."""
    loss, grads = jax.value_and_grad(
        lambda mp: medusa_losses(mp, params, cfg, hidden, tokens, eot)
    )(medusa_params)
    updates, opt_state = tx.update(grads, opt_state, medusa_params)
    import optax

    medusa_params = optax.apply_updates(medusa_params, updates)
    return medusa_params, opt_state, loss


def save_medusa(path: str, medusa_params: Dict) -> None:
    from ..utils.safetensors import save_file

    flat = {}
    for k, head in enumerate(medusa_params["heads"]):
        for name, v in head.items():
            flat[f"heads.{k}.{name}"] = np.ascontiguousarray(
                np.asarray(v, np.float32)
            )
    save_file(flat, path)


def load_medusa(path: str) -> Dict:
    from ..utils.safetensors import load_file

    flat = load_file(path)
    n = 1 + max(int(k.split(".")[1]) for k in flat)
    heads = []
    for i in range(n):
        heads.append(
            {
                name: jnp.asarray(flat[f"heads.{i}.{name}"])
                for name in ("w1", "b1", "w2", "b2")
            }
        )
    return {"heads": heads}

"""Parameter-tree flattening and checkpoint interop (MLX / HF safetensors).

The reference's checkpoint contract (which we preserve bit-for-bit so its
checkpoints load here and vice versa):

  - weights are stored flattened with MLX module names
    (``decoder.blocks.0.attn.query.weight`` ...) in a single
    ``model.safetensors`` (reference scripts/train_whisper_ipa.py:410-443)
  - loading overlays ONLY ``decoder.*`` keys onto a base model — the
    encoder was frozen during training
    (reference scripts/evaluate_model.py:20-79)

Canonical internal layout is (in, out) for linear weights and (W, I, O) for
conv kernels; MLX stores (out, in) and (O, W, I), HF-PyTorch (out, in) and
(O, I, W). Conversion transposes accordingly.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np

from ..env import setting

Params = Dict[str, Any]


# -- canonical flatten/unflatten ------------------------------------------

def flatten_params(tree, prefix: str = "") -> Dict[str, Any]:
    """Flatten the nested dict/list tree into {dot.name: array}."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            flat.update(flatten_params(v, key))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            key = f"{prefix}.{i}" if prefix else str(i)
            flat.update(flatten_params(v, key))
    else:
        if prefix:
            flat[prefix] = tree
    return flat


def unflatten_params(flat: Dict[str, Any]) -> Params:
    """Invert flatten_params; numeric components become list indices."""
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        parts = name.split(".")
        node = tree
        for i, part in enumerate(parts[:-1]):
            nxt = parts[i + 1]
            if part not in node:
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value

    def listify(node):
        if isinstance(node, dict):
            if node and all(re.fullmatch(r"\d+", k) for k in node):
                return [
                    listify(node[str(i)]) for i in range(len(node))
                ]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


# -- MLX name mapping -----------------------------------------------------

_CANON_TO_MLX_LEAF = {"w": "weight", "b": "bias", "g": "weight"}


def _canonical_to_mlx_name(name: str) -> str:
    parts = name.split(".")
    leaf = parts[-1]
    head = parts[:-1]
    if name == "decoder.positional_embedding":
        return name
    if leaf == "token_embedding":
        return name + ".weight"
    return ".".join(head + [_CANON_TO_MLX_LEAF.get(leaf, leaf)])


def to_mlx_flat(params: Params) -> Dict[str, np.ndarray]:
    """Canonical tree -> {mlx_name: array} with MLX tensor layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in flatten_params(params).items():
        arr = np.asarray(arr)
        mlx_name = _canonical_to_mlx_name(name)
        if name.endswith(".w"):
            if arr.ndim == 2:
                arr = arr.T  # (in, out) -> (out, in)
            elif arr.ndim == 3:
                arr = arr.transpose(2, 0, 1)  # (W, I, O) -> (O, W, I)
        if name == "decoder.token_embedding":
            pass  # (n_vocab, d) identical in MLX
        out[mlx_name] = arr
    return out


def _mlx_to_canonical(
    flat: Dict[str, np.ndarray],
) -> Dict[str, np.ndarray]:
    """{mlx_name: array} -> {canonical_name: array} with canonical layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        parts = name.split(".")
        if name == "decoder.positional_embedding":
            out[name] = arr
            continue
        if parts[-2:] == ["token_embedding", "weight"]:
            out[".".join(parts[:-1])] = arr
            continue
        leaf = parts[-1]
        head = parts[:-1]
        is_ln = head and (
            head[-1].endswith("_ln") or head[-1] in ("ln", "ln_post")
        )
        if leaf == "weight":
            if is_ln:
                out[".".join(head + ["g"])] = arr
            elif arr.ndim == 3:
                out[".".join(head + ["w"])] = arr.transpose(1, 2, 0)
            else:
                out[".".join(head + ["w"])] = arr.T
        elif leaf == "bias":
            out[".".join(head + ["b"])] = arr
        else:
            out[name] = arr
    return out


# -- HF name mapping ------------------------------------------------------

_HF_ATTN = {
    "q_proj": "query",
    "k_proj": "key",
    "v_proj": "value",
    "out_proj": "out",
}


def _hf_to_canonical(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """HF transformers Whisper names -> canonical names/layouts."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        n = name
        if n.startswith("model."):
            n = n[len("model."):]
        if n == "proj_out.weight":
            continue  # tied to embed_tokens
        if n == "encoder.embed_positions.weight":
            continue  # fixed sinusoids, recomputed
        n = n.replace("decoder.embed_tokens.weight", "decoder.token_embedding")
        n = n.replace(
            "decoder.embed_positions.weight", "decoder.positional_embedding"
        )
        parts = n.split(".")

        if len(parts) >= 2 and parts[1] == "layers":
            side = parts[0]
            idx = parts[2]
            rest = parts[3:]
            base = [side, "blocks", idx]
            if rest[0] in ("self_attn", "encoder_attn"):
                group = "attn" if rest[0] == "self_attn" else "cross_attn"
                proj = _HF_ATTN[rest[1]]
                leaf = "w" if rest[2] == "weight" else "b"
                arr2 = arr.T if leaf == "w" else arr
                out[".".join(base + [group, proj, leaf])] = arr2
            elif rest[0] in ("self_attn_layer_norm", "encoder_attn_layer_norm"):
                group = (
                    "attn_ln"
                    if rest[0] == "self_attn_layer_norm"
                    else "cross_attn_ln"
                )
                leaf = "g" if rest[1] == "weight" else "b"
                out[".".join(base + [group, leaf])] = arr
            elif rest[0] in ("fc1", "fc2"):
                mlp = "mlp1" if rest[0] == "fc1" else "mlp2"
                leaf = "w" if rest[1] == "weight" else "b"
                arr2 = arr.T if leaf == "w" else arr
                out[".".join(base + [mlp, leaf])] = arr2
            elif rest[0] == "final_layer_norm":
                leaf = "g" if rest[1] == "weight" else "b"
                out[".".join(base + ["mlp_ln", leaf])] = arr
            continue

        if parts[0] in ("encoder", "decoder") and len(parts) >= 2:
            if parts[1] in ("conv1", "conv2"):
                leaf = "w" if parts[2] == "weight" else "b"
                arr2 = arr.transpose(2, 1, 0) if leaf == "w" else arr
                out[".".join([parts[0], parts[1], leaf])] = arr2
                continue
            if parts[1] == "layer_norm":
                tgt = "ln_post" if parts[0] == "encoder" else "ln"
                leaf = "g" if parts[2] == "weight" else "b"
                out[".".join([parts[0], tgt, leaf])] = arr
                continue
        out[n] = arr
    return out


# -- safetensors IO -------------------------------------------------------

def save_safetensors(path: str, params: Params) -> None:
    """Save a canonical tree as MLX-named safetensors (reference format)."""
    from ..utils.safetensors import save_file

    flat = {
        k: np.ascontiguousarray(np.asarray(v))
        for k, v in to_mlx_flat(params).items()
    }
    save_file(flat, path)


def load_safetensors_flat(path: str) -> Dict[str, np.ndarray]:
    from ..utils.safetensors import load_file

    return load_file(path)


def detect_format(flat: Dict[str, np.ndarray]) -> str:
    keys = flat.keys()
    if any(k.startswith("model.") or k.startswith("proj_out") for k in keys):
        return "hf"
    if any(k.startswith(("encoder.layers.", "decoder.layers.")) for k in keys):
        return "hf"
    return "mlx"


def params_from_flat(
    flat: Dict[str, np.ndarray], fmt: str = None
) -> Params:
    """Build a canonical tree from a foreign flat dict (auto-detects)."""
    fmt = fmt or detect_format(flat)
    if fmt == "hf":
        canon = _hf_to_canonical(flat)
    elif fmt == "mlx":
        canon = _mlx_to_canonical(flat)
    else:
        canon = dict(flat)
    return unflatten_params(
        {k: jnp.asarray(v, jnp.float32) for k, v in canon.items()}
    )


def overlay_decoder_weights(
    base_params: Params, checkpoint_flat: Dict[str, np.ndarray]
) -> Tuple[Params, int]:
    """The decoder-overlay load: overwrite decoder.* onto base params.

    Returns (params, number of overlaid tensors). Mirrors reference
    scripts/evaluate_model.py:56-73.
    """
    fmt = detect_format(checkpoint_flat)
    decoder_only = {
        k: v for k, v in checkpoint_flat.items() if "decoder" in k.split(".")[0:2]
    }
    if fmt == "hf":
        canon = _hf_to_canonical(decoder_only)
    else:
        canon = _mlx_to_canonical(decoder_only)
    canon = {k: v for k, v in canon.items() if k.startswith("decoder.")}

    base_flat = flatten_params(base_params)
    n_loaded = 0
    for k, v in canon.items():
        if k in base_flat:
            expected = base_flat[k]
            v = jnp.asarray(v, jnp.float32)
            if v.shape != expected.shape:
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint {v.shape} vs model "
                    f"{expected.shape}"
                )
            base_flat[k] = v
            n_loaded += 1
    return unflatten_params(base_flat), n_loaded


def checkpoint_overlay_mode(checkpoint_path: str):
    """Infer whether a checkpoint needs the FULL overlay (trained
    encoder) from its run's training_config.json.

    ``checkpoint-N`` / ``best-checkpoint`` dirs sit inside the run dir
    that holds ``training_config.json``; a run recorded with
    ``freeze_encoder: false`` trained its encoder, so loading it through
    the decoder-only reference contract (scripts/evaluate_model.py:56-73)
    would silently leave a random encoder under the trained decoder.
    Returns True (full), False (decoder-only), or None (no metadata —
    caller decides; reference-produced checkpoints land here and keep
    the reference behavior).
    """
    import json as _json
    import os

    d = checkpoint_path
    if not os.path.isdir(d):
        d = os.path.dirname(d)
    for cand in (d, os.path.dirname(d)):
        cfg_path = os.path.join(cand, "training_config.json")
        if os.path.isfile(cfg_path):
            try:
                with open(cfg_path) as f:
                    fe = _json.load(f)["training_args"].get("freeze_encoder")
            except Exception:
                return None
            if fe is None:
                return None
            return not fe
    return None


def load_checkpoint_auto(
    checkpoint_path: str, base_params: Params, full=None
) -> Tuple[Params, int]:
    """load_checkpoint_model with overlay-mode auto-detection.

    full=None reads the run's training_config.json via
    checkpoint_overlay_mode: full-fine-tune checkpoints get the full
    overlay automatically, everything else keeps the decoder-only
    reference contract. Explicit True/False overrides (CLI
    --full-checkpoint / --decoder-only).
    """
    if full is None:
        full = checkpoint_overlay_mode(checkpoint_path)
        if full:
            import sys

            # stderr: cli.transcribe keeps stdout '#'-prefixed / JSON
            print(
                "(auto) full overlay: checkpoint run recorded "
                "freeze_encoder=false, so its encoder is trained",
                file=sys.stderr,
            )
        full = bool(full)
    return load_checkpoint_model(checkpoint_path, base_params, full=full)


_vocab_mismatch_warned = False


def _guard_vocab_provenance(checkpoint_dir: str) -> None:
    """Refuse to DECODE a checkpoint through a different vocabulary.

    Every inference path (transcribe/serve/evaluate/bench) loads weights
    through load_checkpoint_model, so this is the chokepoint where a
    byte-fallback-trained checkpoint meeting real tiktoken ranks (or
    vice versa) is caught before it decodes garbage: text-token ids
    differ even though the special-token layout matches
    (docs/PARITY.md deviation 2). Mirrors the training-resume guard
    (train/checkpoints.py check_vocab_provenance — ref contract:
    reference WHISPER_IPA_RESEARCH_STANDALONE.md:316-350 id table).
    Unstamped checkpoints (no training_state.json / pre-stamp runs)
    pass silently. WHISPER_IPA_ALLOW_VOCAB_MISMATCH=1 downgrades
    the error to one loud warning per process.
    """
    import json as _json
    import os

    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    if not os.path.isfile(meta_path):
        return
    try:
        with open(meta_path) as f:
            stamped = _json.load(f).get("vocab_provenance")
    except Exception:
        return
    if stamped is None:
        return
    from ..tokenizer import get_tokenizer

    current = getattr(
        get_tokenizer(multilingual=True), "provenance", None
    )
    if current is None or stamped == current:
        return
    msg = (
        f"checkpoint {checkpoint_dir} was trained with vocabulary "
        f"{stamped!r} but the active tokenizer is {current!r}; text "
        "token ids are incompatible and decoded output would be "
        "garbage. Point WHISPER_IPA_TIKTOKEN at the matching rank "
        "file, or set WHISPER_IPA_ALLOW_VOCAB_MISMATCH=1 to "
        "override."
    )
    if setting("ALLOW_VOCAB_MISMATCH") == "1":
        global _vocab_mismatch_warned
        if not _vocab_mismatch_warned:
            import sys

            print(f"WARNING: {msg}", file=sys.stderr)
            _vocab_mismatch_warned = True
        return
    raise ValueError(msg)


def load_checkpoint_model(
    checkpoint_path: str, base_params: Params, full: bool = False
) -> Tuple[Params, int]:
    """Load ``<dir>/model.safetensors`` and overlay decoder weights.

    full=True overlays EVERY matching tensor (encoder included) — for
    checkpoints from full fine-tunes (train --unfreeze-encoder), where
    the decoder-only reference contract would silently leave a random
    encoder under a trained decoder.
    """
    import os

    weights_path = checkpoint_path
    if os.path.isdir(checkpoint_path):
        weights_path = os.path.join(checkpoint_path, "model.safetensors")
    _guard_vocab_provenance(os.path.dirname(os.path.abspath(weights_path)))
    flat = load_safetensors_flat(weights_path)
    if not full:
        return overlay_decoder_weights(base_params, flat)

    fmt = detect_format(flat)
    canon = (
        _hf_to_canonical(flat) if fmt == "hf" else _mlx_to_canonical(flat)
    )
    base_flat = flatten_params(base_params)
    n_loaded = 0
    for k, v in canon.items():
        if k in base_flat:
            expected = base_flat[k]
            v = jnp.asarray(v, jnp.float32)
            if v.shape != expected.shape:
                raise ValueError(
                    f"shape mismatch for {k}: checkpoint {v.shape} vs "
                    f"model {expected.shape}"
                )
            base_flat[k] = v
            n_loaded += 1
    return unflatten_params(base_flat), n_loaded


def cast_tree_dtype(tree, dtype):
    """Cast every floating leaf of a param subtree (e.g. a frozen encoder
    stored in bfloat16 — halves its HBM residency with no training effect,
    since frozen-encoder activations are computed in the activation dtype
    anyway)."""
    def cast(x):
        arr = jnp.asarray(x)
        if jnp.issubdtype(arr.dtype, jnp.floating):
            return arr.astype(dtype)
        return arr

    import jax as _jax

    return _jax.tree.map(cast, tree)

"""Checkpointing: reference-compatible weights + full train-state resume.

Two layers:

  1. Weights in the reference's exact format — ``checkpoint-{step}/
     model.safetensors`` with MLX-flattened names plus ``training_state.json``
     (reference scripts/train_whisper_ipa.py:410-443) — so reference tooling
     can read our checkpoints and vice versa.
  2. Full train state (optimizer moments + step) in
     ``checkpoint-{step}/opt_state.safetensors`` — fixing the reference's
     gap: its checkpoints never stored optimizer state and training could
     not resume (SURVEY §5 Checkpoint/resume).
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.convert import (
    load_safetensors_flat,
    params_from_flat,
    save_safetensors,
)
from .step import TrainState


def fetch_tree_to_host(tree):
    """Device->host fetch that is safe for multi-host sharded arrays.

    ``np.asarray`` raises on a jax.Array whose shards live on other
    hosts' devices (not fully addressable, not fully replicated) — e.g.
    tensor-parallel parameters on a pod. Such leaves are gathered with
    ``multihost_utils.process_allgather`` (a collective: EVERY process
    must call this function at the same point); everything else is a
    plain local fetch. Returns a pytree of numpy arrays.
    """
    from jax.experimental import multihost_utils

    def fetch(x):
        if (
            isinstance(x, jax.Array)
            and not x.is_fully_addressable
            and not x.is_fully_replicated
        ):
            return np.asarray(process_allgather(x, tiled=True))
        return np.asarray(x)

    process_allgather = multihost_utils.process_allgather
    return jax.tree_util.tree_map(fetch, tree)


def _host_state(state: TrainState, with_opt: bool = True) -> TrainState:
    """Fetch a TrainState to host numpy (collective on multi-host)."""
    return TrainState(
        step=np.asarray(state.step),
        params=fetch_tree_to_host(state.params),
        opt_state=(
            fetch_tree_to_host(state.opt_state)
            if with_opt
            else state.opt_state
        ),
    )


def _flatten_pytree_numpy(tree) -> Dict[str, np.ndarray]:
    """Flatten any pytree to {jax-keypath: ndarray} for safetensors."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        flat[key] = np.asarray(leaf)
    return flat


def _restore_pytree_numpy(tree_like, flat: Dict[str, np.ndarray]):
    """Fill a template pytree's leaves from a flat dict (inverse of above)."""
    paths_and_leaves = jax.tree_util.tree_flatten_with_path(tree_like)
    leaves = []
    for path, leaf in paths_and_leaves[0]:
        key = jax.tree_util.keystr(path)
        if key not in flat:
            raise KeyError(f"missing key in checkpoint: {key}")
        saved = np.asarray(flat[key])
        template = jnp.asarray(leaf)
        # safetensors may round-trip 0-d arrays as 1-d; restore the shape
        host = saved.reshape(template.shape).astype(template.dtype)
        sharding = getattr(template, "sharding", None)
        if sharding is not None and getattr(sharding, "mesh", None) is not None:
            # sharded template (ZeRO-1 moments, TP params): place each
            # shard directly from host — the full replicated array never
            # materializes on any device (it may not fit)
            leaves.append(jax.device_put(host, sharding))
        else:
            leaves.append(jnp.asarray(host))
    return jax.tree_util.tree_unflatten(paths_and_leaves[1], leaves)


def save_checkpoint(
    state: TrainState,
    step: int,
    loss,
    output_dir: str,
    *,
    logger=None,
    start_time: Optional[float] = None,
    learning_rate: Optional[float] = None,
    save_opt_state: bool = True,
    vocab_provenance: Optional[str] = None,
    multihost_fetch: bool = True,
) -> str:
    """Write checkpoint-{step}/ with weights, metadata, and opt state.

    Multi-host safe: when more than one process is running, EVERY
    process must call this (the param/opt-state fetch is a collective
    for cross-host-sharded arrays) but only process 0 touches the
    filesystem — two hosts racing the same checkpoint-{step}/ files was
    the reference-loop gap flagged in round 2. Resume without shared
    storage is handled in train(): the restored step is allgathered and
    process 0's state broadcast when hosts disagree. ``multihost_fetch=False``
    skips the collective (emergency path: peers may not reach this
    call); it then only succeeds for fully-replicated state.
    """
    checkpoint_dir = os.path.join(output_dir, f"checkpoint-{step}")
    if jax.process_count() > 1:
        if multihost_fetch:
            state = _host_state(state, with_opt=save_opt_state)
        if jax.process_index() != 0:
            return checkpoint_dir
    os.makedirs(checkpoint_dir, exist_ok=True)

    save_safetensors(
        os.path.join(checkpoint_dir, "model.safetensors"), state.params
    )

    meta: Dict[str, Any] = {
        "step": step,
        "loss": float(loss) if loss is not None else None,
    }
    if start_time is not None:
        meta["wall_clock_sec"] = time.time() - start_time
    if learning_rate is not None:
        meta["learning_rate"] = learning_rate
    if logger is not None:
        meta["best_pfer"] = (
            logger.best_pfer if logger.best_pfer != float("inf") else None
        )
        meta["best_pfer_step"] = logger.best_pfer_step
        meta["latest_val_per"] = logger.latest_val_per
        meta["latest_val_pfer"] = logger.latest_val_pfer
    if vocab_provenance is not None:
        meta["vocab_provenance"] = vocab_provenance
    meta["timestamp"] = datetime.now().isoformat()
    with open(os.path.join(checkpoint_dir, "training_state.json"), "w") as f:
        json.dump(meta, f, indent=2)

    if save_opt_state:
        from ..utils.safetensors import save_file

        flat = _flatten_pytree_numpy(state.opt_state)
        flat["__step__"] = np.asarray(state.step)
        # contiguous copies (safetensors mis-serializes jax-array views) and
        # drop non-array leaves
        flat = {
            k: np.ascontiguousarray(v)
            for k, v in flat.items()
            if isinstance(v, np.ndarray) and v.size
        }
        if flat:
            save_file(
                flat, os.path.join(checkpoint_dir, "opt_state.safetensors")
            )
    return checkpoint_dir


def save_best_checkpoint(
    state: TrainState,
    step: int,
    pfer: float,
    per: float,
    output_dir: str,
    host_params=None,
) -> str:
    """Overwrite best-checkpoint/ (reference behavior at
    scripts/train_whisper_ipa.py:573-588).

    Multi-host safe like save_checkpoint: call from every process, only
    process 0 writes. Pass ``host_params`` (an already-fetched numpy
    tree, e.g. the one validate() just used) to skip the collective.
    """
    import shutil

    best_dir = os.path.join(output_dir, "best-checkpoint")
    if host_params is not None:
        state = TrainState(
            step=state.step, params=host_params, opt_state=state.opt_state
        )
    elif jax.process_count() > 1:
        state = TrainState(
            step=state.step,
            params=fetch_tree_to_host(state.params),
            opt_state=state.opt_state,
        )
    if jax.process_count() > 1 and jax.process_index() != 0:
        return best_dir
    if os.path.isdir(best_dir):
        shutil.rmtree(best_dir)
    os.makedirs(best_dir, exist_ok=True)
    save_safetensors(os.path.join(best_dir, "model.safetensors"), state.params)
    with open(os.path.join(best_dir, "training_state.json"), "w") as f:
        json.dump(
            {
                "step": step,
                "pfer": pfer,
                "per": per,
                "timestamp": datetime.now().isoformat(),
            },
            f,
            indent=2,
        )
    return best_dir


# -- orbax backend (optional) ---------------------------------------------

def save_checkpoint_orbax(state: TrainState, step: int, output_dir: str) -> str:
    """Full TrainState via orbax (async-capable, multi-host-aware).

    The JAX-ecosystem alternative to the safetensors format: one call per
    train state, sharding-aware across hosts. The safetensors path remains the
    reference-compatible interchange format.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(output_dir, f"orbax-{step}"))
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(path, state)
    checkpointer.wait_until_finished()
    return path


def restore_checkpoint_orbax(path: str, state_template: TrainState) -> TrainState:
    import orbax.checkpoint as ocp

    checkpointer = ocp.StandardCheckpointer()
    return checkpointer.restore(os.path.abspath(path), state_template)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """Find the highest-step checkpoint-N directory."""
    if not os.path.isdir(output_dir):
        return None
    best_step = -1
    best_path = None
    for name in os.listdir(output_dir):
        if name.startswith("checkpoint-"):
            try:
                step = int(name.split("-", 1)[1])
            except ValueError:
                continue
            if step > best_step:
                best_step = step
                best_path = os.path.join(output_dir, name)
    return best_path


def restore_checkpoint(
    checkpoint_dir: str, state_template: TrainState
) -> Tuple[TrainState, Dict[str, Any]]:
    """Resume: rebuild TrainState (params + optimizer moments) and metadata."""
    flat = load_safetensors_flat(
        os.path.join(checkpoint_dir, "model.safetensors")
    )
    params = params_from_flat(flat, fmt="mlx")

    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    meta = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    opt_state = state_template.opt_state
    step = jnp.asarray(meta.get("step", 0), jnp.int32)
    opt_path = os.path.join(checkpoint_dir, "opt_state.safetensors")
    if os.path.isfile(opt_path):
        from ..utils.safetensors import load_file

        flat_opt = load_file(opt_path)
        if "__step__" in flat_opt:
            step = jnp.asarray(
                np.asarray(flat_opt.pop("__step__")).reshape(()), jnp.int32
            )
        try:
            opt_state = _restore_pytree_numpy(
                state_template.opt_state, flat_opt
            )
        except KeyError:
            pass  # optimizer layout changed; keep fresh moments

    return (
        TrainState(step=step, params=params, opt_state=opt_state),
        meta,
    )


def check_vocab_provenance(
    checkpoint_dir: str, tokenizer, strict: bool = True
) -> Optional[str]:
    """Refuse to mix a checkpoint with a different vocabulary.

    Reads ``vocab_provenance`` from the checkpoint's training_state.json and
    compares it to ``tokenizer.provenance``. A checkpoint trained on real
    tiktoken ranks decodes garbage through the byte-fallback vocabulary (and
    vice versa): text-token ids differ even though the special-token layout
    matches. Returns the checkpoint's provenance (None if unstamped — old
    checkpoints predate the stamp and are let through with a warning).
    """
    meta_path = os.path.join(checkpoint_dir, "training_state.json")
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    stamped = meta.get("vocab_provenance")
    if stamped is None:
        return None
    current = getattr(tokenizer, "provenance", None)
    if current is not None and stamped != current:
        msg = (
            f"checkpoint {checkpoint_dir} was trained with vocabulary "
            f"{stamped!r} but the active tokenizer is {current!r}; text "
            "token ids are incompatible. Point WHISPER_IPA_TIKTOKEN at "
            "the matching rank file (or pass strict=False to override)."
        )
        if strict:
            raise ValueError(msg)
        print(f"Warning: {msg}")
    return stamped

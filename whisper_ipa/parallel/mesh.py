"""Device mesh construction and sharding rules (DP + optional TP).

The reference has no distributed layer at all (single Apple-silicon GPU,
"NO distributed training" — SURVEY §2c); this module is the equivalent
it needs: a (data, model) mesh over the devices, batch sharding along
'data', replicated or tensor-sharded parameters, and XLA-inserted
collectives. Gradient all-reduce falls out of GSPMD: the batch is sharded,
parameters are replicated, so XLA emits a psum over 'data' for the grads.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Optional[Mesh]:
    """Build a (data, model) mesh over the available devices.

    data defaults to n_devices // model. Returns None when there is a
    single device and no model parallelism (plain single-chip execution).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if model < 1 or n % model != 0:
        raise ValueError(f"model={model} does not divide {n} devices")
    if data is None:
        data = n // model
    if data * model != n:
        devices = devices[: data * model]
    if data * model == 1:
        return None
    arr = np.array(devices).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) axis over 'data'; replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def shard_batch(mesh: Optional[Mesh], *arrays):
    """Place arrays with the batch axis sharded over 'data'."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(
        jax.device_put(a, batch_sharding(mesh, a.ndim)) for a in arrays
    )
    return out if len(out) > 1 else out[0]


def shard_padded_batch(mesh: Optional[Mesh], x):
    """Zero-pad the batch axis to a multiple of the 'data' axis and shard.

    Returns (sharded_x, n_real) — decode helpers slice results back to
    n_real rows. The evaluation paths (validate, evaluate_model) share
    this so the padding contract lives in one place."""
    import jax.numpy as jnp

    n_real = int(x.shape[0])
    if mesh is None:
        return x, n_real
    n_data = int(mesh.shape.get("data", 1))
    if n_data <= 1:
        return x, n_real
    pad = (-n_real) % n_data
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    return shard_batch(mesh, x), n_real


def shard_chunk(mesh: Optional[Mesh], *arrays):
    """Place (C, B, ...) multi-step chunks with axis 1 (batch) sharded
    over 'data' — the chunk axis C is a time axis (lax.scan steps in
    train_chunk), never sharded."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(
        jax.device_put(
            a, NamedSharding(mesh, P(None, "data", *([None] * (a.ndim - 2))))
        )
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def replicate(mesh: Optional[Mesh], tree):
    """Fully replicate a pytree over the mesh."""
    if mesh is None:
        return tree
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


# -- tensor-parallel sharding rules ---------------------------------------

# param-path regex -> PartitionSpec. Matmul-heavy weights split over the
# 'model' axis: qkv/mlp1 column-sharded, out/mlp2 row-sharded, so each
# block needs one all-reduce per attention/MLP (the Megatron layout).
TP_RULES: Tuple[Tuple[str, P], ...] = (
    (r".*\.attn\.(query|key|value)\.w$", P(None, "model")),
    (r".*\.attn\.(query|value)\.b$", P("model")),
    (r".*\.cross_attn\.(query|key|value)\.w$", P(None, "model")),
    (r".*\.cross_attn\.(query|value)\.b$", P("model")),
    (r".*\.attn\.out\.w$", P("model", None)),
    (r".*\.cross_attn\.out\.w$", P("model", None)),
    (r".*\.mlp1\.w$", P(None, "model")),
    (r".*\.mlp1\.b$", P("model")),
    (r".*\.mlp2\.w$", P("model", None)),
    (r"decoder\.token_embedding$", P(None, None)),
)


def spec_for_param(path: str, rules=TP_RULES) -> P:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return P()


def param_shardings(mesh: Mesh, params, rules=TP_RULES):
    """Pytree of NamedShardings for tensor-parallel parameter placement."""
    from ..models.convert import flatten_params, unflatten_params

    flat = flatten_params(params)
    specs = {k: NamedSharding(mesh, spec_for_param(k, rules)) for k in flat}
    return unflatten_params(specs)


def shard_params(mesh: Optional[Mesh], params, tensor_parallel: bool = False):
    """Place parameters on the mesh (replicated, or TP-sharded)."""
    if mesh is None:
        return params
    if not tensor_parallel or mesh.shape.get("model", 1) == 1:
        return replicate(mesh, params)
    shardings = param_shardings(mesh, params)
    return jax.tree.map(jax.device_put, params, shardings)


# -- FSDP / ZeRO-3 parameter sharding ---------------------------------------


def fsdp_param_shardings(
    mesh: Mesh, params, tensor_parallel: bool = False, rules=TP_RULES
):
    """FSDP (ZeRO-3) parameter placement: shard every parameter over the
    mesh 'data' axis on its largest free divisible axis, on top of its
    Megatron spec when ``tensor_parallel``.

    Each device then holds ~1/dp of the weights; GSPMD all-gathers a
    tensor where the forward/backward uses it and reduce-scatters its
    gradient — the FSDP communication schedule falls out of the
    shardings alone, no wrapper classes (contrast torch FSDP). Combined
    with the mirrored ZeRO-1 moment sharding (opt_state_shardings) this
    is the full ZeRO-3 memory stack: params, grads-in-update, and
    moments all at 1/dp residency — what decides whether a large-v3
    full fine-tune fits a card. Tensors with no divisible free
    axis (small biases, scalars) stay replicated. (The reference trains
    on a single GPU and has no equivalent — SURVEY §2c.)
    """
    from ..models.convert import flatten_params, unflatten_params

    data_size = int(mesh.shape.get("data", 1))
    flat = flatten_params(params)
    specs = {}
    for k, v in flat.items():
        base = spec_for_param(k, rules) if tensor_parallel else P()
        specs[k] = NamedSharding(
            mesh, zero1_spec(tuple(v.shape), data_size, base)
        )
    return unflatten_params(specs)


# -- ZeRO-1 optimizer-state sharding ---------------------------------------
#
# Optimizer moments mirror the parameters, so replicating them across the
# 'data' axis (the plain-DP layout above) wastes (data-1)/data of their HBM:
# AdamW on large-v3 carries ~2x params of fp32 moments, which is the
# difference between fitting and not fitting a large fine-tune. ZeRO-1
# shards every optimizer-state tensor over 'data' on its largest free axis;
# parameters stay replicated (the forward pass is untouched), and GSPMD
# turns the update into reduce-scatter(grad-slice math) + all-gather(update)
# — the classic ZeRO-1 communication schedule — from shardings alone.
# (The reference trains on one GPU and has no equivalent; this is the
# scaling layer SURVEY §2c calls for.)


def zero1_spec(shape, data_size: int, base: P = P()) -> P:
    """Extend ``base`` (the tensor's TP spec, P() when pure-DP) with 'data'
    on the largest axis that is unsharded and divisible by data_size."""
    entries = list(base) + [None] * (len(shape) - len(base))
    best, best_dim = -1, 0
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data_size == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best < 0:
        return base
    entries[best] = "data"
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _trailing_tree_path(path) -> str:
    """The trailing run of dict/sequence keys of a tree_util key path,
    joined flatten_params-style ('decoder.blocks.0.attn.query.w') — the
    param path embedded at the tail of an optimizer-state leaf path
    (…ScaleByAdamState.mu['decoder']['blocks'][0]…)."""
    from jax.tree_util import DictKey, SequenceKey

    parts = []
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            parts.append(str(entry.key))
        elif isinstance(entry, SequenceKey):
            parts.append(str(entry.idx))
        else:
            break
    return ".".join(reversed(parts))


def opt_state_shardings(
    mesh: Mesh,
    tx,
    params,
    tensor_parallel: bool = False,
    zero1: bool = True,
    rules=TP_RULES,
):
    """Shardings pytree matching ``tx.init(params)``.

    Each leaf that mirrors a TP-sharded param (mu/nu/acc_grads subtrees,
    identified by the trailing tree path) gets that param's TP spec; with
    ``zero1`` the spec is additionally extended with 'data' on the largest
    free divisible axis (ZeRO-1). Scalars and unmatched leaves replicate.
    """
    from jax.tree_util import tree_flatten_with_path, tree_unflatten

    from ..models.convert import flatten_params

    data_size = int(mesh.shape.get("data", 1)) if zero1 else 1
    flat_params = flatten_params(params)
    param_shapes = {k: tuple(v.shape) for k, v in flat_params.items()}

    shapes = jax.eval_shape(tx.init, params)
    leaves, treedef = tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            out.append(NamedSharding(mesh, P()))
            continue
        base = P()
        tail = _trailing_tree_path(path)
        if tensor_parallel and tail and param_shapes.get(tail) == shape:
            base = spec_for_param(tail, rules)
        if data_size > 1:
            base = zero1_spec(shape, data_size, base)
        out.append(NamedSharding(mesh, base))
    return tree_unflatten(treedef, out)

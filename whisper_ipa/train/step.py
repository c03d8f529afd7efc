"""TrainState and the jitted training step.

One XLA program per step: encoder forward (stop-gradient), decoder forward +
backward, per-tensor clip, AdamW update — with buffer donation so parameters
and optimizer state update in place on device. Data-parallel execution comes
from sharding the batch over the mesh 'data' axis (see parallel/); XLA
inserts the gradient all-reduce automatically because parameters are
replicated.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import WhisperConfig
from .loss import compute_loss
from .optimizer import make_optimizer


class TrainState(NamedTuple):
    step: jax.Array
    params: Any
    opt_state: Any


def create_train_state(
    params,
    learning_rate: float = 1e-5,
    max_grad_norm: float = 1.0,
    freeze_encoder: bool = True,
    schedule=None,
    accum_steps: int = 1,
    mu_dtype=None,
) -> Tuple[TrainState, optax.GradientTransformation]:
    tx = make_optimizer(
        learning_rate=learning_rate,
        max_grad_norm=max_grad_norm,
        freeze_encoder=freeze_encoder,
        schedule=schedule,
        accum_steps=accum_steps,
        mu_dtype=mu_dtype,
    )
    return (
        TrainState(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
        ),
        tx,
    )


def _apply_update(
    state: TrainState,
    mel,
    tokens,
    cfg: WhisperConfig,
    tx: optax.GradientTransformation,
    eot: int,
    freeze_encoder: bool,
    dtype_name: str,
    remat: bool,
    blockwise: bool,
    inputs_are_features: bool,
    bf16_head: bool,
) -> Tuple[TrainState, jax.Array]:
    """Traced body shared by train_step (one dispatch per step) and
    train_chunk (one dispatch per C steps)."""

    def loss_fn(params):
        return compute_loss(
            params,
            cfg,
            mel if not inputs_are_features else None,
            tokens,
            eot,
            audio_features=mel if inputs_are_features else None,
            freeze_encoder=freeze_encoder,
            dtype=jnp.dtype(dtype_name),
            remat=remat,
            blockwise=blockwise,
            bf16_head=bf16_head,
        )

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    return (
        TrainState(
            step=state.step + 1, params=new_params, opt_state=new_opt_state
        ),
        loss,
    )


def create_train_state_zero1(
    mesh,
    params,
    learning_rate: float = 1e-5,
    max_grad_norm: float = 1.0,
    freeze_encoder: bool = True,
    schedule=None,
    accum_steps: int = 1,
    mu_dtype=None,
    tensor_parallel: bool = False,
) -> Tuple[TrainState, optax.GradientTransformation, Any]:
    """TrainState with ZeRO-1 sharded optimizer state.

    The moments are created ALREADY sharded over the mesh 'data' axis
    (``jit(tx.init, out_shardings=...)``) so they never materialize
    replicated — on a dp=N mesh each device holds 1/N of the AdamW state,
    the memory term that decides whether a large-v3 fine-tune fits a
    16 GB chip. Returns (state, tx, opt_shardings); drive steps with
    make_zero1_step(mesh, tx, opt_shardings, ...).
    """
    from ..parallel.mesh import opt_state_shardings

    tx = make_optimizer(
        learning_rate=learning_rate,
        max_grad_norm=max_grad_norm,
        freeze_encoder=freeze_encoder,
        schedule=schedule,
        accum_steps=accum_steps,
        mu_dtype=mu_dtype,
    )
    opt_shardings = opt_state_shardings(
        mesh, tx, params, tensor_parallel=tensor_parallel, zero1=True
    )
    opt_state = jax.jit(tx.init, out_shardings=opt_shardings)(params)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=opt_state
    )
    return state, tx, opt_shardings


def make_zero1_step(
    mesh,
    cfg: WhisperConfig,
    tx: optax.GradientTransformation,
    eot: int,
    opt_shardings,
    param_shardings=None,
    chunk: bool = False,
    **knobs,
):
    """Jitted train step (or C-step chunk) with ZeRO-1 output shardings.

    Pinning out_shardings (params replicated / TP-sharded, optimizer state
    ZeRO-sharded over 'data') keeps the state's layout FIXED across steps:
    GSPMD computes the AdamW update on each device's 1/N state shard and
    all-gathers only the final param delta, instead of silently
    re-replicating the moments (or re-sharding the params) on some step.
    ``knobs`` are the train_step keyword flags (freeze_encoder, dtype_name,
    remat, blockwise, inputs_are_features, bf16_head).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    replicated = NamedSharding(mesh, P())
    if param_shardings is None:
        # params replicated over the whole mesh (pure DP / DP+ZeRO1)
        make_param_sh = lambda tree: jax.tree.map(lambda _: replicated, tree)
    else:
        make_param_sh = lambda tree: param_shardings

    defaults = dict(
        freeze_encoder=True, dtype_name="float32", remat=False,
        blockwise=False, inputs_are_features=False, bf16_head=False,
    )
    defaults.update(knobs)

    def body(state, mel, tokens):
        return _apply_update(
            state, mel, tokens, cfg, tx, eot, defaults["freeze_encoder"],
            defaults["dtype_name"], defaults["remat"], defaults["blockwise"],
            defaults["inputs_are_features"], defaults["bf16_head"],
        )

    if chunk:
        def fn(state, mels, tokens):
            return jax.lax.scan(
                lambda st, xs: body(st, xs[0], xs[1]), state, (mels, tokens)
            )
    else:
        fn = body

    def out_shardings_for(params):
        state_sh = TrainState(
            step=replicated,
            params=make_param_sh(params),
            opt_state=opt_shardings,
        )
        return (state_sh, replicated)

    compiled = {}

    def stepper(state, mel, tokens):
        key = jax.tree.structure(state.params)
        if key not in compiled:
            compiled[key] = jax.jit(
                fn,
                donate_argnums=(0,),
                out_shardings=out_shardings_for(state.params),
            )
        return compiled[key](state, mel, tokens)

    return stepper


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "tx", "eot", "freeze_encoder", "dtype_name", "remat",
        "blockwise", "inputs_are_features", "bf16_head",
    ),
    donate_argnames=("state",),
)
def train_step(
    state: TrainState,
    mel,
    tokens,
    cfg: WhisperConfig,
    tx: optax.GradientTransformation,
    eot: int,
    freeze_encoder: bool = True,
    dtype_name: str = "float32",
    remat: bool = False,
    blockwise: bool = False,
    inputs_are_features: bool = False,
    bf16_head: bool = False,
) -> Tuple[TrainState, jax.Array]:
    """One optimization step. Returns (new_state, loss).

    dtype_name: activation compute dtype — "float32" for the reference's
    numerical regime, "bfloat16" for the tensor cores' bf16 rate (params, optimizer
    state, and the loss/logit head stay float32 either way;
    bf16_head=True opts the logits GEMM's multiplicands into bfloat16
    with float32 accumulation — see models.whisper.decoder_logits).

    inputs_are_features: ``mel`` already holds precomputed encoder outputs
    (B, n_audio_ctx, d) — the frozen encoder's activations are constant per
    sample, so caching them removes ~2/3 of the step's FLOPs (the encoder
    forward). See train(cache_encoder=True).
    """
    return _apply_update(
        state, mel, tokens, cfg, tx, eot, freeze_encoder, dtype_name,
        remat, blockwise, inputs_are_features, bf16_head,
    )


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "tx", "eot", "freeze_encoder", "dtype_name", "remat",
        "blockwise", "inputs_are_features", "bf16_head",
    ),
    donate_argnames=("state",),
)
def train_chunk(
    state: TrainState,
    mels,
    tokens,
    cfg: WhisperConfig,
    tx: optax.GradientTransformation,
    eot: int,
    freeze_encoder: bool = True,
    dtype_name: str = "float32",
    remat: bool = False,
    blockwise: bool = False,
    inputs_are_features: bool = False,
    bf16_head: bool = False,
) -> Tuple[TrainState, jax.Array]:
    """C optimization steps in ONE dispatch. Returns (new_state, losses).

    mels: (C, B, 3000, n_mels) — or (C, B, n_audio_ctx, d) features;
    tokens: (C, B, S). lax.scan over the leading axis runs the exact
    train_step body C times, so the result is numerically identical to C
    sequential train_step calls (tests/test_train.py asserts bitwise
    equality) — but the host pays ONE transfer + ONE dispatch instead of
    C, which amortizes dispatch and upload. Trailing-EOT token padding
    is loss-exact (eot_loss_mask keeps only the first EOT; pad positions
    are causal-masked), so batches of different bucketed widths stack
    into one chunk by padding to the chunk max.
    """

    def body(st, xs):
        mel_i, tok_i = xs
        return _apply_update(
            st, mel_i, tok_i, cfg, tx, eot, freeze_encoder, dtype_name,
            remat, blockwise, inputs_are_features, bf16_head,
        )

    return jax.lax.scan(body, state, (mels, tokens))

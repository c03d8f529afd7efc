"""The training loop: decoder-only Whisper IPA fine-tuning.

Orchestration mirrors the reference train() (scripts/train_whisper_ipa.py:
446-645): random-batch sampling, periodic validation with decode + PER/PFER,
best-checkpoint tracking, the same console/CSV/JSON artifacts — redesigned
around a jitted train step, an async host input pipeline, device-mesh data
parallelism, and a real resume path.
"""

from __future__ import annotations

import glob
import os
import time
import warnings
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import WhisperConfig, get_config
from ..data.dataset import IPADataset, PrefetchLoader, create_data_loader
from ..decode import DecodingOptions, decode
from ..env import setting
from ..metrics import evaluate_batch
from ..models import init_params, load_safetensors_flat, params_from_flat
from ..models.whisper import count_parameters
from ..parallel.mesh import make_mesh, shard_batch, shard_chunk
from .checkpoints import (
    check_vocab_provenance,
    latest_checkpoint,
    restore_checkpoint,
    save_best_checkpoint,
    save_checkpoint,
)
from .logger import (
    TrainingLogger,
    console_step_line,
    get_hardware_info,
    save_training_config,
)
from .step import create_train_state, train_chunk, train_step


def validate(
    params,
    cfg: WhisperConfig,
    dataset: IPADataset,
    tokenizer,
    num_samples: int = 100,
    val_batch_size: int = 8,
    mesh=None,
) -> Dict:
    """Decode a test subset and score PER/PFER (reference validate()).

    mesh: shard each decode batch over the mesh 'data' axis — evaluation
    throughput scales with the data-parallel degree (params replicated or
    TP-sharded; token-identical to the single-device decode, see
    tests/test_parallel.py). Tail batches zero-pad to a multiple of the
    data axis and the pad rows are dropped.
    """
    print(f"\nValidating on {num_samples} samples...")
    num_samples = min(num_samples, len(dataset))
    references = []
    hypotheses = []
    options = DecodingOptions(
        language=None,
        without_timestamps=True,
        length_penalty=1.0,
    )
    from ..parallel.mesh import shard_padded_batch

    for start in range(0, num_samples, val_batch_size):
        indices = list(range(start, min(start + val_batch_size, num_samples)))
        batch = dataset.get_batch(indices)
        try:
            mel, n_real = shard_padded_batch(
                mesh, jnp.asarray(batch["mel_features"])
            )
            results = decode(
                params,
                cfg,
                mel,
                options,
                tokenizer=tokenizer,
            )[:n_real]
            hypotheses.extend(r.text.strip() for r in results)
            references.extend(t.strip() for t in batch["ipa_texts"])
            if start == 0:
                print("\nSample Predictions:")
                for k in range(min(3, len(results))):
                    print(f"  Ref:  [{references[k]}]")
                    print(f"  Pred: [{hypotheses[k]}]")
                    print("-" * 30)
        except Exception as e:  # mirror reference: skip failed batches
            print(f"Error during validation decoding: {e}")

    metrics = evaluate_batch(references, hypotheses)
    print("Validation Results:")
    print(f"  PER:  {metrics['per']:.2f}%")
    print(f"  PFER: {metrics['pfer']:.2f}%")
    return metrics


def load_or_init_params(model_name: str, cfg: WhisperConfig, weights: Optional[str]):
    """Load pretrained weights from a safetensors path, else random init."""
    if weights and os.path.isfile(weights):
        print(f"Loading weights from {weights}")
        return params_from_flat(load_safetensors_flat(weights))
    cache = os.path.expanduser("~/.cache/whisper_ipa")
    candidates = [setting("WEIGHTS_DIR", ""), cache]
    for root in candidates:
        path = os.path.join(root, f"{cfg.name}.safetensors")
        if root and os.path.isfile(path):
            print(f"Loading weights from {path}")
            return params_from_flat(load_safetensors_flat(path))
    # the cache directory's name before the package took its present name
    for path in sorted(glob.glob(f"{cache}_*/{cfg.name}.safetensors")):
        warnings.warn(f"loading weights from a former cache directory, "
                      f"{path}; move them to {cache}", FutureWarning)
        return params_from_flat(load_safetensors_flat(path))
    print(
        f"No pretrained weights found for {model_name!r}; "
        "initializing randomly (set --weights or WHISPER_IPA_WEIGHTS_DIR)"
    )
    return init_params(cfg, seed=0)


def train(
    model_name: str,
    train_data_path: str,
    test_data_path: str,
    output_dir: str,
    num_steps: int = 1000,
    batch_size: int = 4,
    learning_rate: float = 1e-5,
    validate_every: int = 100,
    save_every: int = 500,
    test_run: bool = False,
    weights: Optional[str] = None,
    resume: bool = False,
    mel_cache_dir: Optional[str] = None,
    data_parallel: bool = True,
    seed: int = 0,
    final_validate: bool = True,
    final_validate_samples: int = 500,
    profile_dir: Optional[str] = None,
    compute_dtype: str = "float32",
    remat: bool = False,
    warmup_steps: int = 0,
    lr_decay: str = "constant",
    accum_steps: int = 1,
    blockwise_loss: bool = False,
    mu_dtype: Optional[str] = None,
    encoder_bf16: bool = False,
    cache_encoder: bool = False,
    freeze_encoder: bool = True,
    bf16_head: bool = False,
    steps_per_call: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
    tensor_parallel: int = 1,
    fixed_token_len: Optional[int] = None,
) -> Dict:
    """Main training entry point (reference-compatible surface + resume).

    Multi-host: every process runs this same function (SPMD). File
    artifacts (config/CSV/checkpoints/summary) are written by process 0
    only; validation decodes on process 0 from a host-fetched copy of
    the parameters and the metrics are broadcast so the best-checkpoint
    decision is consistent everywhere; checkpoint saves are collective
    calls gated inside train/checkpoints.py.
    """
    is_main = jax.process_index() == 0
    n_proc = jax.process_count()
    multi = n_proc > 1
    os.makedirs(output_dir, exist_ok=True)

    args_dict = {
        "model_name": model_name,
        "train_data_path": train_data_path,
        "test_data_path": test_data_path,
        "num_steps": num_steps,
        "batch_size": batch_size,
        "learning_rate": learning_rate,
        "validate_every": validate_every,
        "save_every": save_every,
        "test_run": test_run,
        "resume": resume,
        # load-time contract: freeze_encoder=False checkpoints carry a
        # TRAINED encoder, so CLIs must overlay the full tensor set (the
        # decoder-only reference overlay would leave a random encoder) —
        # models.convert.checkpoint_overlay_mode reads this back
        "freeze_encoder": freeze_encoder,
    }
    if is_main:
        save_training_config(output_dir, args_dict, get_hardware_info())
    logger = TrainingLogger(output_dir, write_files=is_main)

    print("=" * 70)
    print("Fine-tuning Whisper for IPA Transcription")
    print("=" * 70)

    cfg = get_config(model_name)
    n_mels = cfg.n_mels
    print(f"\nModel: {model_name} (n_mels={n_mels})")

    params = load_or_init_params(model_name, cfg, weights)
    if encoder_bf16 and not freeze_encoder:
        raise ValueError(
            "encoder_bf16 requires freeze_encoder: casting a TRAINED "
            "encoder to bfloat16 would make the optimizer update bf16 "
            "master weights (silent quality loss). Use --bf16 for "
            "bf16 activations with f32 master weights instead."
        )
    if encoder_bf16:
        from ..models.convert import cast_tree_dtype

        params["encoder"] = cast_tree_dtype(params["encoder"], jnp.bfloat16)
        print("Frozen encoder stored in bfloat16 (halved HBM residency)")

    if cache_encoder and not freeze_encoder:
        raise ValueError(
            "cache_encoder requires a frozen encoder (cached features "
            "would go stale as the encoder trains)"
        )
    n_dec = count_parameters(params["decoder"])
    n_total = count_parameters(params)
    if freeze_encoder:
        print(
            f"Trainable parameters: {n_dec:,} / {n_total:,} "
            f"({100 * n_dec / n_total:.1f}%) [encoder frozen]"
        )
    else:
        print(
            f"Trainable parameters: {n_total:,} (full fine-tune, "
            "encoder unfrozen)"
        )

    from .optimizer import make_schedule

    schedule = make_schedule(
        learning_rate,
        warmup_steps=warmup_steps,
        decay=lr_decay,
        total_steps=num_steps,
    )
    use_schedule = bool(warmup_steps) or lr_decay != "constant"

    # mesh + parameter placement come BEFORE optimizer-state creation:
    # ZeRO-1 must init its moments ALREADY sharded (jit out_shardings) —
    # materializing the replicated fp32 AdamW state first would defeat
    # the memory purpose on exactly the fine-tunes that need it
    if tensor_parallel > 1 and multi:
        raise ValueError(
            "tensor_parallel > 1 in the training loop is single-host for "
            "now: the multi-host global-batch assembly assumes a pure-DP "
            "device order"
        )
    mesh = (
        make_mesh(
            # --no-data-parallel with TP: a pure-model mesh (data=1),
            # not an implicit data axis over the remaining devices
            data=(1 if (not data_parallel and tensor_parallel > 1) else None),
            model=tensor_parallel,
        )
        if (data_parallel or multi or tensor_parallel > 1)
        else None
    )
    if mesh is not None:
        n_dev = mesh.devices.size
        n_data = int(mesh.shape.get("data", 1))
        if tensor_parallel > 1:
            print(
                f"Mesh over {n_dev} device(s): data={n_data} x "
                f"model={tensor_parallel} (Megatron TP"
                + (" + DP" if n_data > 1 else "") + ")"
            )
        else:
            print(f"Data-parallel over {n_dev} device(s): {mesh}")
        # the batch shards over 'data' only — round to the data axis
        if batch_size % n_data != 0:
            batch_size = max(n_data, (batch_size // n_data) * n_data)
            print(f"  (batch size rounded to {batch_size} for even sharding)")
    use_tp = tensor_parallel > 1 and mesh is not None
    use_fsdp = (
        fsdp and mesh is not None and int(mesh.shape.get("data", 1)) > 1
    )
    if fsdp and not use_fsdp:
        print("FSDP requested but no data-parallel mesh axis; ignoring")
    use_zero1 = (
        (zero1 or use_fsdp)
        and mesh is not None
        and int(mesh.shape.get("data", 1)) > 1
    )
    if zero1 and not use_zero1:
        print("ZeRO-1 requested but no data-parallel mesh axis; ignoring")
    fsdp_sh = None
    if use_fsdp:
        # FSDP / ZeRO-3: parameters sharded over 'data' (largest free
        # divisible axis, composed with the Megatron spec under TP).
        # The moments mirror the params (opt_state_shardings applies the
        # same zero1_spec extension), so the whole AdamW state sits at
        # 1/dp residency per device.
        from ..parallel.mesh import fsdp_param_shardings

        fsdp_sh = fsdp_param_shardings(mesh, params, tensor_parallel=use_tp)
        params = jax.tree.map(jax.device_put, params, fsdp_sh)
    elif use_tp:
        from ..parallel.mesh import shard_params as _shard_params

        params = _shard_params(mesh, params, tensor_parallel=True)
    elif use_zero1:
        # params must be explicitly mesh-replicated: donated buffers are
        # paired with outputs by global shape, and an uncommitted
        # single-device param next to a sharded same-shape moment makes
        # XLA alias mismatched local buffers
        from ..parallel.mesh import replicate as _replicate_params

        params = _replicate_params(mesh, params)

    opt_sh = None
    if use_zero1:
        from .step import create_train_state_zero1

        state, tx, opt_sh = create_train_state_zero1(
            mesh,
            params,
            learning_rate=learning_rate,
            freeze_encoder=freeze_encoder,
            schedule=schedule if use_schedule else None,
            accum_steps=accum_steps,
            mu_dtype=mu_dtype,
            tensor_parallel=use_tp,
        )
    else:
        state, tx = create_train_state(
            params,
            learning_rate=learning_rate,
            freeze_encoder=freeze_encoder,
            schedule=schedule if use_schedule else None,
            accum_steps=accum_steps,
            mu_dtype=mu_dtype,
        )
        if use_tp:
            # tx.init's zeros_like already follows the params' TP specs;
            # opt_sh pins the step's output shardings to match
            from ..parallel.mesh import opt_state_shardings

            opt_sh = opt_state_shardings(
                mesh, tx, params, tensor_parallel=True, zero1=False
            )

    def lr_at(s: int) -> float:
        """The lr actually applied at step s (schedule-aware logging)."""
        return float(schedule(s)) if use_schedule else learning_rate

    resumed_ckpt = None
    if resume:
        ckpt = latest_checkpoint(output_dir)
        if ckpt:
            state, meta = restore_checkpoint(ckpt, state)
            resumed_ckpt = ckpt
            print(f"Resumed from {ckpt} at step {int(state.step)}")
    if multi and resume:
        # checkpoints are written by process 0 only; without shared
        # storage the other hosts find nothing and would start at step 0
        # with fresh params while process 0 resumes — a silent desync.
        # Process 0 is authoritative: broadcast its state when the
        # resumed steps disagree across hosts.
        from jax.experimental import multihost_utils

        steps = multihost_utils.process_allgather(
            jnp.asarray(int(state.step), jnp.int32)
        )
        if int(steps.min()) != int(steps.max()):
            print(
                "Resume steps disagree across hosts "
                f"({sorted(int(s) for s in steps)}); broadcasting "
                "process 0's restored state (no shared filesystem?)"
            )
            b_step, b_params, b_opt = multihost_utils.broadcast_one_to_all(
                (state.step, state.params, state.opt_state)
            )
            state = type(state)(
                step=b_step, params=b_params, opt_state=b_opt
            )

    if multi:
        # the global train state must live on the global mesh: host-local
        # (uncommitted) arrays cannot enter a multi-host jit. Parameters
        # are replicated; optimizer moments replicate too unless ZeRO-1
        # shards them; GSPMD derives the grad all-reduce from the
        # 'data'-sharded batch.
        from ..parallel.mesh import replicate

        state = type(state)(
            step=replicate(mesh, state.step),
            params=(
                jax.tree.map(jax.device_put, state.params, fsdp_sh)
                if use_fsdp
                else replicate(mesh, state.params)
            ),
            opt_state=(
                jax.tree.map(jax.device_put, state.opt_state, opt_sh)
                if use_zero1
                else replicate(mesh, state.opt_state)
            ),
        )

    # datasets
    print(f"\nLoading training data: {train_data_path}")
    train_dataset = create_data_loader(
        train_data_path, n_mels=n_mels, mel_cache_dir=mel_cache_dir
    )
    print(f"Loading test data: {test_data_path}")
    test_dataset = create_data_loader(
        test_data_path, n_mels=n_mels, mel_cache_dir=mel_cache_dir
    )
    tokenizer = train_dataset.tokenizer
    if resumed_ckpt:
        # refuse to continue a run whose checkpoints used a different vocab
        check_vocab_provenance(resumed_ckpt, tokenizer, strict=True)

    if test_run:
        print("\nTEST RUN MODE: Using only 100 training samples")
        train_dataset.data = train_dataset.data[:100]
        num_steps = min(num_steps, 100)

    if cache_encoder:
        # the encoder is frozen: precompute its outputs once and train on
        # cached features — removes ~2/3 of each step's FLOPs (the
        # reference recomputes the encoder every step)
        print("\nPrecomputing frozen-encoder features...")
        n_new = train_dataset.precompute_features(
            params, cfg, os.path.join(output_dir, "encoder_cache"),
            dtype_name=compute_dtype if compute_dtype != "float32"
            else "float32",
        )
        print(f"Encoder cache ready ({n_new} newly encoded)")

    # multi-host: each process keeps only its shard of the training data
    # (host-local IO; the global batch assembles over the mesh)
    if jax.process_count() > 1:
        from ..parallel.distributed import local_shard_indices

        shard = local_shard_indices(len(train_dataset))
        train_dataset.data = [train_dataset.data[i] for i in shard]
        print(
            f"Host {jax.process_index()}/{jax.process_count()}: "
            f"{len(train_dataset.data)} local training samples"
        )

    print("\n" + "=" * 70)
    print(f"Starting training for {num_steps} steps")
    print("=" * 70)

    start_time = time.time()
    start_step = int(state.step)
    latest_loss = None
    eot = tokenizer.eot

    # Sharded-state regimes: tensor parallelism (Megatron param sharding
    # over 'model') and/or ZeRO-1 (optimizer state sharded over 'data' —
    # each device holds 1/dp of the AdamW moments, the memory term that
    # decides whether a large-v3 fine-tune fits a 16 GB chip). State was
    # CREATED sharded above; here we re-place what resume restored and
    # pin the step's output shardings so the layout is fixed across
    # steps; GSPMD derives the collective schedule (grad all-reduce,
    # ZeRO reduce-scatter/all-gather, TP block all-reduces) from the
    # shardings alone.
    step_impl, chunk_impl = train_step, train_chunk
    if use_tp or use_zero1:
        from ..parallel.mesh import (
            param_shardings as tp_param_shardings,
            replicate as _replicate,
        )
        from .step import make_zero1_step

        param_sh = (
            fsdp_sh
            if use_fsdp
            else tp_param_shardings(mesh, state.params) if use_tp else None
        )
        if resumed_ckpt:
            # restore produced fresh host-loaded arrays: re-place them
            # (params per FSDP/TP spec or replicated, moments per opt_sh)
            placed_params = (
                jax.tree.map(jax.device_put, state.params, param_sh)
                if param_sh is not None
                else _replicate(mesh, state.params)
            )
            state = state._replace(
                step=_replicate(mesh, state.step),
                params=placed_params,
                opt_state=jax.tree.map(
                    jax.device_put, state.opt_state, opt_sh
                ),
            )
        sharded_knobs = dict(
            freeze_encoder=freeze_encoder,
            dtype_name=compute_dtype,
            remat=remat,
            blockwise=blockwise_loss,
            inputs_are_features=cache_encoder,
            bf16_head=bf16_head,
        )
        _z_step = make_zero1_step(
            mesh, cfg, tx, eot, opt_sh, param_shardings=param_sh,
            **sharded_knobs,
        )
        _z_chunk = make_zero1_step(
            mesh, cfg, tx, eot, opt_sh, param_shardings=param_sh,
            chunk=True, **sharded_knobs,
        )

        def step_impl(st, mel_a, tok_a, *a, **k):
            return _z_step(st, mel_a, tok_a)

        def chunk_impl(st, mels_a, toks_a, *a, **k):
            return _z_chunk(st, mels_a, toks_a)

        if use_fsdp:
            print(
                f"FSDP (ZeRO-3): parameters AND optimizer state sharded "
                f"over data={int(mesh.shape['data'])} (~1/"
                f"{int(mesh.shape['data'])} of weights + moments per "
                "device; XLA all-gathers weights at use, reduce-scatters "
                "grads)"
            )
        elif use_zero1:
            print(
                f"ZeRO-1: optimizer state sharded over "
                f"data={int(mesh.shape['data'])} (~1/"
                f"{int(mesh.shape['data'])} of the AdamW moments "
                "per device)"
            )
        if use_tp:
            print(
                f"Tensor parallel: Megatron param sharding over "
                f"model={tensor_parallel}"
            )

    def run_validation(cur_state, num_samples):
        """Validate; multi-host: p0 decodes from a host-fetched copy of
        the params and broadcasts the metrics, so every process makes
        the same best-checkpoint decision. Returns (metrics,
        host_params) — host_params is reused by save_best_checkpoint to
        avoid a second collective fetch."""
        if not multi:
            return (
                validate(
                    cur_state.params, cfg, test_dataset, tokenizer,
                    num_samples=num_samples, mesh=mesh,
                ),
                None,
            )
        from jax.experimental import multihost_utils

        from .checkpoints import fetch_tree_to_host

        host_params = fetch_tree_to_host(cur_state.params)  # collective
        import numpy as np

        if is_main:
            m = validate(
                host_params, cfg, test_dataset, tokenizer,
                num_samples=num_samples,
            )
            vec = np.asarray(
                [
                    m["per"], m["pfer"],
                    m.get("per_std", 0.0), m.get("pfer_std", 0.0),
                    float(m.get("num_samples", 0)),
                ],
                np.float32,
            )
        else:
            vec = np.zeros(5, np.float32)
        out = multihost_utils.broadcast_one_to_all(vec)  # collective
        metrics = {
            "per": float(out[0]),
            "pfer": float(out[1]),
            "per_std": float(out[2]),
            "pfer_std": float(out[3]),
            "num_samples": int(out[4]),
        }
        return metrics, host_params

    if steps_per_call > 1 and multi:
        # chunking stacks LOCAL batches; the global-batch assembly is
        # per-call host work and has not been chunk-adapted — fall back
        print("steps_per_call > 1 is single-host only; using 1")
        steps_per_call = 1

    # each host feeds its local slice of the global batch (global rows =
    # local rows x process_count; the global array assembles on the mesh
    # without any cross-host input copy)
    local_batch = batch_size // n_proc if multi else batch_size
    loader = PrefetchLoader(
        train_dataset,
        local_batch,
        num_steps - start_step,
        seed=seed + start_step,
        # hosts pad independently: the global assembly needs one shape.
        # Single-host callers can pin a width too: every distinct chunk
        # width is its own XLA program, each a compile of its own
        fixed_token_len=(
            min(448, cfg.n_text_ctx) if multi else fixed_token_len
        ),
        # chunked dispatch drains steps_per_call batches at once: the
        # worker must be able to buffer a full chunk ahead or the chunk
        # assembly serializes on per-batch mel loads
        depth=max(2, 2 * steps_per_call),
    )
    if multi:
        from ..parallel.distributed import global_batch_from_local

    from .chunking import pow2_floor

    def _chunk_len(step: int) -> int:
        """Steps to run in the next dispatch: never crosses a host-work
        boundary (validation, checkpoint, profiler window, end of run)
        and is a power of two so jit compiles O(log C) programs, not one
        per residue."""
        dist = num_steps - step
        for period in (validate_every, save_every):
            if period:
                dist = min(dist, period - step % period)
        if profile_dir:
            # the profiler traces steps start+10..start+15: one chunk
            # must START at exactly start+10 (start_trace fires before
            # its dispatch) and one must END at start+15 (stop_trace
            # fires after), so force boundaries at start+9 and start+15
            for trig in (start_step + 9, start_step + 15):
                if step < trig:
                    dist = min(dist, trig - step)
        return pow2_floor(min(steps_per_call, dist))

    def _cast_upload(mel_np):
        """bfloat16 training: cast mels/features to bf16 ON HOST before
        the upload. Both consumers cast at entry anyway (encode:
        mel.astype(dtype); decoder_hidden: audio_features.astype(dtype)),
        so this is numerically identical — it just halves the upload
        bytes."""
        if compute_dtype != "bfloat16":
            return mel_np
        import ml_dtypes
        import numpy as _np

        return _np.asarray(mel_np).astype(ml_dtypes.bfloat16)

    def _stack_batches(batches):
        from .chunking import stack_pad_batches

        return stack_pad_batches(
            batches, eot, bf16_mels=compute_dtype == "bfloat16"
        )

    try:
        step = start_step
        batch_iter = iter(loader)
        while step < num_steps:
            n = _chunk_len(step)
            batches = []
            for _ in range(n):
                nxt = next(batch_iter, None)
                if nxt is None:
                    break
                batches.append(nxt)
            if not batches:
                break
            n = len(batches)
            try:
                step_start = time.time()
                if multi:
                    import numpy as _np

                    batch = batches[0]
                    mel = global_batch_from_local(
                        mesh, _np.asarray(batch["mel_features"])
                    )
                    tokens = global_batch_from_local(
                        mesh, _np.asarray(batch["tokens"])
                    )
                elif n == 1:
                    batch = batches[0]
                    mel = jnp.asarray(_cast_upload(batch["mel_features"]))
                    tokens = jnp.asarray(batch["tokens"])
                    if mesh is not None:
                        mel, tokens = shard_batch(mesh, mel, tokens)
                else:
                    mels_np, toks_np = _stack_batches(batches)
                    if mesh is not None:
                        mel, tokens = shard_chunk(mesh, mels_np, toks_np)
                    else:
                        mel = jnp.asarray(mels_np)
                        tokens = jnp.asarray(toks_np)
                if profile_dir and step + 1 == start_step + 10:
                    jax.profiler.start_trace(profile_dir)
                if n == 1:
                    state, loss = step_impl(
                        state,
                        mel,
                        tokens,
                        cfg,
                        tx,
                        eot,
                        freeze_encoder=freeze_encoder,
                        dtype_name=compute_dtype,
                        remat=remat,
                        blockwise=blockwise_loss,
                        inputs_are_features=cache_encoder,
                        bf16_head=bf16_head,
                    )
                    losses = None
                else:
                    state, losses = chunk_impl(
                        state,
                        mel,
                        tokens,
                        cfg,
                        tx,
                        eot,
                        freeze_encoder=freeze_encoder,
                        dtype_name=compute_dtype,
                        remat=remat,
                        blockwise=blockwise_loss,
                        inputs_are_features=cache_encoder,
                        bf16_head=bf16_head,
                    )
                    loss = losses[-1]
                prev_step, step = step, step + n
                if profile_dir and prev_step < start_step + 15 <= step:
                    jax.profiler.stop_trace()
                # fetch the loss to host only when logging: a per-step
                # device->host sync serializes the pipeline
                latest_loss = loss
                step_time = (time.time() - step_start) / n

                log_steps = [
                    s
                    for s in range(prev_step + 1, step + 1)
                    if s % 10 == 0 or s <= 5
                ]
                if log_steps:
                    # ONE bulk device->host transfer for the whole chunk
                    # (per-scalar float() fetches would re-introduce the
                    # per-step sync chunking exists to remove)
                    losses_host = (
                        [float(loss)]
                        if losses is None
                        else np.asarray(losses).astype(float).tolist()
                    )
                    latest_loss = losses_host[-1]
                    for s in log_steps:
                        loss_val = losses_host[s - prev_step - 1]
                        print(
                            console_step_line(
                                s, num_steps, loss_val, step_time, batch_size
                            )
                        )
                        logger.log_train_step(
                            s,
                            loss_val,
                            lr_at(s),
                            step_time,
                            batch_size,
                            time.time() - start_time,
                        )

                if step % 200 < n:
                    # long runs showed host RSS growing ~one mel batch per
                    # step and step dispatch slowing in lockstep, both
                    # reset by validation's allocation burst. Dead
                    # per-step buffers sit in
                    # reference cycles until a gen-2 GC; collect
                    # explicitly so memory stays flat without relying on
                    # validation cadence. ~10-30 ms every 200 steps.
                    import gc

                    gc.collect()

                if validate_every and step % validate_every == 0:
                    metrics, host_params = run_validation(state, 100)
                    is_best = logger.log_validation(
                        step, metrics, time.time() - start_time
                    )
                    if is_best:
                        save_best_checkpoint(
                            state, step, metrics["pfer"], metrics["per"],
                            output_dir, host_params=host_params,
                        )
                        if is_main:
                            print(
                                f"  New best PFER {metrics['pfer']:.2f}% "
                                f"at step {step}"
                            )

                if save_every and step % save_every == 0:
                    save_checkpoint(
                        state,
                        step,
                        latest_loss,
                        output_dir,
                        logger=logger,
                        start_time=start_time,
                        learning_rate=learning_rate,
                        vocab_provenance=tokenizer.provenance,
                    )
            except Exception as e:
                # reference behavior: report and stop the loop, but also
                # leave a usable emergency checkpoint (the reference's
                # bare break loses all progress since the last save)
                import traceback

                print(f"\nError at step {step}: {e}")
                traceback.print_exc()
                try:
                    # multihost_fetch=False: peers may not be in this
                    # handler, so no collectives — works for replicated
                    # (DP) state, skipped for cross-host-sharded state
                    save_checkpoint(
                        state,
                        step,
                        float(latest_loss)
                        if latest_loss is not None
                        else None,
                        output_dir,
                        logger=logger,
                        start_time=start_time,
                        learning_rate=learning_rate,
                        vocab_provenance=tokenizer.provenance,
                        multihost_fetch=False,
                    )
                except Exception as save_err:
                    # train_step donates its input TrainState: if the step
                    # itself failed after dispatch, those buffers no longer
                    # exist on device and cannot be saved — fall back to the
                    # last periodic checkpoint instead of raising a second
                    # exception out of the handler
                    print(
                        f"Emergency checkpoint failed ({save_err}); the "
                        "failed step's input buffers were donated. Resume "
                        f"from the latest periodic checkpoint in {output_dir}"
                    )
                break
    finally:
        loader.close()

    # final validation + summary
    print("\n" + "=" * 70)
    print("Training complete!")
    print("=" * 70)
    if final_validate:
        metrics, _ = run_validation(
            state, min(final_validate_samples, len(test_dataset))
        )
        logger.log_validation(num_steps, metrics, time.time() - start_time)
    else:
        metrics = {"per": float("nan"), "pfer": float("nan")}

    if latest_loss is not None:
        latest_loss = float(latest_loss)
    summary = {}
    if latest_loss is not None:
        print("\nSaving final model...")
        save_checkpoint(
            state,
            num_steps,
            latest_loss,
            output_dir,
            logger=logger,
            start_time=start_time,
            learning_rate=learning_rate,
            vocab_provenance=tokenizer.provenance,
        )
        total_time = time.time() - start_time
        import json
        from datetime import datetime

        summary = {
            "total_wall_clock_sec": total_time,
            "total_wall_clock_min": total_time / 60,
            "final_loss": latest_loss,
            "final_per": metrics["per"],
            "final_pfer": metrics["pfer"],
            "best_pfer": (
                logger.best_pfer if logger.best_pfer != float("inf") else None
            ),
            "best_pfer_step": logger.best_pfer_step,
            "end_time": datetime.now().isoformat(),
        }
        if is_main:
            with open(
                os.path.join(output_dir, "training_summary.json"), "w"
            ) as f:
                json.dump(summary, f, indent=2)
        print(f"\nTraining complete in {total_time / 60:.1f} minutes")
        print(f"  Final loss: {latest_loss:.4f}")
        print(f"  Final PER: {metrics['per']:.2f}%")
        print(f"  Final PFER: {metrics['pfer']:.2f}%")
    return summary

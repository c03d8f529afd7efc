"""On-card smoke test: the main paths of whisper-ipa on one NVIDIA GPU.

    python chip_smoke.py            # one card: kernels, inference, training, serving
    python chip_smoke.py --multi    # four cards: sharded training and serving only,
                                    # in float32 and in bfloat16

Runs whisper-small at full width with random weights made from a seed, on
audio synthesized from IPA strings (data/synth.py); nothing is fetched.
Every phase compares the card against a plain float32 reference under
``jax.default_matmul_precision("highest")`` (a float32 product on the GPU
may otherwise run in TF32) and fails on any mismatch beyond its stated
tolerance. The script exits non-zero, and prints no result, when JAX finds
no GPU. Its last line is one JSON object naming the device; everything
else goes on earlier lines. Scratch files (the synthesized dataset and
the training checkpoints) go to artifacts/chip_smoke/, which .gitignore
lists.

Each phase is a function that takes its model configuration, so the CPU
tests run the same code at the test-tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

OUT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "artifacts", "chip_smoke"
)
IPA_TEXTS = ["pat", "tap", "sit", "kæt", "mɑm", "ʃip", "θɪŋ", "dɔɡ",
             "bu", "nɛt", "lif", "ʒa"]
# bf16 keeps 8 mantissa bits: one rounding is at most 2^-9 relative and
# a result of magnitude ~1 is good to a few of its 2^-8 ulps. Errors are
# measured relative to the largest reference magnitude.
BF16_KERNEL_TOL = 2e-2
# Gradients pass through dS = P * (dP - rowsum(P * dP)), where a bf16
# rounding of logits |S| ~ 5 moves a probability by ~1% before dS is
# summed over 1500 keys; measured 1.4e-2 to 2.2e-2 on the bf16 einsum
# path on CPU.
BF16_GRAD_TOL = 5e-2
# first decode-step logits after 24 bf16 layers (about sqrt(24) roundings
# of 2^-9 each, compounded through the residual stream) and an int8
# cross-KV cache (1/254 of each position's range per element): RMS error
# relative to the RMS of the reference logits.
BF16_LOGITS_RMS_TOL = 5e-2
# bf16 under sharding: a sharded reduction rounds differently from the
# single-device one, so nothing is bit-equal. The loss is a mean over B*T
# tokens of terms whose bf16 error is about 1e-2 of the logits' spread.
BF16_SHARDED_LOSS_TOL = 5e-3
# AdamW's first updates are close to -lr * sign(grad): bf16 noise flips
# the sign only of near-zero gradients, a wrong gradient flips half.
BF16_UPDATE_SIGN_AGREEMENT = 0.9
# a greedy token of the sharded bf16 engine, scored by single-device bf16
# logits along the same tokens, may trail the best allowed logit by this
# much of the row's standard deviation: ten times the bf16 logits' RMS
# error (about 1e-2 of it), while a wrong token trails the best of 51865
# logits by several deviations.
BF16_TOKEN_MARGIN = 0.1


@dataclass
class PhaseLog:
    """Wall and compile seconds of each phase, and what it checked."""

    rows: list = field(default_factory=list)
    _compile_s: float = 0.0

    def on_duration(self, event, duration, **kwargs):
        if event in ("/jax/core/compile/backend_compile_duration",
                     "/jax/compilation_cache/cache_retrieval_time_sec"):
            self._compile_s += duration

    @contextmanager
    def phase(self, name):
        c0, t0 = self._compile_s, time.perf_counter()
        print(f"== phase {name}", flush=True)
        yield
        row = {"phase": name,
               "wall_s": round(time.perf_counter() - t0, 2),
               "compile_s": round(self._compile_s - c0, 2)}
        self.rows.append(row)
        print(f"== phase {name} done: {json.dumps(row)}", flush=True)


def _rel_err(x, ref):
    """max |x - ref| over max |ref|, in float64 on the host."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _check(name, err, tol):
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: rel err {err:.3e} (tolerance {tol:.0e}) {status}",
          flush=True)
    if err > tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:.0e}")


def _audio_batch(n, seed=0):
    """n 30 s windows of synthesized speech (float32, 16 kHz)."""
    from whisper_ipa.audio import pad_or_trim
    from whisper_ipa.data.synth import synthesize_ipa

    return np.stack([
        pad_or_trim(synthesize_ipa(IPA_TEXTS[i % len(IPA_TEXTS)],
                                   seed=seed + i))
        for i in range(n)
    ]).astype(np.float32)


# -- phase 1: kernels against their plain references --------------------

def check_encoder_attention(cfg, batch=4, seed=0, q_len=None):
    """Encoder self-attention in bf16 (or, with q_len, a query of that
    length over the encoder's keys), forward and gradient, through
    models/layers.multi_head_attention (cuDNN's fused kernel on the GPU
    where the policy picks it) against the einsum path in float32 at
    highest precision."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.models import layers

    H, T, d = cfg.n_audio_head, cfg.n_audio_ctx, cfg.n_audio_state
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    k, v = (jax.random.normal(kk, (batch, T, d), jnp.float32)
            for kk in keys[:2])
    q, g = (jax.random.normal(kk, (batch, q_len or T, d), jnp.float32)
            for kk in keys[2:])
    q16, k16, v16 = (x.astype(jnp.bfloat16) for x in (q, k, v))
    print(f"  cuDNN policy at q={q16.shape[1]}, k={T}: "
          f"{layers.use_cudnn_attention(q16, k16, None)}")

    def loss(f, q, k, v):
        return jnp.sum(f(q, k, v).astype(jnp.float32) * g)

    def kernel(q, k, v):
        return layers.multi_head_attention(q, k, v, H)

    def reference(q, k, v):
        return layers._attention_core(
            q, k, v, None, n_head=H, scale=(d // H) ** -0.25
        )

    out = jax.jit(kernel)(q16, k16, v16)
    grads = jax.jit(jax.grad(lambda *a: loss(kernel, *a), (0, 1, 2)))(
        q16, k16, v16)
    # the reference sees the same bf16-rounded inputs, widened to f32
    qf, kf, vf = (x.astype(jnp.float32) for x in (q16, k16, v16))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(reference)(qf, kf, vf)
        ref_grads = jax.jit(
            jax.grad(lambda *a: loss(reference, *a), (0, 1, 2)))(qf, kf, vf)
    errs = {"fwd": _rel_err(out, ref)}
    for name, gr, rg in zip(("dq", "dk", "dv"), grads, ref_grads):
        errs[name] = _rel_err(gr, rg)
    for name, err in errs.items():
        _check(f"attention {name} (B={batch}, q={q16.shape[1]}, k={T}, "
               f"H={H})",
               err, BF16_KERNEL_TOL if name == "fwd" else BF16_GRAD_TOL)
    return errs


def check_log_mel(cfg, batch=4, time_batch=None):
    """30 s log-mel on the device (audio/mel.log_mel_spectrogram_jax, its
    DFT and mel products at highest precision) against the NumPy host
    front end; optionally times the stage at time_batch windows."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.audio import log_mel_spectrogram
    from whisper_ipa.audio.mel import log_mel_spectrogram_jax

    audio = _audio_batch(batch)
    mel_fn = jax.jit(lambda a: log_mel_spectrogram_jax(a, n_mels=cfg.n_mels))
    dev = np.asarray(mel_fn(jnp.asarray(audio)))
    host = np.stack([log_mel_spectrogram(a, n_mels=cfg.n_mels) for a in audio])
    if dev.shape != host.shape:
        raise AssertionError(f"log-mel shape {dev.shape} != {host.shape}")
    # log-mel values lie in [-1, 1.5] after Whisper's scaling; float32
    # DFTs of 400 samples agree to ~1e-5, and the log10 of the smallest
    # (clamped) powers amplifies that: 2e-3 absolute, relative to the max
    err = _rel_err(dev, host)
    _check(f"log-mel (B={batch}, {cfg.n_mels} mels, 30 s)", err, 2e-3)
    out = {"err": err}
    if time_batch:
        big = jax.random.normal(
            jax.random.PRNGKey(1), (time_batch, audio.shape[1])) * 0.1
        jax.block_until_ready(mel_fn(big))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(mel_fn(big))
            times.append(time.perf_counter() - t0)
        out["time_ms"] = 1000.0 * float(np.median(times))
        out["time_batch"] = time_batch
        print(f"  log-mel time: {out['time_ms']:.3f} ms for {time_batch} "
              "windows (median of 5)")
    return out


def check_int8_cross_attention(cfg, batch=4, seed=0):
    """One decode step's cross-attention over the padded int8 cache
    (init_cache's T-minor layout, 1536 positions for T=1500) against
    float32 attention over the dequantized cache at highest precision."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.models import layers
    from whisper_ipa.models.whisper import _quantize_kv_heads

    H, T, d = cfg.n_text_head, cfg.n_audio_ctx, cfg.n_text_state
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(keys[0], (batch, 1, d), jnp.float32)
    k = jax.random.normal(keys[1], (batch, T, d), jnp.float32)
    v = jax.random.normal(keys[2], (batch, T, d), jnp.float32)
    k_i8, k_s = _quantize_kv_heads(k, H)
    v_i8, v_s = _quantize_kv_heads(v, H)
    out = jax.jit(lambda *a: layers.multi_head_attention_int8kv(*a, H))(
        q.astype(jnp.bfloat16), k_i8, k_s, v_i8, v_s)

    def dequant(codes, scale):  # (B, H, Dh, T_pad) -> (B, T, d)
        x = codes.astype(jnp.float32) * scale[:, :, None, :]
        return x[..., :T].transpose(0, 3, 1, 2).reshape(batch, T, d)

    q_ref = q.astype(jnp.bfloat16).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda q, k, v: layers._attention_core(
            q, k, v, None, n_head=H, scale=(d // H) ** -0.25))(
                q_ref, dequant(k_i8, k_s), dequant(v_i8, v_s))
    err = _rel_err(out, ref)
    _check(f"int8 cross-KV decode step (B={batch}, T_pad={k_i8.shape[-1]})",
           err, BF16_KERNEL_TOL)
    return {"err": err}


def phase_kernels(cfg, batch=4, mel_time_batch=None):
    return {
        "encoder_attention": check_encoder_attention(cfg, batch),
        # both sides of the policy's even-length rule, gradient included
        "attention_q128": check_encoder_attention(cfg, batch, q_len=128),
        "attention_q129": check_encoder_attention(cfg, batch, q_len=129),
        "log_mel": check_log_mel(cfg, batch, mel_time_batch),
        "int8_cross_attention": check_int8_cross_attention(cfg, batch),
    }


# -- phase 2: batched inference ------------------------------------------

def _first_step_logits(params, cfg, mel, prompt, dtype, kv_int8):
    """Logits after the SOT prompt, as the decode loop computes them."""
    import jax.numpy as jnp

    from whisper_ipa.models.whisper import (
        cast_decoder_blocks, decode_step, encode, init_cache)

    if dtype != jnp.float32:
        params = cast_decoder_blocks(params, dtype)
    feats = encode(params, cfg, mel, dtype=dtype)
    cache = init_cache(params, cfg, feats, max_len=prompt.shape[1] + 1,
                       dtype=dtype, cross_kv_int8=kv_int8)
    logits, _ = decode_step(params, cfg, prompt, cache, 0, dtype=dtype)
    return logits[:, -1].astype(jnp.float32)


def phase_inference(cfg, params, batch=32, beam_batch=4, sample_len=32,
                    check_batch=2):
    """Greedy decode (bf16, int8 cross-KV: the bench.py headline path)
    and beam-5 decode through decode(), plus a first-step logits check
    against float32 at highest precision."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.audio.mel import log_mel_spectrogram_jax
    from whisper_ipa.decode import DecodingOptions, decode
    from whisper_ipa.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    audio = jnp.asarray(_audio_batch(batch))
    mel = jax.jit(lambda a: log_mel_spectrogram_jax(a, n_mels=cfg.n_mels))(
        audio)
    opts = DecodingOptions(language="en", without_timestamps=True,
                           sample_len=sample_len, fp16=True, kv_int8=True,
                           suppress_tokens=[-1, tok.eot])
    t0 = time.perf_counter()
    greedy = decode(params, cfg, mel, opts, tokenizer=tok)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    greedy = decode(params, cfg, mel, opts, tokenizer=tok)
    t_second = time.perf_counter() - t0
    if len(greedy) != batch or any(
            len(r.tokens) != sample_len or not np.isfinite(r.avg_logprob)
            for r in greedy):
        raise AssertionError("greedy decode: wrong length or non-finite")
    print(f"  greedy: batch {batch}, {sample_len} tokens each, "
          f"{t_first:.2f} s first call, {t_second:.3f} s second "
          f"({batch * 30.0 / t_second:.1f}x realtime)")

    beam_opts = DecodingOptions(language="en", without_timestamps=True,
                                sample_len=sample_len // 2, fp16=True,
                                kv_int8=True, beam_size=5)
    beams = decode(params, cfg, mel[:beam_batch], beam_opts, tokenizer=tok)
    if len(beams) != beam_batch or any(
            not np.isfinite(r.avg_logprob) for r in beams):
        raise AssertionError("beam-5 decode: wrong batch or non-finite")
    print(f"  beam-5: batch {beam_batch}, lengths "
          f"{[len(r.tokens) for r in beams]}")

    prompt = jnp.asarray([list(tok.sot_sequence_including_notimestamps)]
                         * check_batch, jnp.int32)
    fast = jax.jit(lambda p, m: _first_step_logits(
        p, cfg, m, prompt, jnp.bfloat16, True))(params, mel[:check_batch])
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, m: _first_step_logits(
            p, cfg, m, prompt, jnp.float32, False))(params, mel[:check_batch])
    fast, ref = np.asarray(fast, np.float64), np.asarray(ref, np.float64)
    if not np.all(np.isfinite(fast)):
        raise AssertionError("first-step logits are not finite")
    rms = float(np.sqrt(np.mean((fast - ref) ** 2))
                / np.sqrt(np.mean((ref - ref.mean()) ** 2)))
    _check("first-step logits, bf16 + int8 cross-KV vs f32 (RMS)", rms,
           BF16_LOGITS_RMS_TOL)
    agree = float(np.mean(fast.argmax(-1) == ref.argmax(-1)))
    print(f"  first-step argmax agreement: {agree:.2f}")
    return {"greedy_first_s": t_first, "greedy_second_s": t_second,
            "logits_rms_err": rms, "argmax_agreement": agree}


# -- phase 3: training ----------------------------------------------------

def _write_dataset(root, n, seed):
    from whisper_ipa.audio import write_wav
    from whisper_ipa.data.synth import synthesize_ipa

    os.makedirs(root, exist_ok=True)
    entries = []
    for i in range(n):
        ipa = IPA_TEXTS[i % len(IPA_TEXTS)]
        path = os.path.join(root, f"u{seed + i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=seed + i))
        entries.append({"audio_path": path, "ipa_transcription": ipa,
                        "speaker_id": f"s{i % 3}",
                        "dataset_source": "synthetic"})
    path = root + ".json"
    with open(path, "w") as f:
        json.dump(entries, f)
    return path


def phase_training(model_name, out_dir, batch=12, steps=4, dtype="bfloat16"):
    """The training loop (train/loop.train, as the train CLI calls it):
    `steps` steps, a checkpoint, a resume from it, and one more step."""
    from whisper_ipa.config import get_config
    from whisper_ipa.models import init_params, to_mlx_flat
    from whisper_ipa.train import (
        create_train_state, latest_checkpoint, restore_checkpoint, train)
    from whisper_ipa.utils.safetensors import load_file

    shutil.rmtree(out_dir, ignore_errors=True)
    train_json = _write_dataset(os.path.join(out_dir, "train"), 2 * batch, 0)
    test_json = _write_dataset(os.path.join(out_dir, "test"), 4, 100)
    run_dir = os.path.join(out_dir, "run")
    common = dict(
        model_name=model_name, train_data_path=train_json,
        test_data_path=test_json, output_dir=run_dir, batch_size=batch,
        learning_rate=1e-4, validate_every=0, save_every=steps,
        data_parallel=False, compute_dtype=dtype, final_validate=False,
        fixed_token_len=16,
    )
    first = train(num_steps=steps, **common)
    ckpt = latest_checkpoint(run_dir)
    if not np.isfinite(first["final_loss"]) or ckpt is None:
        raise AssertionError(f"training: loss {first.get('final_loss')}, "
                             f"checkpoint {ckpt}")

    # the resume path (restore_checkpoint) must reproduce the saved
    # tensors bit for bit
    cfg = get_config(model_name)
    template, _ = create_train_state(init_params(cfg, seed=1),
                                     learning_rate=1e-4)
    restored, meta = restore_checkpoint(ckpt, template)
    saved = load_file(os.path.join(ckpt, "model.safetensors"))
    got = {k: np.asarray(v) for k, v in to_mlx_flat(restored.params).items()}
    if set(got) != set(saved):
        raise AssertionError("restored parameter names differ from saved")
    n_diff = sum(
        not np.array_equal(got[k], saved[k]) or got[k].dtype != saved[k].dtype
        for k in saved)
    if n_diff or int(restored.step) != steps:
        raise AssertionError(f"resume: {n_diff} tensors differ, step "
                             f"{int(restored.step)} != {steps}")
    print(f"  resume: {len(saved)} tensors restored bit-exact at step {steps}")
    del template, restored

    second = train(num_steps=steps + 1, resume=True, **common)
    last = latest_checkpoint(run_dir)
    with open(os.path.join(last, "training_state.json")) as f:
        step = json.load(f)["step"]
    if not np.isfinite(second["final_loss"]) or step != steps + 1:
        raise AssertionError(f"resumed step: loss {second.get('final_loss')},"
                             f" step {step}")
    print(f"  losses: {first['final_loss']:.4f} at step {steps}, "
          f"{second['final_loss']:.4f} at step {steps + 1} after resume")
    return {"loss": first["final_loss"], "resumed_loss": second["final_loss"]}


# -- phase 4: serving -----------------------------------------------------

def _greedy_reference(params, cfg, audios, tok, max_new):
    import jax.numpy as jnp

    from whisper_ipa.audio import log_mel_spectrogram
    from whisper_ipa.decode import DecodingOptions, decode

    mel = np.stack([log_mel_spectrogram(a, n_mels=cfg.n_mels)
                    for a in audios])
    res = decode(params, cfg, jnp.asarray(mel),
                 DecodingOptions(language="en", without_timestamps=True,
                                 sample_len=max_new), tokenizer=tok)
    return [r.tokens for r in res]


def _submit_joining(eng, audios):
    """Submit the first request, then the others while it decodes."""
    started = threading.Event()
    futs = [eng.submit(audios[0], on_token=lambda _: started.set())]
    if not started.wait(timeout=900):
        raise AssertionError("engine produced no token in 900 s")
    for a in audios[1:]:
        time.sleep(0.02)
        futs.append(eng.submit(a))
    return [f.result(timeout=900) for f in futs]


def phase_serving(cfg, params, n_requests=5, slots=4, max_new=16,
                  mesh=None):
    """The continuous engine answers requests that join a running batch;
    in float32 at highest precision its tokens must equal standalone
    greedy decode of the same audio (the join-parity oracle)."""
    import jax

    from whisper_ipa.serve_continuous import ContinuousBatcher
    from whisper_ipa.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    audios = list(_audio_batch(n_requests, seed=50))
    prev = jax.config.jax_default_matmul_precision
    # the engine runs its programs on its own thread, so the precision is
    # set process-wide for this phase and restored after it
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        eng = ContinuousBatcher(params, cfg, slots=slots,
                                max_new_tokens=max_new, steps_per_sync=2,
                                language="en", tokenizer=tok, mesh=mesh)
        try:
            results = _submit_joining(eng, audios)
            if mesh is not None:
                _check_spread(eng.cache, "engine KV cache")
            stats = eng.stats()
        finally:
            eng.close()
        ref = _greedy_reference(params, cfg, audios, tok, max_new)
    finally:
        jax.config.update("jax_default_matmul_precision", prev)
    got = [r["tokens"] for r in results]
    if got != ref:
        raise AssertionError(f"engine tokens differ from standalone greedy:"
                             f" {got} vs {ref}")
    print(f"  engine: {n_requests} requests over {slots} slots, tokens equal "
          f"standalone greedy; lengths {[len(t) for t in got]}; "
          f"stats {stats}")
    return {"requests": n_requests, "tokens": sum(len(t) for t in got)}


# -- --multi: four cards --------------------------------------------------

def _check_spread(tree, what):
    """Every sharded leaf must place its shards on distinct devices."""
    import jax

    for leaf in jax.tree.leaves(tree):
        devs = {s.device for s in leaf.addressable_shards}
        if len(leaf.sharding.device_set) > 1 and len(devs) < 2:
            raise AssertionError(f"{what}: all shards on one device")
    devices = set().union(*(
        leaf.sharding.device_set for leaf in jax.tree.leaves(tree)))
    print(f"  {what}: spread over {len(devices)} devices")


def _train_batch(cfg, batch, token_len):
    """Random mel and an SOT-prompted token batch ending in EOT."""
    rng = np.random.default_rng(0)
    mel = rng.standard_normal(
        (batch, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
    eot = 50257
    tok = np.full((batch, token_len), 300, np.int32)
    tok[:, :4] = [50258, 50259, 50359, 50363]
    tok[:, 4:-1] = rng.integers(0, 50000, (batch, token_len - 5))
    tok[:, -1] = eot
    return mel, tok, eot


def phase_multi_train(cfg, batch=8, token_len=16):
    """One train step on a data x model = 2 x 2 mesh, replicated, ZeRO-1
    and FSDP, each against the single-device step on the same batch."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.models import init_params
    from whisper_ipa.parallel import (
        fsdp_param_shardings, make_mesh, param_shardings, shard_batch,
        shard_params)
    from whisper_ipa.train import (
        create_train_state, create_train_state_zero1, make_zero1_step,
        train_step)

    mesh = make_mesh(model=2, devices=jax.devices()[:4])
    mel, tok, eot = _train_batch(cfg, batch, token_len)
    losses = {}
    with jax.default_matmul_precision("highest"):
        state, tx = create_train_state(init_params(cfg, seed=0),
                                       learning_rate=1e-4)
        _, ref = train_step(state, jnp.asarray(mel), jnp.asarray(tok), cfg,
                            tx, eot)
        losses["single"] = float(ref)

        smel, stok = shard_batch(mesh, jnp.asarray(mel), jnp.asarray(tok))
        params = shard_params(mesh, init_params(cfg, seed=0),
                              tensor_parallel=True)
        _check_spread(params, "tensor-parallel params")
        state, tx = create_train_state(params, learning_rate=1e-4)
        _, loss = train_step(state, smel, stok, cfg, tx, eot)
        losses["dp2_tp2"] = float(loss)

        zparams = shard_params(mesh, init_params(cfg, seed=0),
                               tensor_parallel=True)
        zstate, ztx, opt_sh = create_train_state_zero1(
            mesh, zparams, learning_rate=1e-4, tensor_parallel=True)
        zstep = make_zero1_step(mesh, cfg, ztx, eot, opt_sh,
                                param_shardings=param_shardings(mesh, zparams))
        zstate, loss = zstep(zstate, smel, stok)
        _check_spread(zstate.opt_state, "ZeRO-1 optimizer state")
        losses["zero1"] = float(loss)

        fsdp_sh = fsdp_param_shardings(mesh, init_params(cfg, seed=0),
                                       tensor_parallel=True)
        fparams = jax.tree.map(jax.device_put, init_params(cfg, seed=0),
                               fsdp_sh)
        fstate, ftx, fopt_sh = create_train_state_zero1(
            mesh, fparams, learning_rate=1e-4, tensor_parallel=True)
        fstep = make_zero1_step(mesh, cfg, ftx, eot, fopt_sh,
                                param_shardings=fsdp_sh)
        fstate, loss = fstep(fstate, smel, stok)
        _check_spread(fstate.params, "FSDP params")
        losses["fsdp"] = float(loss)
    for name in ("dp2_tp2", "zero1", "fsdp"):
        # float32 at highest precision: only the order of the sharded
        # reductions differs from the single-device step
        _check(f"{name} loss {losses[name]:.6f} vs single-device "
               f"{losses['single']:.6f}",
               abs(losses[name] - losses["single"]) / abs(losses["single"]),
               1e-4)
    return losses


def phase_multi_train_bf16(cfg, batch=8, token_len=16):
    """Two bf16 train steps with the encoder unfrozen, so the encoder's
    attention runs forward and backward (cuDNN on the GPU), on the data x
    model = 2 x 2 mesh, against the same two steps on one device: the
    losses, and the signs of the encoder's update."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.models import init_params
    from whisper_ipa.parallel import make_mesh, shard_batch, shard_params
    from whisper_ipa.train import create_train_state, train_step

    mesh = make_mesh(model=2, devices=jax.devices()[:4])
    mel, tok, eot = _train_batch(cfg, batch, token_len)
    before = [np.asarray(x, np.float32)
              for x in jax.tree.leaves(init_params(cfg, seed=0)["encoder"])]

    def two_steps(params, mel, tok):
        state, tx = create_train_state(params, learning_rate=1e-4,
                                       freeze_encoder=False)
        losses = []
        for _ in range(2):
            state, loss = train_step(state, mel, tok, cfg, tx, eot,
                                     freeze_encoder=False,
                                     dtype_name="bfloat16")
            losses.append(float(loss))
        return losses, [np.sign(np.asarray(x, np.float32) - b) for x, b in
                        zip(jax.tree.leaves(state.params["encoder"]), before)]

    single, single_sign = two_steps(init_params(cfg, seed=0),
                                    jnp.asarray(mel), jnp.asarray(tok))
    smel, stok = shard_batch(mesh, jnp.asarray(mel), jnp.asarray(tok))
    params = shard_params(mesh, init_params(cfg, seed=0),
                          tensor_parallel=True)
    _check_spread(params, "bf16 tensor-parallel params")
    sharded, sharded_sign = two_steps(params, smel, stok)
    moved = np.concatenate([s.ravel() != 0 for s in single_sign])
    same = np.concatenate([(s == t).ravel()
                           for s, t in zip(single_sign, sharded_sign)])
    agree = float(same[moved].mean())
    print(f"  bf16 dp2_tp2 losses {sharded}, single-device {single}; encoder"
          f" update sign agreement {agree:.4f} over {int(moved.sum())} "
          f"weights (at least {BF16_UPDATE_SIGN_AGREEMENT})")
    for i in range(2):
        _check(f"bf16 dp2_tp2 step {i + 1} loss vs single-device",
               abs(sharded[i] - single[i]) / abs(single[i]),
               BF16_SHARDED_LOSS_TOL)
    if agree < BF16_UPDATE_SIGN_AGREEMENT:
        raise AssertionError(f"bf16 dp2_tp2 encoder update agrees in sign "
                             f"on only {agree:.4f} of weights")
    return {"single": single, "dp2_tp2": sharded, "sign_agreement": agree}


def phase_multi_serving(cfg, params):
    """The engine with its slots sharded over four cards (--dp 4)."""
    import jax

    from whisper_ipa.parallel import make_mesh

    return phase_serving(cfg, params, n_requests=5, slots=4,
                         mesh=make_mesh(devices=jax.devices()[:4]))


def phase_multi_serving_bf16(cfg, params, n_requests=5, slots=4,
                             max_new=16):
    """The bf16 engine on a data x model = 2 x 2 mesh (slots over 'data',
    weights and heads over 'model'). Single-device bf16 teacher-forced
    logits along its tokens score each of them: each must be within
    BF16_TOKEN_MARGIN of the best token the engine was allowed to pick."""
    import jax
    import jax.numpy as jnp

    from whisper_ipa.audio import log_mel_spectrogram
    from whisper_ipa.decode.decoding import build_blank_mask
    from whisper_ipa.models.whisper import decoder_logits, encode
    from whisper_ipa.parallel import make_mesh
    from whisper_ipa.serve_continuous import ContinuousBatcher
    from whisper_ipa.tokenizer import get_tokenizer

    tok = get_tokenizer(multilingual=True, num_languages=cfg.num_languages,
                        language="en")
    audios = list(_audio_batch(n_requests, seed=70))
    eng = ContinuousBatcher(params, cfg, slots=slots, max_new_tokens=max_new,
                            steps_per_sync=2, language="en", tokenizer=tok,
                            bf16=True, mesh=make_mesh(
                                model=2, devices=jax.devices()[:4]),
                            tensor_parallel=True)
    try:
        got = [r["tokens"] for r in _submit_joining(eng, audios)]
        _check_spread(eng.cache, "bf16 dp2_tp2 engine KV cache")
        prefix, allowed = list(eng.prefix), np.asarray(eng.suppress)
    finally:
        eng.close()

    seqs = [prefix + t + ([tok.eot] if len(t) < max_new else []) for t in got]
    width = max(len(s) for s in seqs)
    tokens = np.array([s + [tok.eot] * (width - len(s)) for s in seqs],
                      np.int32)
    mel = np.stack([log_mel_spectrogram(a, n_mels=cfg.n_mels)
                    for a in audios])
    logits = np.asarray(jax.jit(lambda p, m, t: decoder_logits(
        p, cfg, t, encode(p, cfg, m, dtype=jnp.bfloat16),
        dtype=jnp.bfloat16).astype(jnp.float32))(
            params, jnp.asarray(mel), jnp.asarray(tokens)), np.float64)
    blank = build_blank_mask(tok, cfg.n_vocab)
    worst = 0.0
    for i, seq in enumerate(seqs):
        for pos in range(len(prefix), len(seq)):
            row = logits[i, pos - 1]
            lg = row + allowed + (blank if pos == len(prefix) else 0.0)
            worst = max(worst, (lg.max() - row[seq[pos]]) / row.std())
    print(f"  bf16 dp2_tp2 engine: {n_requests} requests, lengths "
          f"{[len(t) for t in got]}; worst token trails the single-device "
          f"best by {worst:.4f} deviations")
    if worst > BF16_TOKEN_MARGIN:
        raise AssertionError(f"bf16 dp2_tp2 engine token trails the "
                             f"single-device best by {worst:.4f} > "
                             f"{BF16_TOKEN_MARGIN}")
    return {"worst_margin": worst, "tokens": sum(len(t) for t in got)}


# -- entry point ----------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths and their oracles")
    ap.add_argument("--model", default="small")
    args = ap.parse_args(argv)

    import jax

    from whisper_ipa.config import get_config
    from whisper_ipa.models import init_params
    from whisper_ipa.utils.compile_cache import enable_compile_cache
    from whisper_ipa.utils.device import gpu_name_and_power_limit, require_gpu

    dev = require_gpu()
    if args.multi and len(jax.devices()) != 4:
        raise SystemExit(f"--multi needs 4 GPUs, found {len(jax.devices())}")
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)

    log = PhaseLog()
    jax.monitoring.register_event_duration_secs_listener(log.on_duration)
    cfg = get_config(args.model)
    t0 = time.perf_counter()
    if args.multi:
        with log.phase("multi_train"):
            phase_multi_train(cfg)
        with log.phase("multi_train_bf16"):
            phase_multi_train_bf16(cfg)
        params = init_params(cfg, seed=0)
        with log.phase("multi_serving"):
            phase_multi_serving(cfg, params)
        with log.phase("multi_serving_bf16"):
            phase_multi_serving_bf16(cfg, params)
        del params
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in jax.devices()]
        print(f"peak bytes in use per device: {peaks}")
    else:
        with log.phase("kernels"):
            phase_kernels(cfg, batch=4, mel_time_batch=192)
        params = init_params(cfg, seed=0)
        with log.phase("inference"):
            phase_inference(cfg, params, batch=32)
        with log.phase("serving"):
            phase_serving(cfg, params)
        del params
        with log.phase("training"):
            phase_training(args.model, os.path.join(OUT_DIR, "training"))
    print(f"phases: {json.dumps(log.rows)}")
    print(f"total wall: {time.perf_counter() - t0:.1f} s "
          f"(compile {sum(r['compile_s'] for r in log.rows):.1f} s)")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

"""Real 2-process multi-host test (VERDICT r1 next-step 5).

Spawns two actual OS processes, initializes jax.distributed over localhost,
and runs one data-parallel train step with the global batch assembled from
host-local shards (each process contributes only its own rows via
jax.make_array_from_process_local_data — no cross-host input copy). Both
processes must compute the identical global loss.

This exercises the exact path train() takes on a pod:
parallel/distributed.{initialize,local_shard_indices,global_batch_from_local}
+ the GSPMD all-reduce inside train_step.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
from whisper_ipa.parallel.distributed import (
    global_batch_from_local, initialize, local_shard_indices, process_info,
)
initialize(f"localhost:{port}", num_processes=2, process_id=pid)

info = process_info()
assert info["process_count"] == 2, info
assert info["global_device_count"] == 4, info

import numpy as np
import jax.numpy as jnp
from dataclasses import replace
from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params
from whisper_ipa.parallel import make_mesh, shard_params
from whisper_ipa.train import create_train_state, train_step

cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
params = init_params(cfg, seed=0)
mesh = make_mesh(model=1)  # 4 global devices -> data=4
params = shard_params(mesh, params, tensor_parallel=False)
state, tx = create_train_state(params, learning_rate=1e-4)

# host-local input pipeline: 8 global samples, each host owns 4
n_global = 8
shard = local_shard_indices(n_global)
assert len(shard) == 4
assert shard == (list(range(0, 4)) if pid == 0 else list(range(4, 8))), shard

rng = np.random.default_rng(0)
global_mel = rng.standard_normal((n_global, cfg.n_audio_ctx * 2, cfg.n_mels)).astype(np.float32)
eot = 50257
global_tok = np.tile([[50258, 50259, 50359, 50363, 100, 200, eot, eot]], (n_global, 1)).astype(np.int32)

mel = global_batch_from_local(mesh, global_mel[shard])
tokens = global_batch_from_local(mesh, global_tok[shard])
assert mel.shape == (n_global, cfg.n_audio_ctx * 2, cfg.n_mels)

state, loss = train_step(state, mel, tokens, cfg, tx, eot)
print(f"RESULT pid={pid} loss={float(loss):.6f}", flush=True)
"""


def test_two_process_dp_train_step(tmp_path):
    # free localhost port for the jax.distributed coordinator
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # children must choose their own platform/flags
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO_ROOT,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=570)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"

    losses = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert lines, out[-2000:]
        losses.append(float(lines[0].split("loss=")[1]))
    # both processes see the same global loss (GSPMD all-reduce worked)
    assert losses[0] == pytest.approx(losses[1], abs=1e-6)


# -- full production loop: train -> validate -> checkpoint -> kill -> resume

LOOP_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

port, pid, num_steps, out_dir, data_json = sys.argv[1:6]
pid, num_steps = int(pid), int(num_steps)

from whisper_ipa.parallel.distributed import initialize
initialize(f"localhost:{port}", num_processes=2, process_id=pid)

# spy on checkpoint file writes: ONLY process 0 may touch the filesystem
import whisper_ipa.train.checkpoints as ckpt_mod
writes = []
_orig = ckpt_mod.save_safetensors
ckpt_mod.save_safetensors = lambda path, params: (
    writes.append(path), _orig(path, params))[1]

from dataclasses import replace
import whisper_ipa.config as config_mod
config_mod.CONFIGS["test-micro-mh"] = replace(
    config_mod.CONFIGS["test-tiny"], name="test-micro-mh",
    n_audio_state=32, n_audio_layer=1, n_text_state=32,
    n_text_layer=1, n_text_ctx=48,
)

from whisper_ipa.train.loop import train
summary = train(
    model_name="test-micro-mh",
    train_data_path=data_json,
    test_data_path=data_json,
    output_dir=out_dir,
    num_steps=num_steps,
    batch_size=4,          # global; each host feeds 2 rows
    learning_rate=1e-3,
    validate_every=4,
    save_every=4,
    resume=True,           # first run finds no checkpoint; second resumes
    final_validate=False,
    # FSDP variant (test_two_process_fsdp_train_checkpoint_resume):
    # params device_put from host-local arrays to a cross-host 'data'
    # sharding; the checkpoint save MUST go through the collective
    # fetch (params not fully addressable on either host)
    fsdp=os.environ.get("WHISPER_IPA_TEST_FSDP") == "1",
)

if pid != 0:
    assert not writes, f"process 1 wrote checkpoint files: {writes}"
else:
    assert writes, "process 0 saved nothing"
print(f"RESULT pid={pid} loss={summary['final_loss']:.6f} "
      f"best_pfer={summary['best_pfer']}", flush=True)
"""


def _run_loop_workers(tmp_path, num_steps, out_dir, data_json, extra_env=None):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / f"loop_worker_{num_steps}.py"
    script.write_text(LOOP_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.update(extra_env or {})
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid),
             str(num_steps), out_dir, data_json],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO_ROOT,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=570)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-4000:]}"
    losses = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert lines, out[-2000:]
        losses.append(float(lines[0].split("loss=")[1].split()[0]))
    return outs, losses


@pytest.mark.slow
def test_two_process_train_checkpoint_resume(tmp_path):
    """The full multi-host production loop (VERDICT r2 item 1): a
    2-process DP run that validates, checkpoints (process-0-gated,
    collective param fetch), dies, and RESUMES from its checkpoint with
    a continuing loss trajectory and no duplicate/raced file writes."""
    import json

    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    from test_dataset import make_synthetic_dataset

    data_json = make_synthetic_dataset(str(tmp_path / "ds"))
    out_dir = str(tmp_path / "run")

    # phase 1: train 8 steps (validates at 4+8, checkpoints at 4+8),
    # then the processes exit — the "kill"
    outs1, losses1 = _run_loop_workers(tmp_path, 8, out_dir, data_json)
    assert losses1[0] == pytest.approx(losses1[1], abs=1e-5)
    assert os.path.isdir(os.path.join(out_dir, "checkpoint-8"))
    assert os.path.isdir(os.path.join(out_dir, "best-checkpoint"))
    with open(os.path.join(out_dir, "validation_log.csv")) as f:
        val_rows_1 = f.read().strip().splitlines()
    assert len(val_rows_1) >= 3  # header + validations at steps 4, 8

    # phase 2: fresh processes resume from checkpoint-8 and run to 16
    outs2, losses2 = _run_loop_workers(tmp_path, 16, out_dir, data_json)
    assert losses2[0] == pytest.approx(losses2[1], abs=1e-5)
    assert any("Resumed from" in o and "step 8" in o for o in outs2)
    # steps restart at 9, not 1 (console shows the parse-contract line)
    assert any("Step 10/16" in o for o in outs2)
    assert os.path.isdir(os.path.join(out_dir, "checkpoint-16"))
    # the loss keeps falling across the kill/resume boundary
    assert losses2[0] < losses1[0]
    # optimizer moments came back too
    with open(
        os.path.join(out_dir, "checkpoint-16", "training_state.json")
    ) as f:
        assert json.load(f)["step"] == 16


@pytest.mark.slow
def test_two_process_fsdp_train_checkpoint_resume(tmp_path):
    """FSDP across 2 real processes: parameters live 'data'-sharded over
    a cross-host mesh (1/4 of the weights per device, NOT fully
    addressable on either host), so the checkpoint save must collectively
    fetch them and resume must re-place the restored host arrays onto the
    cross-host FSDP sharding — the ZeRO-3 pod path end to end."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "tests"))
    from test_dataset import make_synthetic_dataset

    data_json = make_synthetic_dataset(str(tmp_path / "ds"))
    out_dir = str(tmp_path / "run_fsdp")
    fsdp_env = {"WHISPER_IPA_TEST_FSDP": "1"}

    outs1, losses1 = _run_loop_workers(
        tmp_path, 8, out_dir, data_json, extra_env=fsdp_env
    )
    assert losses1[0] == pytest.approx(losses1[1], abs=1e-5)
    assert any("FSDP (ZeRO-3)" in o for o in outs1)
    assert os.path.isdir(os.path.join(out_dir, "checkpoint-8"))

    outs2, losses2 = _run_loop_workers(
        tmp_path, 16, out_dir, data_json, extra_env=fsdp_env
    )
    assert losses2[0] == pytest.approx(losses2[1], abs=1e-5)
    assert any("Resumed from" in o and "step 8" in o for o in outs2)
    assert os.path.isdir(os.path.join(out_dir, "checkpoint-16"))
    # the loss keeps falling across the kill/resume boundary
    assert losses2[0] < losses1[0]


FETCH_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

port, pid = sys.argv[1], int(sys.argv[2])
from whisper_ipa.parallel.distributed import initialize
initialize(f"localhost:{port}", num_processes=2, process_id=pid)

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from whisper_ipa.parallel import make_mesh
from whisper_ipa.parallel.distributed import global_batch_from_local
from whisper_ipa.train.checkpoints import fetch_tree_to_host

mesh = make_mesh(model=1)  # (data=4, model=1) over 2 hosts x 2 devices
full = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)

# cross-host 'data'-sharded array: NOT fully addressable on either host
sharded = global_batch_from_local(mesh, full[pid * 2 : pid * 2 + 2])
assert not sharded.is_fully_addressable and not sharded.is_fully_replicated

# replicated array: addressable read, no collective needed
replicated = jax.device_put(full, NamedSharding(mesh, P()))

tree = {"sharded": sharded, "replicated": replicated, "host": full * 2}
out = fetch_tree_to_host(tree)
assert np.array_equal(out["sharded"], full), out["sharded"]
assert np.array_equal(out["replicated"], full)
assert np.array_equal(out["host"], full * 2)
print(f"RESULT pid={pid} ok", flush=True)
"""


def test_two_process_sharded_fetch(tmp_path):
    """fetch_tree_to_host gathers cross-host-sharded leaves (the
    np.asarray-raises case from VERDICT r2) to full numpy on every
    process, and reads replicated/host leaves without a collective."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "fetch_worker.py"
    script.write_text(FETCH_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO_ROOT,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=570)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert f"RESULT pid={pid} ok" in out

"""CLI: out-of-process training speed monitor.

Observes a running training job from outside: process runtime via ps,
latest checkpoint step/loss, and the console-log parse contract
``Step N/M | Loss: L | Time: Ts | Samples/sec: S``
(reference calculate_real_speed.py).

Usage: python -m whisper_ipa.cli.calculate_real_speed \
    [PID] [CHECKPOINT_DIR] [TOTAL_STEPS] [BATCH_SIZE] [--log-file PATH]
"""

import argparse
import json
import subprocess
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional


def get_process_runtime(pid: int) -> Optional[int]:
    """Process elapsed seconds via `ps -o etime=` ([[DD-]hh:]mm:ss)."""
    try:
        result = subprocess.run(
            ["ps", "-p", str(pid), "-o", "etime="],
            capture_output=True,
            text=True,
            check=True,
        )
        etime = result.stdout.strip()
        parts = etime.split(":")
        if len(parts) == 3:
            dh = parts[0]
            if "-" in dh:
                days, hours = dh.split("-")
            else:
                days, hours = "0", dh
            return (
                int(days) * 86400
                + int(hours) * 3600
                + int(parts[1]) * 60
                + int(parts[2])
            )
        if len(parts) == 2:
            return int(parts[0]) * 60 + int(parts[1])
        return int(parts[0])
    except Exception as e:
        print(f"Error getting process runtime: {e}")
        return None


def get_latest_checkpoint(checkpoint_dir) -> Optional[Dict]:
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.exists():
        return None
    checkpoints = sorted(
        (
            d
            for d in checkpoint_dir.iterdir()
            if d.is_dir() and d.name.startswith("checkpoint-")
        ),
        key=lambda x: int(x.name.replace("checkpoint-", "")),
    )
    if not checkpoints:
        return None
    latest = checkpoints[-1]
    loss = None
    state_file = latest / "training_state.json"
    if state_file.exists():
        with open(state_file) as f:
            loss = json.load(f).get("loss")
    return {
        "step": int(latest.name.replace("checkpoint-", "")),
        "path": latest,
        "time": datetime.fromtimestamp(latest.stat().st_mtime),
        "loss": loss,
    }


def parse_log_for_steps(log_file, num_samples: int = 20) -> List[Dict]:
    """Parse the console format contract for recent step timings."""
    log_file = Path(log_file)
    if not log_file.exists():
        return []
    steps = []
    for line in log_file.read_text(errors="replace").splitlines():
        if "Step" in line and "Time:" in line and "Samples/sec:" in line:
            try:
                step_num = int(line.split("Step")[1].split("/")[0].strip())
                time_part = [p for p in line.split("|") if "Time:" in p][0]
                time_sec = float(
                    time_part.split("Time:")[1].split("s")[0].strip()
                )
                samp_part = [p for p in line.split("|") if "Samples/sec:" in p][0]
                samp_sec = float(samp_part.split("Samples/sec:")[1].strip())
                steps.append(
                    {
                        "step": step_num,
                        "time": time_sec,
                        "samples_per_sec": samp_sec,
                    }
                )
            except (ValueError, IndexError):
                continue
    return steps[-num_samples:]


def calculate_real_estimate(
    pid: int,
    checkpoint_dir,
    total_steps: int,
    batch_size: int = 16,
    log_file=None,
) -> Optional[Dict]:
    print("=" * 70)
    print("Real Training Speed Analysis")
    print("=" * 70)

    runtime_sec = get_process_runtime(pid)
    if runtime_sec is None:
        print(f"Could not get runtime for PID {pid}")
        return None
    print(
        f"Process Runtime: {runtime_sec // 3600}h "
        f"{(runtime_sec % 3600) // 60}m {runtime_sec % 60}s"
    )

    checkpoint = get_latest_checkpoint(checkpoint_dir)
    out: Dict = {"runtime_sec": runtime_sec}
    if checkpoint and checkpoint["step"] > 0:
        step = checkpoint["step"]
        print(f"Latest Checkpoint: Step {step} / {total_steps} "
              f"({step * 100 / total_steps:.1f}%)")
        if checkpoint["loss"] is not None:
            print(f"  Loss: {checkpoint['loss']:.4f}")
        avg = runtime_sec / step
        remaining = avg * (total_steps - step)
        print(f"Average Time per Step: {avg:.3f} s")
        print(
            f"Estimated Remaining: {int(remaining // 3600)}h "
            f"{int((remaining % 3600) // 60)}m"
        )
        print(f"Actual Throughput: {batch_size / avg:.2f} samples/sec")
        out.update(
            step=step,
            avg_time_per_step=avg,
            remaining_sec=remaining,
            samples_per_sec=batch_size / avg,
        )
    else:
        print("No checkpoints yet - cannot compute an accurate estimate.")

    if log_file:
        steps = parse_log_for_steps(log_file)
        if steps:
            recent = sum(s["samples_per_sec"] for s in steps) / len(steps)
            print(
                f"Recent log throughput ({len(steps)} samples): "
                f"{recent:.2f} samples/sec"
            )
            out["recent_samples_per_sec"] = recent
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Training speed monitor")
    p.add_argument("pid", type=int, nargs="?", default=None)
    p.add_argument(
        "checkpoint_dir", nargs="?", default="checkpoints/whisper-ipa"
    )
    p.add_argument("total_steps", type=int, nargs="?", default=10000)
    p.add_argument("batch_size", type=int, nargs="?", default=16)
    p.add_argument("--log-file", type=str, default=None)
    args = p.parse_args(argv)
    if args.pid is None:
        p.error("PID required")
    calculate_real_estimate(
        args.pid,
        args.checkpoint_dir,
        args.total_steps,
        args.batch_size,
        log_file=args.log_file,
    )


if __name__ == "__main__":
    main()

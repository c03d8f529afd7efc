"""CLI smoke tests (host-only paths; heavy model CLIs tested via units)."""

import json
import subprocess
import sys

import pytest

from tests.conftest import REPO_ROOT


def run_cli(module, *args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", f"whisper_ipa.cli.{module}", *args],
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=timeout,
        env={
            **__import__("os").environ,
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO_ROOT,
        },
    )


class TestMetricCLI:
    def test_evaluate_ipa_selftest(self):
        out = run_cli("evaluate_ipa")
        assert out.returncode == 0, out.stderr
        assert "All tests passed!" in out.stdout


class TestSpeedMonitor:
    def test_log_parse_contract(self, tmp_path):
        from whisper_ipa.cli.calculate_real_speed import (
            parse_log_for_steps,
        )
        from whisper_ipa.train.logger import console_step_line

        log = tmp_path / "train.log"
        lines = [
            console_step_line(step, 100, 2.5, 0.5, 8) for step in (10, 20, 30)
        ]
        log.write_text("\n".join(lines) + "\n")
        steps = parse_log_for_steps(log)
        assert [s["step"] for s in steps] == [10, 20, 30]
        assert steps[0]["samples_per_sec"] == pytest.approx(16.0)

    def test_latest_checkpoint_discovery(self, tmp_path):
        from whisper_ipa.cli.calculate_real_speed import (
            get_latest_checkpoint,
        )

        for step in (100, 500, 250):
            d = tmp_path / f"checkpoint-{step}"
            d.mkdir()
            (d / "training_state.json").write_text(
                json.dumps({"step": step, "loss": 1.0})
            )
        latest = get_latest_checkpoint(tmp_path)
        assert latest["step"] == 500

    def test_own_pid_runtime(self):
        import os

        from whisper_ipa.cli.calculate_real_speed import (
            get_process_runtime,
        )

        rt = get_process_runtime(os.getpid())
        assert rt is not None and rt >= 0


class TestPrepareDatasetsCLI:
    def test_verify_subcommand(self, tmp_path):
        ds = tmp_path / "d.json"
        ds.write_text(json.dumps([{"ipa_transcription": "kæt"}]))
        out = run_cli("prepare_datasets", "verify", str(ds))
        assert out.returncode == 0, out.stderr

    def test_combine_subcommand(self, tmp_path):
        d = tmp_path / "processed"
        d.mkdir()
        for name in (
            "timit_train_ipa.json",
            "timit_test_ipa.json",
            "metu_turkish_ipa.json",
            "ogi_spelled_ipa.json",
        ):
            (d / name).write_text(
                json.dumps([{"audio_path": "x", "ipa_transcription": "a"}])
            )
        out = run_cli("prepare_datasets", "combine", "--processed-dir", str(d))
        assert out.returncode == 0, out.stderr
        assert (d / "combined_train_ipa.json").exists()


class TestBenchmarkModelsCLI:
    def test_param_counts(self):
        out = run_cli("benchmark_models", "--models", "tiny")
        assert out.returncode == 0, out.stderr
        assert "tiny" in out.stdout


class TestUtils:
    def test_tree_count_and_bytes(self):
        import numpy as np

        from whisper_ipa.utils import tree_bytes, tree_count

        tree = {"a": np.zeros((2, 3), np.float32), "b": [np.ones(4, np.int32)]}
        assert tree_count(tree) == 10
        assert tree_bytes(tree) == 6 * 4 + 4 * 4

    def test_step_timer(self):
        import time

        from whisper_ipa.utils import StepTimer

        t = StepTimer()
        with t:
            time.sleep(0.01)
        assert t.mean >= 0.01


class TestConvertWeights:
    def test_roundtrip_mlx(self, tmp_path):
        from dataclasses import replace

        import whisper_ipa.config as config_mod
        from whisper_ipa.cli.convert_weights import main as convert_main
        from whisper_ipa.models import init_params, save_safetensors

        config_mod.CONFIGS.setdefault(
            "test-micro2",
            replace(config_mod.CONFIGS["test-tiny"], name="test-micro2"),
        )
        params = init_params(config_mod.CONFIGS["test-micro2"], seed=0)
        src = str(tmp_path / "in.safetensors")
        dst = str(tmp_path / "out.safetensors")
        save_safetensors(src, params)
        convert_main(
            ["--input", src, "--model", "test-micro2", "--output", dst,
             "--verify"]
        )
        import os

        assert os.path.isfile(dst)


class TestEvaluateModelBeam:
    def test_beam_eval_plumbs_through(self, tmp_path):
        """--beam-size reaches DecodingOptions: a tiny in-process eval
        with beam_size=2 must produce the same metric SURFACE as greedy
        (both run the full evaluate loop; hypotheses may differ)."""
        from dataclasses import replace

        from tests.test_dataset import make_synthetic_dataset
        from whisper_ipa.cli.evaluate_model import evaluate_model
        from whisper_ipa.config import CONFIGS
        from whisper_ipa.models import init_params

        cfg = replace(CONFIGS["test-tiny"], n_audio_ctx=32, n_text_ctx=32)
        params = init_params(cfg, seed=0)
        data_json = make_synthetic_dataset(str(tmp_path / "ds"), n=2)
        greedy = evaluate_model(
            params, cfg, data_json, num_samples=2, batch_size=2
        )
        beamed = evaluate_model(
            params, cfg, data_json, num_samples=2, batch_size=2,
            beam_size=2,
        )
        for r in (greedy, beamed):
            assert set(r) >= {"per", "pfer"}
            assert 0.0 <= r["pfer"]

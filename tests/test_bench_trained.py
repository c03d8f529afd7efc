"""bench.py trained-row path: discovery + real-audio measurement.

These tests pin the checkpoint-discovery contract and drive
bench_trained end-to-end on CPU so a broken trained row is caught before
a run on the card.
"""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import bench  # noqa: E402


@pytest.fixture
def fake_run(tmp_path, monkeypatch):
    """A trained-run directory (test-tiny checkpoint) + 2-utterance data."""
    from whisper_ipa.audio import write_wav
    from whisper_ipa.config import CONFIGS
    from whisper_ipa.data.synth import synthesize_ipa
    from whisper_ipa.models import init_params
    from whisper_ipa.train.checkpoints import save_checkpoint
    from whisper_ipa.train.step import create_train_state

    run_dir = tmp_path / "run"
    data_dir = tmp_path / "data"
    os.makedirs(data_dir)
    entries = []
    for i, ipa in enumerate(["pat", "tap"]):
        path = str(data_dir / f"u{i}.wav")
        write_wav(path, synthesize_ipa(ipa, seed=i))
        entries.append(
            {
                "audio_path": path,
                "ipa_transcription": ipa,
                "speaker_id": f"s{i}",
                "dataset_source": "synthetic",
            }
        )
    data_json = str(tmp_path / "test.json")
    with open(data_json, "w") as f:
        json.dump(entries, f)

    params = init_params(CONFIGS["test-tiny"], seed=0)
    state, _ = create_train_state(params)
    save_checkpoint(state, 5, 1.0, str(run_dir), save_opt_state=False)
    with open(run_dir / "training_config.json", "w") as f:
        json.dump({"training_args": {"model_name": "test-tiny"}}, f)

    ckpt = str(run_dir / "checkpoint-5")
    monkeypatch.setenv("WHISPER_IPA_BENCH_CKPT", ckpt)
    monkeypatch.setenv("WHISPER_IPA_BENCH_DATA", data_json)
    return ckpt, data_json


class TestDiscoverTrained:
    def test_env_override_wins(self, fake_run):
        ckpt, data_json = fake_run
        found = bench.discover_trained()
        assert found is not None
        f_ckpt, f_data, model = found
        assert f_ckpt == ckpt and f_data == data_json
        assert model == "test-tiny"  # read from training_config.json

    def test_missing_files_skipped(self, monkeypatch):
        monkeypatch.setenv("WHISPER_IPA_BENCH_CKPT", "/nonexistent/x")
        monkeypatch.setenv("WHISPER_IPA_BENCH_DATA", "/nonexistent/y")
        found = bench.discover_trained()
        # falls through to the well-known paths or None — never the
        # broken env pair
        if found is not None:
            assert found[0] != "/nonexistent/x"


class TestBenchTrained:
    def test_end_to_end(self, fake_run):
        ckpt, data_json = fake_run
        r = bench.bench_trained(
            ckpt, data_json, "test-tiny", batch=2, sample_len=4, iters=1
        )
        assert r["batch"] == 2
        assert r["rtf_30s"] > 0
        assert np.isfinite(r["per"]) and np.isfinite(r["pfer"])
        assert r["checkpoint"] == ckpt

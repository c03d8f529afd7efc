"""examples/corpus_report.py: per-locale held-out breakdown driver.

Covers the critical path: a checkpoint decodes the full split with
ONE compiled program (the tail batch is padded to the batch size — a
second batch shape costs a second compile)
and the locale join scores every utterance exactly once.
"""

import json
import os
import sys

import numpy as np

from whisper_ipa.config import CONFIGS
from whisper_ipa.models import init_params


def test_corpus_report_end_to_end(tmp_path, monkeypatch):
    from whisper_ipa.audio import write_wav
    from whisper_ipa.data.synth import synthesize_ipa
    from whisper_ipa.train.checkpoints import save_checkpoint
    from whisper_ipa.train.step import create_train_state

    run_dir = tmp_path / "run"
    state, _ = create_train_state(init_params(CONFIGS["test-tiny"], seed=0))
    save_checkpoint(state, 1, 1.0, str(tmp_path / "ck"), save_opt_state=False)
    os.makedirs(run_dir)
    os.rename(tmp_path / "ck" / "checkpoint-1", run_dir / "best-checkpoint")

    # 3 utterances at batch 2 -> one full batch + a padded tail batch
    data = []
    for i, (ipa, loc) in enumerate([("pat", "fi"), ("tak", "fi"),
                                    ("ki", "ta")]):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, synthesize_ipa(ipa, seed=i))
        data.append(
            {"audio_path": p, "ipa_transcription": ipa, "locale": loc}
        )
    dj = str(tmp_path / "test.json")
    with open(dj, "w") as f:
        json.dump(data, f, ensure_ascii=False)

    import runpy

    monkeypatch.setattr(
        sys, "argv",
        ["corpus_report.py", "--run-dir", str(run_dir), "--data", dj,
         "--model", "test-tiny", "--batch", "2", "--sample-len", "8"],
    )
    runpy.run_path(
        os.path.join(
            os.path.dirname(__file__), "..", "examples", "corpus_report.py"
        ),
        run_name="__main__",
    )

    with open(run_dir / "corpus_report.json") as f:
        report = json.load(f)
    # every utterance scored exactly once (pad rows dropped)
    assert report["n_scored"] == 3
    assert report["by_locale"]["fi"]["n"] == 2
    assert report["by_locale"]["ta"]["n"] == 1
    # random weights on real synth audio: wrong but finite metrics
    assert np.isfinite(report["overall"]["per"])
    assert np.isfinite(report["overall"]["pfer"])

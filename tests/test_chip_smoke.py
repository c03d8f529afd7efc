"""chip_smoke.py phases, called as functions at the test-tiny size on CPU.

The script's own main() insists on a GPU; these tests run the same phase
code here so a broken phase is caught before a run on the card.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

from whisper_ipa.config import CONFIGS  # noqa: E402
from whisper_ipa.models import init_params  # noqa: E402

CFG = CONFIGS["test-tiny"]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0)


@pytest.mark.parametrize(
    "check",
    [chip_smoke.check_encoder_attention, chip_smoke.check_log_mel,
     chip_smoke.check_int8_cross_attention],
    ids=["encoder_attention", "log_mel", "int8_cross_attention"],
)
def test_kernel_checks_pass_on_cpu(check):
    out = check(CFG, batch=2)
    assert out


def test_log_mel_timing_reported():
    out = chip_smoke.check_log_mel(CFG, batch=1, time_batch=2)
    assert out["time_batch"] == 2 and out["time_ms"] > 0


def test_inference_phase(params):
    out = chip_smoke.phase_inference(
        CFG, params, batch=2, beam_batch=2, sample_len=4, check_batch=1
    )
    assert out["logits_rms_err"] <= chip_smoke.BF16_LOGITS_RMS_TOL


def test_serving_phase(params):
    out = chip_smoke.phase_serving(CFG, params, n_requests=3, slots=2,
                                   max_new=4)
    assert out["requests"] == 3


def test_training_phase(tmp_path):
    out = chip_smoke.phase_training("test-tiny", str(tmp_path), batch=2,
                                    steps=2, dtype="float32")
    assert np.isfinite(out["loss"]) and np.isfinite(out["resumed_loss"])


def test_rel_err_and_check():
    assert chip_smoke._rel_err(np.ones(3), np.ones(3)) == 0.0
    assert chip_smoke._rel_err([1.0, 2.1], [1.0, 2.0]) == pytest.approx(0.05)
    with pytest.raises(AssertionError):
        chip_smoke._check("x", 0.1, 1e-2)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "no GPU" in str(e.value)
    assert '"ok"' not in capsys.readouterr().out


def test_multi_train_phase():
    losses = chip_smoke.phase_multi_train(CFG, batch=4, token_len=8)
    assert set(losses) == {"single", "dp2_tp2", "zero1", "fsdp"}


def test_multi_train_bf16_phase():
    out = chip_smoke.phase_multi_train_bf16(CFG, batch=4, token_len=8)
    assert out["sign_agreement"] >= chip_smoke.BF16_UPDATE_SIGN_AGREEMENT


def test_multi_serving_phase(params):
    out = chip_smoke.phase_multi_serving(CFG, params)
    assert out["requests"] == 5


def test_multi_serving_bf16_phase(params):
    out = chip_smoke.phase_multi_serving_bf16(CFG, params, n_requests=3,
                                              max_new=6)
    assert out["worst_margin"] <= chip_smoke.BF16_TOKEN_MARGIN

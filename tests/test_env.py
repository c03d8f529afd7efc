"""Environment settings: present names, former names, and their readers.

Before the package took its present name, every variable carried one more
word after ``WHISPER_IPA_``; ``OLD`` stands for that word here.
"""

import os
import warnings

import numpy as np
import pytest

from whisper_ipa.env import former_name, setting

NAMES = ["TIKTOKEN", "PANPHON_CSV", "WEIGHTS_DIR", "KANJI_DICT",
         "ALLOW_VOCAB_MISMATCH", "NATIVE_LIB", "LEGACY_BEAM", "BENCH_CKPT",
         "BENCH_DATA", "DRYRUN_REAL"]


@pytest.fixture
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("WHISPER_IPA_"):
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.mark.parametrize("name", NAMES)
def test_former_name_is_read_with_a_warning(clean_env, name):
    clean_env.setenv(f"WHISPER_IPA_OLD_{name}", "former")
    with pytest.warns(FutureWarning, match=f"set WHISPER_IPA_{name} instead"):
        assert setting(name) == "former"
    # the present name wins, silently
    clean_env.setenv(f"WHISPER_IPA_{name}", "present")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert setting(name) == "present"


def test_unset_gives_default_without_warning(clean_env):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert setting("TIKTOKEN") is None
        assert setting("WEIGHTS_DIR", "") == ""


def test_present_names_are_not_former_names_of_others(clean_env):
    # one present name must never be read as another's former spelling
    for name in NAMES:
        clean_env.setenv(f"WHISPER_IPA_{name}", "x")
    assert all(former_name(n) is None for n in NAMES)


def test_tokenizer_finds_rank_file_by_former_name(clean_env, tmp_path):
    from whisper_ipa.tokenizer.whisper_tokenizer import _find_ranks_file

    ranks = tmp_path / "multilingual.tiktoken"
    ranks.write_text("")
    clean_env.setenv("WHISPER_IPA_OLD_TIKTOKEN", str(ranks))
    with pytest.warns(FutureWarning):
        assert _find_ranks_file(None) == str(ranks)


def test_panphon_csv_loaded_by_former_name(clean_env, tmp_path):
    from whisper_ipa.metrics import features

    csv = tmp_path / "ipa_all.csv"
    csv.write_text("ipa,syl,son\np,-,-\n", encoding="utf-8")
    loaded = []
    clean_env.setattr(features, "load_panphon_csv", loaded.append)
    clean_env.setenv("WHISPER_IPA_OLD_PANPHON_CSV", str(csv))
    with pytest.warns(FutureWarning):
        features.load_panphon_csv_from_env()
    assert loaded == [str(csv)]


def _saved_tiny(root):
    from whisper_ipa.config import get_config
    from whisper_ipa.models import init_params
    from whisper_ipa.models.convert import save_safetensors

    cfg = get_config("test-tiny")
    params = init_params(cfg, seed=3)
    os.makedirs(root, exist_ok=True)
    save_safetensors(os.path.join(root, f"{cfg.name}.safetensors"), params)
    return cfg, params


def _assert_same(a, b):
    import jax

    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_weights_dir_by_former_name(clean_env, tmp_path):
    from whisper_ipa.train.loop import load_or_init_params

    clean_env.setenv("HOME", str(tmp_path / "home"))
    cfg, params = _saved_tiny(str(tmp_path / "weights"))
    clean_env.setenv("WHISPER_IPA_OLD_WEIGHTS_DIR", str(tmp_path / "weights"))
    with pytest.warns(FutureWarning):
        loaded = load_or_init_params(cfg.name, cfg, None)
    _assert_same(loaded, params)


def test_weights_in_former_cache_directory(clean_env, tmp_path):
    from whisper_ipa.train.loop import load_or_init_params

    home = tmp_path / "home"
    clean_env.setenv("HOME", str(home))
    cfg, params = _saved_tiny(str(home / ".cache" / "whisper_ipa_old"))
    with pytest.warns(FutureWarning, match="former cache directory"):
        loaded = load_or_init_params(cfg.name, cfg, None)
    _assert_same(loaded, params)

"""Compile-cache placement, the peak table, GPU-only measurement entry
points, and the main path's imports."""

import os
import subprocess
import sys

import jax
import pytest

from whisper_ipa.utils import compile_cache
from whisper_ipa.utils.flops import PEAK_BF16_FLOPS, peak_flops

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_cache_dir_is_honoured(monkeypatch, tmp_path, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the program sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_default_cache_dir_is_fixed_inside_checkout(monkeypatch,
                                                    restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache()
    assert first == os.path.join(REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first


def test_default_cache_dir_is_gitignored():
    name = os.path.basename(compile_cache.DEFAULT_CACHE_DIR)
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert f"{name}/" in f.read().split()


@pytest.mark.parametrize(
    "kind,peak",
    [("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756.5e12),
     ("NVIDIA A100-SXM4-80GB", None), ("cpu", None)],
)
def test_peak_table(kind, peak):
    assert peak_flops(kind) == peak


def test_peak_table_only_lists_gpus():
    assert all(k.startswith("NVIDIA ") for k in PEAK_BF16_FLOPS)


@pytest.mark.parametrize("script,args", [("bench.py", []),
                                         ("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--multi"])])
def test_gpu_entry_points_fail_without_gpu(script, args):
    """No GPU: non-zero exit and no result line, never a fallback."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script, *args], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert "{" not in proc.stdout


@pytest.mark.parametrize(
    "module",
    ["whisper_ipa.decode", "whisper_ipa.train.loop",
     "whisper_ipa.serve_continuous", "whisper_ipa.tokenizer",
     "whisper_ipa.train.checkpoints"],
)
def test_main_path_imports_without_optional_packages(module):
    """The main path needs none of regex, safetensors or pandas."""
    code = (
        "import sys\n"
        "for name in ('regex', 'safetensors', 'pandas', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        f"import {module}\n"
        "from whisper_ipa.tokenizer import get_tokenizer\n"
        "tok = get_tokenizer(multilingual=True, language='en')\n"
        "assert tok.decode(tok.encode('ˈfoʊ nə')) == 'ˈfoʊ nə'\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr

"""The first-party safetensors reader/writer (utils/safetensors.py)."""

import ml_dtypes
import numpy as np
import pytest

from whisper_ipa.utils.safetensors import load_file, save_file

DTYPES = [np.bool_, np.uint8, np.int8, np.int16, np.uint16, np.float16,
          ml_dtypes.bfloat16, np.int32, np.uint32, np.float32, np.int64,
          np.uint64, np.float64, ml_dtypes.float8_e4m3fn,
          ml_dtypes.float8_e5m2]


def _sample(dtype, shape=(3, 5), seed=0):
    x = np.random.default_rng(seed).standard_normal(shape) * 4
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_roundtrip_per_dtype(tmp_path, dtype):
    path = str(tmp_path / "t.safetensors")
    tensors = {"a": _sample(dtype), "b.c": _sample(dtype, (7,), 1)}
    save_file(tensors, path)
    got = load_file(path)
    assert sorted(got) == ["a", "b.c"]
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      want.view(np.uint8))


def test_zero_dim_and_empty_arrays(tmp_path):
    path = str(tmp_path / "t.safetensors")
    save_file({"step": np.asarray(7, np.int32),
               "empty": np.zeros((0, 4), np.float32)}, path)
    got = load_file(path)
    assert got["step"].shape == () and int(got["step"]) == 7
    assert got["empty"].shape == (0, 4)


def test_header_layout(tmp_path):
    """8-byte little-endian length, JSON header padded to 8 bytes, data."""
    import json
    import struct

    path = str(tmp_path / "t.safetensors")
    save_file({"x": np.arange(3, dtype=np.float32)}, path,
              metadata={"format": "np"})
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0 and len(raw) == 8 + n + 12
    header = json.loads(raw[8:8 + n])
    assert header["x"] == {"dtype": "F32", "shape": [3],
                           "data_offsets": [0, 12]}
    assert header["__metadata__"] == {"format": "np"}


@pytest.mark.parametrize("damage", ["truncated", "bad_offsets", "bad_dtype"])
def test_rejects_malformed(tmp_path, damage):
    import json
    import struct

    path = str(tmp_path / "t.safetensors")
    header = {"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}
    body = np.zeros(4, np.float32).tobytes()
    if damage == "bad_offsets":
        header["x"]["data_offsets"] = [0, 12]
    if damage == "bad_dtype":
        header["x"]["dtype"] = "Q7"
    raw = json.dumps(header).encode()
    blob = struct.pack("<Q", len(raw)) + raw + body
    if damage == "truncated":
        blob = blob[:8 + len(raw) // 2]
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(ValueError):
        load_file(path)


@pytest.mark.parametrize("direction", ["package_to_codec", "codec_to_package"])
def test_interoperates_with_safetensors_package(tmp_path, direction):
    st = pytest.importorskip("safetensors.numpy")
    path = str(tmp_path / "t.safetensors")
    tensors = {np.dtype(d).name: _sample(d, (2, 3), i)
               for i, d in enumerate(DTYPES)
               if d not in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2)}
    tensors["scalar"] = np.asarray(1.5, np.float32)
    writer, reader = ((st.save_file, load_file)
                      if direction == "package_to_codec"
                      else (save_file, st.load_file))
    writer(tensors, path)
    got = reader(path)
    assert sorted(got) == sorted(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        np.testing.assert_array_equal(got[name], want)

"""Reader and writer for the safetensors file format, in NumPy alone.

A file is an 8-byte little-endian header length N, a JSON header of N
bytes, then the raw little-endian bytes of every tensor. The header maps
each tensor name to {"dtype", "shape", "data_offsets": [begin, end]},
offsets relative to the end of the header, and may hold string metadata
under "__metadata__". Files written here load through the ``safetensors``
package and the reverse; bfloat16 goes through ``ml_dtypes``, which JAX
installs.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import ml_dtypes
import numpy as np

_DTYPES = {
    "BOOL": np.dtype(np.bool_),
    "U8": np.dtype(np.uint8),
    "I8": np.dtype(np.int8),
    "U16": np.dtype("<u2"),
    "I16": np.dtype("<i2"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype(ml_dtypes.bfloat16),
    "U32": np.dtype("<u4"),
    "I32": np.dtype("<i4"),
    "F32": np.dtype("<f4"),
    "U64": np.dtype("<u8"),
    "I64": np.dtype("<i8"),
    "F64": np.dtype("<f8"),
    "F8_E4M3": np.dtype(ml_dtypes.float8_e4m3fn),
    "F8_E5M2": np.dtype(ml_dtypes.float8_e5m2),
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


def save_file(
    tensors: Dict[str, np.ndarray],
    path: str,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write {name: array} to ``path`` in the safetensors format."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs = []
    offset = 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else (
            arr.dtype
        )
        if dt not in _NAMES:
            raise ValueError(f"{name}: dtype {arr.dtype} has no safetensors code")
        data = np.ascontiguousarray(arr, dtype=dt).tobytes()
        header[name] = {
            "dtype": _NAMES[dt],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)  # the reference writer aligns to 8
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Read every tensor of a safetensors file into NumPy arrays."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(buf[8:8 + n].decode("utf-8"))
    body = memoryview(buf)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has unknown dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(body) or end - begin != count * dt.itemsize:
            raise ValueError(f"{path}: {name} has inconsistent data offsets")
        out[name] = np.frombuffer(
            body[begin:end], dtype=dt, count=count
        ).reshape(shape).copy()
    return out

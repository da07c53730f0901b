"""Middlebury ``.flo`` optical-flow codec (numpy only).

Bit-compatible with ``faldoi_tpu.io.flo`` and the reference's iio:
little-endian, magic float 202021.25 ("PIEH"), int32 width/height, then
row-major interleaved (u, v) float32 pairs.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file. Returns a float32 array of shape (h, w, 2)."""
    with open(path, "rb") as fh:
        data = fh.read()
    (magic,) = struct.unpack("<f", data[:4])
    if magic != _MAGIC:
        raise ValueError(f"{path}: bad .flo magic {magic!r}")
    w, h = struct.unpack("<ii", data[4:12])
    expected = 8 * w * h
    if len(data) - 12 < expected:
        raise ValueError(f"{path}: truncated .flo payload")
    flow = np.frombuffer(data[12 : 12 + expected], dtype="<f4")
    return flow.reshape(h, w, 2).astype(np.float32)


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write a (h, w, 2) float32 array as a .flo file."""
    flow = np.ascontiguousarray(flow, dtype="<f4")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be (h, w, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as fh:
        fh.write(struct.pack("<f", _MAGIC))
        fh.write(struct.pack("<ii", w, h))
        fh.write(flow.tobytes())

"""Sparse seed rasterisation — reference "Algorithm 4" (``sparse_flow.cpp``).

Port of ``faldoi_tpu/core/sparse.py`` (numpy; JAX's C++ fast path,
``faldoi_tpu/native/``, is host parsing and is not ported).  Reads match
lines ``x0 y0 x1 y1 ...`` and writes ``u = x1 - x0, v = y1 - y0`` at pixel
``(floor(x0), floor(y0))`` of an all-NaN (h, w, 2) field.  Matches outside
the frame are dropped; a later match overwrites an earlier one at the same
pixel, as in the C loop.
"""

from __future__ import annotations

import numpy as np


def parse_matches(path: str) -> np.ndarray:
    """Read a match file: (n, >=4) float32, every line cut to the fewest
    columns of any line of 4 or more; shorter lines are skipped."""
    rows = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 4:
                rows.append([float(p) for p in parts])
    if not rows:
        return np.zeros((0, 4), np.float32)
    ncol = min(len(r) for r in rows)
    return np.array([r[:ncol] for r in rows], dtype=np.float32)


def sparse_flow_from_matches(matches: np.ndarray, w: int, h: int) -> np.ndarray:
    """Rasterise (n, >=4) matches into an (h, w, 2) NaN-initialised field."""
    out = np.full((h, w, 2), np.nan, dtype=np.float32)
    if matches.shape[0]:
        x0, y0, x1, y1 = matches[:, 0], matches[:, 1], matches[:, 2], matches[:, 3]
        i = np.floor(x0).astype(np.int64)
        j = np.floor(y0).astype(np.int64)
        ok = (i >= 0) & (i < w) & (j >= 0) & (j < h)
        # numpy's fancy assignment keeps the last of repeated indices
        out[j[ok], i[ok], 0] = (x1 - x0)[ok]
        out[j[ok], i[ok], 1] = (y1 - y0)[ok]
    return out


def sparse_flow(match_path: str, w: int, h: int) -> np.ndarray:
    """The (h, w, 2) seed field of a match file for a w x h frame."""
    return sparse_flow_from_matches(parse_matches(match_path), w, h)

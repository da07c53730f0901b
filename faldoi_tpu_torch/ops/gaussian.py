"""Separable Gaussian smoothing with the reference's exact kernel and padding.

Port of ``faldoi_tpu/ops/gaussian.py`` (``src/mask.c:248-357``): one-sided
window ``int(5 sigma) + 1``, kernel normalised by ``2 sum(B) - B[0]``, row
pass then column pass, and the asymmetric reflecting boundary: the left pad
mirrors about the first sample without repeating it, the right pad mirrors
with repetition.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_kernel(sigma: float) -> np.ndarray:
    """One-sided taps B[0..size-1] exactly as mask.c:267-279 computes them."""
    size = int(5 * sigma) + 1
    den = 2.0 * sigma * sigma
    b = np.array(
        [1.0 / (sigma * math.sqrt(2.0 * 3.1415926)) * math.exp(-i * i / den)
         for i in range(size)],
        dtype=np.float32,
    )
    norm = np.float32(2.0 * b.sum(dtype=np.float32) - b[0])
    return (b / norm).astype(np.float32)


def gaussian1d_weight(r: int) -> np.ndarray:
    """Un-normalised 1-D Gaussian window of length 2r+1, sigma = r/3
    (mask.c:360-378)."""
    sigma = r * 0.3333
    den = 2.0 * sigma * sigma
    i = np.arange(2 * r + 1, dtype=np.float64)
    w = 1.0 / (sigma * math.sqrt(2.0 * 3.1415926)) * np.exp(-((i - r) ** 2) / den)
    return w.astype(np.float32)


def _smooth_rows(img: torch.Tensor, b: np.ndarray) -> torch.Tensor:
    size = b.shape[0]
    n = img.shape[1]
    idx = ([size - k for k in range(size)] + list(range(n))
           + [n - 1 - k for k in range(size)])
    r = img[:, torch.as_tensor(idx, device=img.device)]
    out = float(b[0]) * r[:, size:size + n]
    for j in range(1, size):
        out = out + float(b[j]) * (r[:, size - j:size - j + n]
                                   + r[:, size + j:size + j + n])
    return out


def gaussian_smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Smooth an (h, w) image; row pass then column pass (mask.c:248-357)."""
    if sigma <= 0:
        return img
    b = gaussian_kernel(sigma)
    out = _smooth_rows(img, b)
    return _smooth_rows(out.t(), b).t().contiguous()

"""Image pyramid resampling — ``src/zoom.c``'s functions.

Port of ``faldoi_tpu/ops/zoom.py``: ``zoom_out`` Gaussian-presmooths with
sigma = 0.6 sqrt(1 / factor^2 - 1), then samples bicubically (zoom.c:19-61);
``zoom_in`` samples bicubically at an explicit target size (zoom.c:64-106);
``zoom_size`` rounds the scaled size to nearest (zoom.c:12-16).  The samples
go through K4's point form (``ops.bicubic.bicubic_interp_at``), as JAX's go
through ``bicubic_interp_at``.  The reference's pipeline is single-scale, so
no path of the port calls these.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from faldoi_tpu_torch.ops.bicubic import bicubic_interp_at
from faldoi_tpu_torch.ops.gaussian import gaussian_smooth

ZOOM_SIGMA_ZERO = 0.6


def zoom_size(n: int, factor: float) -> int:
    """zoom.c:12-16: the nearest-int scaled size."""
    return int(n * factor + 0.5)


def _grid(nyy: int, nxx: int, fy: float, fx: float, like: torch.Tensor):
    """Sample positions (x = j / fx, y = i / fy) of an (nyy, nxx) target,
    float32, each divided by its float32 factor (a tensor divisor)."""
    def axis(n, f):
        return (torch.arange(n, dtype=torch.float32, device=like.device)
                / torch.tensor(np.float32(f), device=like.device))
    ii = axis(nyy, fy)[:, None].expand(nyy, nxx).contiguous()
    jj = axis(nxx, fx)[None, :].expand(nyy, nxx).contiguous()
    return jj, ii


def zoom_out(img: torch.Tensor, factor: float) -> torch.Tensor:
    """Downsample an (h, w) image by 0 < factor < 1 with anti-alias
    presmoothing (zoom.c:19-61)."""
    if not 0 < factor < 1:
        raise ValueError(f"zoom_out: factor {factor} not in (0, 1)")
    ny, nx = img.shape
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    sm = gaussian_smooth(img, sigma)
    jj, ii = _grid(zoom_size(ny, factor), zoom_size(nx, factor), factor,
                   factor, img)
    return bicubic_interp_at(sm, jj, ii, False)


def zoom_in(img: torch.Tensor, nyy: int, nxx: int) -> torch.Tensor:
    """Bicubic upsample of an (h, w) image to (nyy, nxx) (zoom.c:64-106)."""
    ny, nx = img.shape
    jj, ii = _grid(nyy, nxx, nyy / float(ny), nxx / float(nx), img)
    return bicubic_interp_at(img, jj, ii, False)

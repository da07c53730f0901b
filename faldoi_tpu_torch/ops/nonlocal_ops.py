"""Non-local TV machinery: support weights, and neighbour access as shifts.

Port of ``faldoi_tpu/ops/nonlocal_ops.py``.  The reference stores per-pixel
neighbour lists (``DualVariables_global``, global_faldoi.cpp:890-897); here,
as in JAX, every quantity is one (n_d, h, w) plane stack and neighbour j is
a static shift.

Conventions (initialize_dual_variables, global_faldoi.cpp:996-1054):

* offsets run k (dy) outer and l (dx) inner, skipping (0, 0);
* neighbour j of pixel (y, x) is (y + dy_j, x + dx_j);
* the reciprocal of j is n_d - 1 - j (its offset is -offset_j);
* weights w_j(x) = sqrt(exp(-hypot(l, k)/ws) * exp(-|Lab(x) - Lab(x_j)|/wi)),
  zero for out-of-bounds neighbours; wt = sum_j w_j.

The weights are computed on the host in numpy, as in JAX (the same bits);
``shift_pull``, ``nonlocal_gradient_duals`` and ``nonlocal_divergence`` are
torch functions on (n_d, h, w) tensors, and the last two are the arithmetic
of the NLTV kernels (``csrc/nltv.cu``: K6 on the image, K7 on (n_d, B, P, P)
canvases), evaluated in their order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def neighbor_offsets(radius: int):
    """(dy, dx) offsets in reference enumeration order."""
    offs = []
    for k in range(-radius, radius + 1):
        for l in range(-radius, radius + 1):
            if k == 0 and l == 0:
                continue
            offs.append((k, l))
    return offs


def shift_pull(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = in[..., y + dy, x + dx], zero-filled outside (callers
    mask)."""
    return shift_each(x[None], ((dy, dx),))[0]


def shift_each(x: torch.Tensor, offs) -> torch.Tensor:
    """Plane j of x (n_d, ..., h, w) shifted by ``offs[j]`` as
    ``shift_pull`` shifts it, in one pad and one stack."""
    r = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (r, r, r, r))
    return torch.stack([xp[j, ..., r + dy:r + dy + h, r + dx:r + dx + w]
                        for j, (dy, dx) in enumerate(offs)])


def valid_mask(h: int, w: int, dy: int, dx: int) -> np.ndarray:
    """True where the (dy, dx) neighbour is inside the image."""
    m = np.zeros((h, w), bool)
    y0 = max(0, -dy)
    y1 = min(h, h - dy)
    x0 = max(0, -dx)
    x1 = min(w, w - dx)
    m[y0:y1, x0:x1] = True
    return m


def rgb_to_lab_np(planes: np.ndarray) -> np.ndarray:
    """image_to_lab (global_faldoi.cpp:906-940): Lab with the reliability
    attenuation on a/b.  Input (pd, h, w) in 0..255; gray inputs are
    broadcast to 3 channels."""
    if planes.shape[0] == 1:
        planes = np.repeat(planes, 3, axis=0)
    r = planes[0].astype(np.float64) / 255.0
    g = planes[1].astype(np.float64) / 255.0
    b = planes[2].astype(np.float64) / 255.0
    T = 0.008856
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    x = x / 0.950456
    z = z / 1.088754
    y3 = np.cbrt(y)
    fx = np.where(x > T, np.cbrt(x), 7.787 * x + 16.0 / 116.0)
    fy = np.where(y > T, y3, 7.787 * y + 16.0 / 116.0)
    fz = np.where(z > T, np.cbrt(z), 7.787 * z + 16.0 / 116.0)
    L = np.where(y > T, 116.0 * y3 - 16.0, 903.3 * y)
    A = 500.0 * (fx - fy)
    B = 200.0 * (fy - fz)
    corr = np.exp(-1.5 * ((L / 100.0) ** 2 - 0.6) ** 2)
    return np.stack([L, A * corr, B * corr]).astype(np.float32)


def nltv_weights(
    lab: np.ndarray, radius: int, ws: float, wi: float
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Per-offset support weights (n_d, h, w), their sum wt (h, w), and the
    offset list.  ws/wi are the spatial/intensity scales (global step: 2 / 5,
    global_faldoi.cpp:885-887; local step: NL_BETA 2 / NL_INTENSITY 2)."""
    pd, h, w = lab.shape
    offs = neighbor_offsets(radius)
    wp = np.zeros((len(offs), h, w), np.float32)
    for j, (dy, dx) in enumerate(offs):
        m = valid_mask(h, w, dy, dx)
        shifted = np.zeros_like(lab)
        ys = slice(max(0, -dy), min(h, h - dy))
        xs = slice(max(0, -dx), min(w, w - dx))
        ys2 = slice(max(0, dy), max(0, dy) + (ys.stop - ys.start))
        xs2 = slice(max(0, dx), max(0, dx) + (xs.stop - xs.start))
        shifted[:, ys, xs] = lab[:, ys2, xs2]
        dif = np.sqrt(((lab - shifted) ** 2).sum(axis=0))
        wsp = math.exp(-math.hypot(dy, dx) / ws)
        wcol = np.exp(-dif / wi)
        wp[j] = np.where(m, np.sqrt(wsp * wcol), 0.0).astype(np.float32)
    wt = wp.sum(axis=0)
    return wp, wt, offs


def nonlocal_gradient_duals(sc, u, wp, wt, offs, tau):
    """ofnltv_getD (global_faldoi.cpp:1127-1174) for one flow component:
    sc_j <- (sc_j + tau*nlgr_j) / (1 + tau*|nlgr_j|), with
    nlgr_j = w_j (u - u_j) / wt, where w_j > 0.  Any leading dims of u
    (the patch solver's B canvases) follow the n_d of sc, wp."""
    nlgr = wp * (u - shift_each(u.expand_as(sc), offs)) / wt
    upd = (sc + tau * nlgr) / (1.0 + tau * nlgr.abs())
    return torch.where(wp > 0, upd, sc)


def nonlocal_divergence(sc, wp, wt, offs):
    """non_local_divergence (global_faldoi.cpp:1056-1079):
    div[x] = sum_j w_j (sc_j[x] - sc_{rj}[x_j]) / wt, divided last."""
    return nonlocal_divergence_sum(sc, wp, offs) / wt


def nonlocal_divergence_sum(sc, wp, offs):
    """sum_j w_j (sc_j[x] - sc_{rj}[x_j]), summed over j in order from zero:
    the global divergence before its division by wt, and the patch solver's
    divergence, which is not normalised (aux_energy_model.cpp:178-212)."""
    return ordered_sum(wp * (sc - shift_each(sc.flip(0), offs)))


def ordered_sum(t: torch.Tensor) -> torch.Tensor:
    """0 + t[0] + t[1] + ... in that order, so the sum rounds the same on
    every device (and as the kernels sum it)."""
    s = torch.zeros_like(t[0])
    for j in range(t.shape[0]):
        s = s + t[j]
    return s

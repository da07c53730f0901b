"""Synthetic frame pairs with a known flow, and seeds placed on them.

A pair is two RGB frames built from analytic textures (sums of random
sinusoids), so frame 1 is frame 0 moved exactly by a two-layer flow: a
background translation plus a rectangle with its own translation, |flow| <= 8
px.  Seeds sit at given positions (e.g. those of the golden DeepMatching seeds
in ``tests/golden/deep_mt_{1,2}.flo``) and take the known flow there, a
fraction of them perturbed by several px so that FB pruning has work to do.
Everything is made from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np

BG_FLOW = (2.6, -1.4)
FG_FLOW = (-5.3, 3.7)
# rectangle of frame 0 as fractions of the frame (y0, x0, y1, x1)
RECT = (0.30, 0.35, 0.65, 0.62)


def _texture(rng, k=14):
    """Random sum of sinusoids -> function (x, y) -> (3, ...) in ~[-1, 1]."""
    period = rng.uniform(5.0, 40.0, k)
    ang = rng.uniform(0.0, 2 * np.pi, k)
    fx, fy = np.cos(ang) / period, np.sin(ang) / period
    phase = rng.uniform(0.0, 2 * np.pi, k)
    amp = rng.uniform(0.2, 1.0, (3, k)) / np.sqrt(k)

    def f(x, y):
        arg = 2 * np.pi * (x[..., None] * fx + y[..., None] * fy) + phase
        return np.einsum("...k,ck->c...", np.sin(arg), amp)

    return f


def make_pair(h: int, w: int, seed: int = 0, full_shape=None):
    """Returns (i0 (3, h, w), i1 (3, h, w)) float32 in 0..255 and the known
    flows gt_fwd (of frame 0) and gt_bwd (of frame 1), (h, w, 2) float32.

    ``full_shape`` (H, W) places the rectangle as in a frame of that size, so
    that an (h, w) pair is the top-left crop of the (H, W) one."""
    rng = np.random.default_rng(seed)
    t_bg, t_fg = _texture(rng), _texture(rng)
    fh, fw = full_shape if full_shape is not None else (h, w)
    y0, x0, y1, x1 = RECT[0] * fh, RECT[1] * fw, RECT[2] * fh, RECT[3] * fw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def in_rect(x, y):
        return (y >= y0) & (y < y1) & (x >= x0) & (x < x1)

    (bu, bv), (fu, fv) = BG_FLOW, FG_FLOW
    r0 = in_rect(xx, yy)
    i0 = np.where(r0, t_fg(xx, yy), t_bg(xx, yy))
    r1 = in_rect(xx - fu, yy - fv)
    i1 = np.where(r1, t_fg(xx - fu, yy - fv), t_bg(xx - bu, yy - bv))

    def to8(x):
        return np.clip(127.5 + 110.0 * x, 0.0, 255.0).astype(np.float32)

    gt_fwd = np.stack([np.where(r0, fu, bu), np.where(r0, fv, bv)], -1)
    gt_bwd = np.stack([np.where(r1, -fu, -bu), np.where(r1, -fv, -bv)], -1)
    return (to8(i0), to8(i1), gt_fwd.astype(np.float32),
            gt_bwd.astype(np.float32))


def seed_positions_from_flo(flow: np.ndarray, h: int, w: int) -> np.ndarray:
    """Flat (h*w) indices of the finite entries of a NaN-sparse seed field
    that fall inside the top-left (h, w) crop."""
    f = flow[:h, :w]
    ok = np.isfinite(f[..., 0]) & np.isfinite(f[..., 1])
    return np.flatnonzero(ok)


def random_seed_positions(h: int, w: int, count: int, rng) -> np.ndarray:
    return np.sort(rng.choice(h * w, size=count, replace=False))


def make_seeds(gt: np.ndarray, positions: np.ndarray, rng,
               outlier_frac: float = 0.05, outlier_px=(3.0, 6.0)) -> np.ndarray:
    """NaN-sparse (h, w, 2) seed field at flat ``positions`` with the known
    flow ``gt``; ``outlier_frac`` of them moved by ``outlier_px`` px in a
    random direction."""
    h, w = gt.shape[:2]
    seeds = np.full((h * w, 2), np.nan, np.float32)
    vals = gt.reshape(-1, 2)[positions].astype(np.float64)
    bad = rng.random(len(positions)) < outlier_frac
    ang = rng.uniform(0.0, 2 * np.pi, len(positions))
    mag = rng.uniform(*outlier_px, len(positions))
    vals[bad, 0] += (mag * np.cos(ang))[bad]
    vals[bad, 1] += (mag * np.sin(ang))[bad]
    seeds[positions] = vals.astype(np.float32)
    return seeds.reshape(h, w, 2)


def epe(a: np.ndarray, b: np.ndarray) -> float:
    """Mean end-point error over the pixels finite in both fields."""
    d = np.sqrt(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2
                 ).sum(-1))
    return float(d[np.isfinite(d)].mean())

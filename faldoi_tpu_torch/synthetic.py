"""Synthetic frame pairs with a known flow, and seeds placed on them.

A pair is two RGB frames built from analytic textures (sums of random
sinusoids), so frame 1 is frame 0 moved exactly by a two-layer flow: a
background translation plus a rectangle with its own translation, |flow| <= 8
px.  Seeds sit at given positions (e.g. those of the golden DeepMatching seeds
in ``tests/golden/deep_mt_{1,2}.flo``) and take the known flow there, a
fraction of them perturbed by several px so that FB pruning has work to do.
``make_quad`` adds the frames I-1 and I2 of the occlusion method (method 8),
moved by minus and by twice the same flow, and the known occlusions of frame
0.  Everything is made from ``numpy.random.default_rng(seed)``.
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


def _frames(h, w, seed, full_shape, steps):
    """Frame k of the two-layer motion for each k in ``steps``: the
    background moved by k BG_FLOW, the rectangle by k FG_FLOW, as float32
    in 0..255; and the helpers (in_rect, the pixel grids)."""
    rng = np.random.default_rng(seed)
    t_bg, t_fg = _texture(rng), _texture(rng)
    fh, fw = full_shape if full_shape is not None else (h, w)
    y0, x0, y1, x1 = RECT[0] * fh, RECT[1] * fw, RECT[2] * fh, RECT[3] * fw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def in_rect(x, y):
        return (y >= y0) & (y < y1) & (x >= x0) & (x < x1)

    (bu, bv), (fu, fv) = BG_FLOW, FG_FLOW

    def to8(x):
        return np.clip(127.5 + 110.0 * x, 0.0, 255.0).astype(np.float32)

    frames = []
    for k in steps:
        rk = in_rect(xx - k * fu, yy - k * fv)
        frames.append(to8(np.where(rk, t_fg(xx - k * fu, yy - k * fv),
                                   t_bg(xx - k * bu, yy - k * bv))))
    return frames, in_rect, xx, yy


def make_pair(h: int, w: int, seed: int = 0, full_shape=None):
    """Returns (i0 (3, h, w), i1 (3, h, w)) float32 in 0..255 and the known
    flows gt_fwd (of frame 0) and gt_bwd (of frame 1), (h, w, 2) float32.

    ``full_shape`` (H, W) places the rectangle as in a frame of that size, so
    that an (h, w) pair is the top-left crop of the (H, W) one."""
    (i0, i1), in_rect, xx, yy = _frames(h, w, seed, full_shape, (0, 1))
    (bu, bv), (fu, fv) = BG_FLOW, FG_FLOW
    r0, r1 = in_rect(xx, yy), in_rect(xx - fu, yy - fv)
    gt_fwd = np.stack([np.where(r0, fu, bu), np.where(r0, fv, bv)], -1)
    gt_bwd = np.stack([np.where(r1, -fu, -bu), np.where(r1, -fv, -bv)], -1)
    return i0, i1, gt_fwd.astype(np.float32), gt_bwd.astype(np.float32)


def make_quad(h: int, w: int, seed: int = 0, full_shape=None):
    """The four frames of method 8, (I0, I1, I-1, I2), each (3, h, w)
    float32 in 0..255: I0 and I1 are ``make_pair``'s, I-1 is I0 moved by
    minus the two-layer flow and I2 by twice it.  Also the known flows
    gt_fwd, gt_bwd of ``make_pair`` and ``occ`` (h, w) float32, the known
    occlusions of I0: the background pixels that the rectangle covers in I1.
    ``full_shape`` as in ``make_pair``."""
    frames, in_rect, xx, yy = _frames(h, w, seed, full_shape, (0, 1, -1, 2))
    _, _, gt_fwd, gt_bwd = make_pair(h, w, seed, full_shape)
    (bu, bv), (fu, fv) = BG_FLOW, FG_FLOW
    occ = ~in_rect(xx, yy) & in_rect(xx + bu - fu, yy + bv - fv)
    return (*frames, gt_fwd, gt_bwd, occ.astype(np.float32))


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


def _occ_frames(h, w, seed, device):
    """``make_quad``'s frames prepared on ``device``, its known flow and
    occlusions; an image under 24 px a side is the top-left crop of a 24 x
    24 one (the presmoothing's window needs the room)."""
    from faldoi_tpu_torch.core.preprocess import prepare_quad

    hh, ww = max(h, 24), max(w, 24)
    *frames, gf, _, occ = make_quad(hh, ww, seed)
    ims = prepare_quad(*frames, device=device)
    return (tuple(im[:h, :w].contiguous() for im in ims), gf[:h, :w],
            occ[:h, :w])


def occ_patch_inputs(b: int, p: int, seed: int, device, chi: str = "random",
                     h: int = 60, w: int = 80):
    """Inputs of K9's patch form (``core.occlusion.occ_patch_loop``) as the
    method-8 solver forms them, on a ``make_quad`` frame of h x w: B boxes of
    side p at random centres (the four corners first, so that boxes are
    clipped at the image edge), u the known flow plus 0.5 px of noise inside
    the box, chi random (30% ones), all 0 ("zeros") or all 1 ("ones") inside
    the box, the warp constants from K4's patch form at u and at -u, the g
    crops and the local scalars of the default parameters.  Returns (st, wc,
    g, ph, pw, scal) on ``device``."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.occlusion import local_scalars, warp_constants
    from faldoi_tpu_torch.models import method_local_params
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    import torch

    (i0n, i1n, i_1n, _), gf, _ = _occ_frames(h, w, seed, device)
    prm = P.Parameters()
    sc = make_solver_consts(i0n, i1n, *method_local_params(8, p // 2),
                            prm.tol_OF, p, 8, i_1=i_1n,
                            occ_prm=(prm.alpha, prm.beta, prm.mu, prm.tau_u,
                                     prm.tau_eta, prm.tau_chi))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, h * w, b)
    idx[:4] = [0, w - 1, h * w - 1, (h - 1) * w][:b]
    _, _, oy, ox, ph, pw = (t.to(torch.int32).to(device).contiguous() for t in
                            patch_geometry(torch.as_tensor(idx), h, w, p // 2))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = ((rows < ph.cpu().numpy()[:, None, None])
             & (cols < pw.cpu().numpy()[:, None, None]))
    gy = np.clip(oy.cpu().numpy()[:, None, None] + rows, 0, h - 1)
    gx = np.clip(ox.cpu().numpy()[:, None, None] + cols, 0, w - 1)
    u = gf[gy, gx] + rng.normal(0, 0.5, (b, p, p, 2))
    c = {"random": rng.random((b, p, p)) < 0.3, "zeros": np.zeros((b, p, p)),
         "ones": np.ones((b, p, p))}[chi]

    def canvas(x):
        return torch.as_tensor(np.where(inbox, x, 0).astype(np.float32),
                               device=device)

    u1, u2, chi_t = canvas(u[..., 0]), canvas(u[..., 1]), canvas(c)
    i0p, gp = (gather_patches(pl[:, :, None], oy, ox, p)[:, :, 0, :]
               .permute(2, 0, 1).contiguous() for pl in (sc.i0pad, sc.gpad))
    box = (oy, ox, ph, pw)
    wc = warp_constants(i0p, bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 3),
                        bicubic_sample_patches(sc.i_1_stack, *box, -u1, -u2, 3),
                        u1, u2)
    z = torch.zeros_like(u1)
    st = torch.stack([u1, u2, chi_t, z, z, z, z, z, z, u1, u2]).contiguous()
    return st, wc, gp, ph, pw, local_scalars(sc.lambda_, sc.theta, sc.occ_prm,
                                             sc.tol)


def occ_global_inputs(h: int, w: int, seed: int, device, occ_init: bool):
    """Inputs of K9's whole-image form (``core.occlusion.occ_global_loop``)
    on a ``make_quad`` frame of h x w: u the known flow plus 0.3 px of
    noise, chi the known occlusions and 10% of the pixels at random
    (``occ_init``) or 0, the first warp's
    constants from K4's flow form, g, and the global scalars of the default
    parameters.  Returns (st, wc, g, scal) on ``device``."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.occlusion import (
        global_scalars, init_weight, warp_constants,
    )
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_planes
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    import torch

    (i0n, i1n, i_1n, _), gf, occ = _occ_frames(h, w, seed, device)
    rng = np.random.default_rng(seed)
    u = (gf + rng.normal(0, 0.3, gf.shape)).astype(np.float32)
    u1, u2 = (torch.as_tensor(np.ascontiguousarray(u[..., k]), device=device)
              for k in (0, 1))
    c = np.maximum(occ, rng.random((h, w)) < 0.1) if occ_init else 0 * occ
    chi = torch.as_tensor(c.astype(np.float32), device=device)
    stacks = [torch.stack([f, *centered_gradient(f)]).contiguous()
              for f in (i1n, i_1n)]
    wc = warp_constants(i0n, bicubic_warp_planes(stacks[0], u1, u2, False),
                        bicubic_warp_planes(stacks[1], -u1, -u2, False), u1, u2)
    z = torch.zeros_like(u1)
    st = torch.stack([u1, u2, chi, z, z, z, z, z, z, u1, u2]).contiguous()
    g = init_weight(*centered_gradient(i0n)).contiguous()
    return st, wc, g, global_scalars(P.init_params(None, P.GLOBAL_STEP), device)

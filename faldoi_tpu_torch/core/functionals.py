"""Batched canvas patch solvers for methods 0 (TV-L1) and 1 (weighted TV-L1).

Port of ``faldoi_tpu/core/functionals.py::_solve_tvl1_family`` (reference
``tvl2_model.cpp:174-435``, ``tvl2w_model.cpp``), run on B patches at once.
Every patch
lives on a fixed (P, P) canvas with a valid box [0, ph) x [0, pw) whose
origin in the image is (oy, ox):

* the source-frame crop goes through K0 (``ops.patch_gather``);
* the warps of (I1, I1x, I1y) and the final I1 warp go through K4
  (``ops.bicubic``) at the cells' displaced points, ``border_out=False``;
* the tol-gated PD loop is the static masked unroll of JAX's
  ``_bounded_pd_loop``: ``max_iters`` steps, and a lane freezes once its
  ``err <= tol^2``;
* the energy is ``eval_tvl2coupled``'s patch mean of data + coupling + TV.

Method 1 weights the data term by a Gaussian window centred on the patch's
centre pixel: ``l_t`` becomes ``l_t * W`` per cell in the threshold, and the
eval's data term is multiplied by ``W`` (tvl2w_model.cpp:227, 374+).

The patch PD arithmetic is plain PyTorch in this slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.pd_common import (
    sqrt_rn, tvl1_threshold, tvl2_getD, tvl2_getP,
)
from faldoi_tpu_torch.ops.bicubic import bicubic_sample
from faldoi_tpu_torch.ops.gaussian import gaussian1d_weight
from faldoi_tpu_torch.ops.patch_gather import gather_patches
from faldoi_tpu_torch.ops.stencils import (
    canvas_ids, centered_gradient, divergence_patch, forward_gradient_patch,
)


class SolverConsts(NamedTuple):
    """Per-growing constants of the patch solvers."""

    i0pad: torch.Tensor      # (h+P, w+P) source frame, edge-padded bottom/right
    i1: torch.Tensor         # (h, w) target frame
    i1x: torch.Tensor
    i1y: torch.Tensor
    lambda_: torch.Tensor    # float32 scalars
    theta: torch.Tensor
    tau: torch.Tensor
    tol: torch.Tensor
    w1d: Optional[torch.Tensor] = None   # (2wr+1,) window of method 1


def pad_for_crops(img: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-pad an (h, w, ...) array bottom/right by p
    (``patch_solver.pad_for_crops``)."""
    h, w = img.shape[:2]
    rows = torch.arange(h + p, device=img.device).clamp(max=h - 1)
    cols = torch.arange(w + p, device=img.device).clamp(max=w - 1)
    return img.index_select(0, rows).index_select(1, cols).contiguous()


def _scalar(x, dev):
    return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def make_solver_consts(i0: torch.Tensor, i1: torch.Tensor, lam, theta, tau,
                       tol, p: int, method: int = P.M_TVL1) -> SolverConsts:
    """SolverConsts of one growing direction (source i0, target i1); method 1
    adds the window ``gaussian1d_weight(p // 2)``."""
    solver_for(method)
    i1x, i1y = centered_gradient(i1)
    dev = i0.device
    w1d = (torch.as_tensor(gaussian1d_weight(p // 2), device=dev)
           if method == P.M_TVL1_W else None)
    return SolverConsts(pad_for_crops(i0, p), i1, i1x, i1y, _scalar(lam, dev),
                        _scalar(theta, dev), _scalar(tau, dev), _scalar(tol, dev),
                        w1d)


def solver_consts_from_numpy(sc, device) -> SolverConsts:
    """Carry a JAX ``SolverConsts`` (fields as arrays) into the port."""
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    return SolverConsts(t(sc.i0pad).contiguous(), t(sc.i1), t(sc.i1x),
                        t(sc.i1y), t(sc.lambda_), t(sc.theta), t(sc.tau),
                        t(sc.tol), None if sc.w1d is None else t(sc.w1d))


def canvas_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (B, P, P) canvases in a fixed order (columns, then rows), so the
    patch energy rounds the same on every device."""
    s = x[:, :, 0]
    for c in range(1, x.shape[2]):
        s = s + x[:, :, c]
    t = s[:, 0]
    for r in range(1, x.shape[1]):
        t = t + s[:, r]
    return t


def _warp(sc: SolverConsts, planes, gx, gy, u1, u2, inbox):
    """Sample ``planes`` (C, h, w) at the patch cells' displaced points."""
    zero = torch.zeros((), dtype=u1.dtype, device=u1.device)
    uu = (gx + torch.where(inbox, u1, zero)).contiguous()
    vv = (gy + torch.where(inbox, u2, zero)).contiguous()
    return bicubic_sample(planes, uu, vv, False)


def _weight2d(w1d, rows, cols, oy, ox, cj, ci, wr):
    """Gaussian-window weight of every canvas cell (tvl2w_model.cpp:227):
    W = w1d[row - cj + wr] * w1d[col - ci + wr] in global coordinates, the
    indices clipped to [0, 2wr] (so clamped boxes at the image edge keep the
    window centred on the patch's centre pixel).  (B,) -> (B, P, P)."""
    ridx = (oy[:, None, None] + rows - cj[:, None, None] + wr).clamp(0, 2 * wr)
    cidx = (ox[:, None, None] + cols - ci[:, None, None] + wr).clamp(0, 2 * wr)
    return w1d[ridx] * w1d[cidx]


def _solve_tvl1_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2,
                       p: int, warps: int, max_iters: int, weighted: bool):
    """Solve B TV-L1 patches, weighted (method 1) or not (method 0).

    ci, cj, oy, ox, ph, pw: (B,) int tensors (centre, canvas origin, valid
    box); u1, u2: (B, P, P) init canvases (zero outside the box).  Returns
    (u1, u2, ener): the solved canvases (zero outside the box) and the (B,)
    patch energies.  The window radius is p // 2, as JAX passes it: the seed
    insertion's 3x3 solves of method 1 therefore read w1d[0..2], the tail
    of the 11-tap window (``seed_batch`` passes wr=1)."""
    dev = u1.device
    rows, cols = canvas_ids(p, dev)
    ph3, pw3 = ph[:, None, None], pw[:, None, None]
    inbox = (rows < ph3) & (cols < pw3)
    gx = (ox[:, None, None] + cols).to(u1.dtype)
    gy = (oy[:, None, None] + rows).to(u1.dtype)
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    i0_patch = gather_patches(sc.i0pad[:, :, None], oy32, ox32, p)[:, :, 0, :]
    i0_patch = i0_patch.permute(2, 0, 1)                        # (B, P, P)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)
        l_t = l_t * w2d
    tol2 = sc.tol * sc.tol
    i1_stack = torch.stack([sc.i1, sc.i1x, sc.i1y]).contiguous()

    xi = tuple(torch.zeros_like(u1) for _ in range(4))
    v1, v2 = u1, u2
    for _ in range(warps):
        i1w, i1wx, i1wy = _warp(sc, i1_stack, gx, gy, u1, u2, inbox)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0_patch
        st = (u1, u2, u1, u2, *xi, v1, v2,
              torch.full(u1.shape[:1], float("inf"), dtype=u1.dtype, device=dev),
              torch.zeros(u1.shape[:1], dtype=torch.int32, device=dev))
        for _ in range(max_iters):
            c1, c2, c1_, c2_, x11, x12, x21, x22, _, _, err, n = st
            nv1, nv2 = tvl1_threshold(c1, c2, rho_c, i1wx, i1wy, grad, l_t)
            u1x, u1y = forward_gradient_patch(c1_, ph, pw)
            u2x, u2y = forward_gradient_patch(c2_, ph, pw)
            x11, x12, x21, x22 = tvl2_getD(x11, x12, x21, x22,
                                           u1x, u1y, u2x, u2y, sc.tau)
            d1 = divergence_patch(x11, x12, ph, pw)
            d2 = divergence_patch(x21, x22, ph, pw)
            nu1, nu2, u_n = tvl2_getP(c1, c2, nv1, nv2, d1, d2, sc.theta, sc.tau)
            nerr = torch.where(inbox, u_n, zero).amax(dim=(1, 2))
            new = (nu1, nu2, 2 * nu1 - c1, 2 * nu2 - c2, x11, x12, x21, x22,
                   nv1, nv2, nerr, n + 1)
            run = (err > tol2) & (n < max_iters)
            st = tuple(torch.where(run.view((-1,) + (1,) * (a.dim() - 1)), b, a)
                       for a, b in zip(st, new))
        u1, u2 = st[0], st[1]
        xi = st[4:8]
        v1, v2 = st[8], st[9]

    # eval (tvl2_model.cpp:174-243)
    u1 = torch.where(inbox, u1, zero)
    u2 = torch.where(inbox, u2, zero)
    v1 = torch.where(inbox, v1, zero)
    v2 = torch.where(inbox, v2, zero)
    u1x, u1y = forward_gradient_patch(u1, ph, pw)
    u2x, u2y = forward_gradient_patch(u2, ph, pw)
    i1w = _warp(sc, sc.i1[None], gx, gy, u1, u2, inbox)[0]
    dt = sc.lambda_ * torch.abs(i1w - i0_patch)
    if weighted:
        dt = dt * w2d
    e1 = u1 - v1
    e2 = u2 - v2
    dc = (1.0 / (2.0 * sc.theta)) * (e1 * e1 + e2 * e2)
    g = sqrt_rn(u1x * u1x + u1y * u1y + u2x * u2x + u2y * u2y)
    ener = canvas_sum(torch.where(inbox, dc + dt + g, zero)) / (ph * pw).to(u1.dtype)
    return u1, u2, ener


def solve_tvl1(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
               warps: int, max_iters: int):
    """Solve B method-0 (TV-L1) patches; see ``_solve_tvl1_family``."""
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=False)


def solve_tvl1_w(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                 warps: int, max_iters: int):
    """Solve B method-1 (Gaussian-weighted TV-L1) patches; ``sc.w1d`` must
    hold the window."""
    if sc.w1d is None:
        raise ValueError("solve_tvl1_w needs SolverConsts.w1d (method 1 consts)")
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=True)


# method -> patch solver (JAX's ``functionals.SOLVERS``, the ported part)
SOLVERS = {P.M_TVL1: solve_tvl1, P.M_TVL1_W: solve_tvl1_w}


def solver_for(method: int):
    """The patch solver of ``method``; methods not ported yet raise."""
    if method not in SOLVERS:
        raise NotImplementedError(f"method {method} not ported yet")
    return SOLVERS[method]

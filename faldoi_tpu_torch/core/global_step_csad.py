"""Global (whole-image) TV-CSAD and NLTV-CSAD refinement, with kernel K8 for
the v-step.

Port of ``faldoi_tpu/core/global_step_csad.py`` (``tvcsad_PD``,
global_faldoi.cpp:1449-1637; ``nltvcsad_PD``, :1642-1808).  Each of
``warps`` warps samples (I1, I1x, I1y) at (x + u) with K4's flow form,
``border_out=True``, builds the 48 CSAD breakpoint planes once, and runs the
PD loop, whose v-step is K8 (``ops.csad.csad_vstep``, the median of the 2n +
1 breakpoints at the reference's index n + 1).  The duals are zeroed once and
carried across warps; u_bar restarts from u at each warp.

* ``tvcsad_global`` (methods 4 and 5): ``grad = hypot(|grad I1w|^2, 0.01)``
  (:1519), TV duals projected per flow component (``tvcsad_getD``,
  :1428-1446), and a tolerance exit on the mean squared update, read on the
  host after every iteration (one sync an iteration).
* ``nltvcsad_global`` (methods 6 and 7): ``grad = |grad I1w|^2``, the
  breakpoints normalised by ``sqrt(grad)`` where ``grad > GRAD_IS_ZERO``
  (and v = u elsewhere, :1735-1737), the 24 non-local duals of the NLTV
  global step (plain PyTorch here), and a fixed ``max_iters`` iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.core.global_step_nltv import OFFS as NL_OFFS, global_weights
from faldoi_tpu_torch.core.pd_common import hypot, sqrt_rn
from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
from faldoi_tpu_torch.ops.csad import csad_b, csad_vstep, image_masks
from faldoi_tpu_torch.ops.nonlocal_ops import (
    nonlocal_divergence, nonlocal_gradient_duals,
)
from faldoi_tpu_torch.ops.stencils import (
    centered_gradient, divergence, forward_gradient,
)
from faldoi_tpu_torch.params import GRAD_IS_ZERO, MAX_ITERATIONS_GLOBAL


def _f32(x) -> float:
    return float(np.float32(x))


def _warp(i1_stack, u1, u2):
    i1w, i1wx, i1wy = bicubic_warp_stack(i1_stack, u1, u2, True)
    return i1w, i1wx.contiguous(), i1wy.contiguous()


def tvcsad_global(i0n: torch.Tensor, i1n: torch.Tensor, u1: torch.Tensor,
                  u2: torch.Tensor, lambda_: float, theta: float, tau: float,
                  tol: float, warps: int, max_iters: int = MAX_ITERATIONS_GLOBAL,
                  stats=None):
    """TV-CSAD global refinement.  i0n, i1n: normalized+smoothed gray frames
    (h, w); u1, u2: the initial flow.  Returns the refined (u1, u2).  Each
    warp's PD loop stops once the mean squared update is at most ``tol^2``
    (float32) or after ``max_iters`` iterations.

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``)."""
    dev = i0n.device
    h, w = i0n.shape
    l_t = _f32(np.float32(lambda_) * np.float32(theta))
    theta_t = torch.tensor(_f32(theta), device=dev)
    tau = _f32(tau)
    tol2 = _f32(np.float32(tol) * np.float32(tol))
    masks, ncount = image_masks(h, w, dev)
    i1x, i1y = centered_gradient(i1n)
    i1_stack = torch.stack([i1n, i1x, i1y]).contiguous()
    u1, u2 = u1.contiguous(), u2.contiguous()
    xi11, xi12, xi21, xi22 = (torch.zeros_like(u1) for _ in range(4))
    iters = []
    for _ in range(warps):
        i1w, i1wx, i1wy = _warp(i1_stack, u1, u2)
        grad = hypot(i1wx * i1wx + i1wy * i1wy, 0.01)   # :1519
        b = csad_b(i0n, i1w, i1wx, i1wy, u1, u2, grad, masks)
        u1_, u2_ = u1, u2
        err, n = float("inf"), 0
        while err > tol2 and n < max_iters:
            v1, v2 = csad_vstep(u1, u2, b, i1wx, i1wy, grad, l_t, masks, ncount)
            u1x, u1y = forward_gradient(u1_)
            u2x, u2y = forward_gradient(u2_)
            # tvcsad_getD (:1428-1446): per-component projection
            n1 = torch.clamp(hypot(xi11, xi12), min=1.0)
            n2 = torch.clamp(hypot(xi21, xi22), min=1.0)
            xi11, xi12 = (xi11 + tau * u1x) / n1, (xi12 + tau * u1y) / n1
            xi21, xi22 = (xi21 + tau * u2x) / n2, (xi22 + tau * u2y) / n2
            nu1 = u1 - tau * (-divergence(xi11, xi12) + (u1 - v1) / theta_t)
            nu2 = u2 - tau * (-divergence(xi21, xi22) + (u2 - v2) / theta_t)
            d1, d2 = nu1 - u1, nu2 - u2
            # the mean squared update, summed in float64 so that the card and
            # the CPU stop at the same iteration
            err = _f32((d1 * d1 + d2 * d2).double().sum().item() / (h * w))
            u1_, u2_ = 2.0 * nu1 - u1, 2.0 * nu2 - u2
            u1, u2 = nu1, nu2
            n += 1
        iters.append(n)
    if stats is not None:
        stats["global_iters"] = iters
    return u1, u2


def nltvcsad_global(i0n: torch.Tensor, i1n: torch.Tensor, i0_planes: np.ndarray,
                    u1: torch.Tensor, u2: torch.Tensor, lambda_: float,
                    theta: float, tau: float, warps: int,
                    max_iters: int = MAX_ITERATIONS_GLOBAL, stats=None):
    """NLTV-CSAD global refinement.  i0n, i1n: normalized+smoothed gray
    frames (h, w); i0_planes: I0's original (pd, h, w) colour planes for the
    Lab weights (global scales ws 2 / wi 5); u1, u2: the initial flow.
    Returns the refined (u1, u2) after ``max_iters`` iterations a warp.

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``: ``max_iters`` each)."""
    dev = i0n.device
    h, w = i0n.shape
    l_t = _f32(np.float32(lambda_) * np.float32(theta))
    theta_t = torch.tensor(_f32(theta), device=dev)
    tau = _f32(tau)
    masks, ncount = image_masks(h, w, dev)
    wp, wt = global_weights(i0_planes, dev)
    i1x, i1y = centered_gradient(i1n)
    i1_stack = torch.stack([i1n, i1x, i1y]).contiguous()
    u1, u2 = u1.contiguous(), u2.contiguous()
    sc_p = torch.zeros((len(NL_OFFS), h, w), dtype=u1.dtype, device=dev)
    sc_q = torch.zeros_like(sc_p)
    one = torch.ones((), dtype=u1.dtype, device=dev)
    for _ in range(warps):
        i1w, i1wx, i1wy = _warp(i1_stack, u1, u2)
        grad = i1wx * i1wx + i1wy * i1wy
        gok = grad > GRAD_IS_ZERO
        sq = sqrt_rn(torch.where(gok, grad, one))
        b = csad_b(i0n, i1w, i1wx, i1wy, u1, u2, sq, masks)
        u1_, u2_ = u1, u2
        for _ in range(max_iters):
            v1, v2 = csad_vstep(u1, u2, b, i1wx, i1wy, sq, l_t, masks, ncount)
            v1 = torch.where(gok, v1, u1)   # :1735-1737
            v2 = torch.where(gok, v2, u2)
            sc_p = nonlocal_gradient_duals(sc_p, u1_, wp, wt, NL_OFFS, tau)
            sc_q = nonlocal_gradient_duals(sc_q, u2_, wp, wt, NL_OFFS, tau)
            nu1 = u1 - tau * (nonlocal_divergence(sc_p, wp, wt, NL_OFFS)
                              + (u1 - v1) / theta_t)
            nu2 = u2 - tau * (nonlocal_divergence(sc_q, wp, wt, NL_OFFS)
                              + (u2 - v2) / theta_t)
            u1_, u2_ = 2.0 * nu1 - u1, 2.0 * nu2 - u2
            u1, u2 = nu1, nu2
    if stats is not None:
        stats["global_iters"] = [max_iters] * warps
    return u1, u2

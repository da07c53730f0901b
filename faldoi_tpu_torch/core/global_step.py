"""Global (whole-image) TV-L1 refinement, with kernel K5 for the PD loop.

Port of ``faldoi_tpu/core/global_step.py::tvl2_global`` (``tvl2OF``,
global_faldoi.cpp:556-882):

* each of ``warps`` warps samples (I1, I1x, I1y) at (x + u) with K4,
  ``border_out=True`` (out-of-domain pixels get 0);
* the duals are zeroed once and carried across warps;
* the PD loop starts with ``err = inf`` (so it runs at least once) and stops
  at ``err <= tol^2`` or after ``max_iters`` (400) iterations.

The PD loop of one warp (global_step.py:74-93) is kernel K5
(``csrc/global_pd.cu``), one cooperative launch: per iteration threshold,
forward gradients of u_bar, ``getD``, divergence of the NEW xi, ``getP``,
over-relaxation and ``err = max(u_n)``, with a grid barrier after the dual
and after the primal phase; every block tests ``err > tol^2`` on the card,
as JAX's ``lax.while_loop`` does, and the host reads only the iteration
count, once per warp.  A launch reads 12 planes and writes 8 (35.7 MB at
436x1024) and does ~65 float operations a pixel an iteration, so a warp
at the 400-iteration cap is bound by operations; the barriers set its pace.
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.params import MAX_ITERATIONS_GLOBAL
from faldoi_tpu_torch.core.pd_common import (
    tvl1_threshold, tvl2_getD, tvl2_getP, warp_constants,
)
from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
from faldoi_tpu_torch.ops.stencils import (
    centered_gradient, divergence, forward_gradient,
)


def global_pd_iteration_plain(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22,
                              i1wx, i1wy, grad, rho_c, err, l_t, theta, tau):
    """One PD iteration of K5's plain twin, updating the state in place and
    writing max(u_n) into the one-element ``err``.  theta divides as a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which rounds differently from the kernel's (and the CPU's) division."""
    theta = torch.tensor(theta, dtype=u1.dtype, device=u1.device)
    v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
    u1x, u1y = forward_gradient(u1_)
    u2x, u2y = forward_gradient(u2_)
    n11, n12, n21, n22 = tvl2_getD(xi11, xi12, xi21, xi22,
                                   u1x, u1y, u2x, u2y, tau)
    div1 = divergence(n11, n12)
    div2 = divergence(n21, n22)
    nu1, nu2, u_n = tvl2_getP(u1, u2, v1, v2, div1, div2, theta, tau)
    err.copy_(u_n.max().reshape(1))
    for dst, src in ((xi11, n11), (xi12, n12), (xi21, n21), (xi22, n22),
                     (u1_, 2.0 * nu1 - u1), (u2_, 2.0 * nu2 - u2),
                     (u1, nu1), (u2, nu2)):
        dst.copy_(src)
    return err


def global_pd_loop_plain(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22,
                         i1wx, i1wy, grad, rho_c, l_t, theta, tau, tol2,
                         max_iters: int) -> int:
    """Plain twin of K5: the PD loop of one warp on the host, reading err
    after every iteration.  Returns the iteration count."""
    err = torch.empty(1, dtype=torch.float32, device=u1.device)
    e, n = float("inf"), 0
    while e > tol2 and n < max_iters:
        global_pd_iteration_plain(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22,
                                  i1wx, i1wy, grad, rho_c, err, l_t, theta, tau)
        e = float(err.item())
        n += 1
    return n


def global_pd_loop(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, i1wx, i1wy,
                   grad, rho_c, l_t, theta, tau, tol2, max_iters: int) -> int:
    """K5: the TV-L1 PD loop of one warp of ``tvl2_global`` on (h, w) float32
    planes, in place: iterate while ``max(u_n) > tol2`` (float32) and fewer
    than ``max_iters`` iterations ran.  Returns the iteration count.

    CPU tensors go to the plain twin; CUDA tensors make one cooperative
    launch that loops on the card, and the host reads only the count (or
    the wrapper raises)."""
    planes = (u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, i1wx, i1wy, grad, rho_c)
    if u1.device.type == "cpu":
        return global_pd_loop_plain(*planes, l_t, theta, tau, tol2, max_iters)
    if u1.dim() != 2 or u1.numel() == 0:
        raise ValueError(f"u1 must be a non-empty (h, w) plane, got "
                         f"{tuple(u1.shape)}")
    h, w = u1.shape
    names = ("u1", "u2", "u1_", "u2_", "xi11", "xi12", "xi21", "xi22",
             "i1wx", "i1wy", "grad", "rho_c")
    for name, t in zip(names, planes):
        kb.require_cuda_tensor(t, name, torch.float32, u1.device, (h, w))
    scratch = torch.empty(4, dtype=torch.int32, device=u1.device)
    code = kb.library().faldoi_global_pd_loop(
        *(t.data_ptr() for t in planes), scratch.data_ptr(), h, w,
        float(l_t), float(theta), float(tau), float(tol2), int(max_iters),
        kb.stream_ptr(u1.device))
    kb.check(code, "global_pd_loop")
    global_pd_loop.launches += 1
    return int(scratch[3].item())


global_pd_loop.launches = 0   # K5 launches, raised only after a launch


def tvl2_global(i0: torch.Tensor, i1: torch.Tensor, u1: torch.Tensor,
                u2: torch.Tensor, lambda_: float = 40.0, theta: float = 0.3,
                tau: float = 0.125, tol: float = 0.01, warps: int = 5,
                max_iters: int = MAX_ITERATIONS_GLOBAL, stats=None):
    """TV-L2-coupled global refinement.  i0, i1: normalized+smoothed gray
    frames (h, w); u1, u2: the initial flow.  Returns the refined (u1, u2).

    ``stats`` (a dict, optional) receives the PD iteration count per warp."""
    f32 = np.float32
    l_t = float(f32(lambda_) * f32(theta))
    tol2 = float(f32(tol) * f32(tol))
    theta, tau = float(f32(theta)), float(f32(tau))
    i1x, i1y = centered_gradient(i1)
    i1_stack = torch.stack([i1, i1x, i1y]).contiguous()
    u1 = u1.clone().contiguous()
    u2 = u2.clone().contiguous()
    xi = [torch.zeros_like(u1) for _ in range(4)]
    iters = []
    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_warp_stack(i1_stack, u1, u2, True)
        grad, rho_c = warp_constants(i0, i1w, i1wx, i1wy, u1, u2)
        i1wx, i1wy = i1wx.contiguous(), i1wy.contiguous()
        u1_, u2_ = u1.clone(), u2.clone()
        iters.append(global_pd_loop(u1, u2, u1_, u2_, *xi, i1wx, i1wy, grad,
                                    rho_c, l_t, theta, tau, tol2, max_iters))
    if stats is not None:
        stats["global_iters"] = iters
    return u1, u2

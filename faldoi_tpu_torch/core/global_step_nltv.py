"""Global (whole-image) NLTV-L1 refinement, with kernel K6 for the PD loop.

Port of ``faldoi_tpu/core/global_step_nltv.py::nltvl1_global``
(``nltvl1_PD``, global_faldoi.cpp:1177-1328): the warping and threshold
skeleton of TV-L1, with the regulariser's duals on the 24 non-local
neighbours weighted by Lab similarity (global scales ws 2 / wi 5 and the
whole-image ``wt``):

* the weights come from the raw colour planes of I0 (0..255), on the host;
* each of ``warps`` warps samples (I1, I1x, I1y) at (x + u) with K4's flow
  form, ``border_out=True``, then ``warp_constants``;
* the duals are zeroed once and carried across warps; u_bar restarts from
  u at each warp;
* the PD loop runs a fixed ``max_iters`` (400) times: the reference disabled
  its tolerance exit (global_faldoi.cpp:1248-1249).

The PD loop of one warp (the ``fori_loop`` of global_step_nltv.py:48-63) is
kernel K6 (``csrc/nltv.cu``): one call a warp, which enqueues two plain
launches an iteration (the dual phase, then the primal phase), reading the
12 weight planes that the symmetric weights need.
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.core.pd_common import tvl1_threshold, warp_constants
from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
from faldoi_tpu_torch.ops.nonlocal_ops import (
    neighbor_offsets, nltv_weights, nonlocal_divergence,
    nonlocal_gradient_duals, rgb_to_lab_np,
)
from faldoi_tpu_torch.ops.stencils import centered_gradient
from faldoi_tpu_torch.params import MAX_ITERATIONS_GLOBAL, NL_BETA

GLOBAL_WS = 2.0   # MAX_BETA (global_faldoi.cpp:887), the spatial scale
GLOBAL_WI = 5.0   # MAX_INTENSITY (global_faldoi.cpp:886)
OFFS = tuple(neighbor_offsets(NL_BETA))
N_D = len(OFFS)   # 24 duals a component


def nltv_global_loop_plain(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt, i1wx, i1wy,
                           grad, rho_c, l_t, theta, tau, max_iters: int):
    """Plain twin of K6: ``max_iters`` NLTV PD iterations of one warp on the
    host's dispatch, updating the state in place (u, u_bar (h, w); the duals
    (24, h, w)).  theta divides as a tensor (see ``global_pd_iteration_plain``)."""
    theta = torch.tensor(theta, dtype=u1.dtype, device=u1.device)
    for _ in range(max_iters):
        v1, v2 = tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
        sc_p.copy_(nonlocal_gradient_duals(sc_p, u1_, wp, wt, OFFS, tau))
        sc_q.copy_(nonlocal_gradient_duals(sc_q, u2_, wp, wt, OFFS, tau))
        div_p = nonlocal_divergence(sc_p, wp, wt, OFFS)
        div_q = nonlocal_divergence(sc_q, wp, wt, OFFS)
        # ofnltv_getP (global_faldoi.cpp:1090-1120): note the +div sign
        nu1 = u1 - tau * (div_p + (u1 - v1) / theta)
        nu2 = u2 - tau * (div_q + (u2 - v2) / theta)
        u1_.copy_(2.0 * nu1 - u1)
        u2_.copy_(2.0 * nu2 - u2)
        u1.copy_(nu1)
        u2.copy_(nu2)


def nltv_global_loop(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt, i1wx, i1wy, grad,
                     rho_c, l_t, theta, tau, max_iters: int) -> None:
    """K6: the NLTV PD loop of one warp of ``nltvl1_global``, in place, a
    fixed ``max_iters`` iterations.  u1, u2, u1_, u2_, wt and the warp
    constants are (h, w) float32 planes; sc_p, sc_q and wp are (24, h, w).

    Precondition: wp is symmetric, ``w_j(x) == w_{23-j}(x + d_j)`` bit for
    bit, as ``global_weights`` (``nltv_weights``) makes it.  The kernel
    reads planes 0-11 and takes w_j, j >= 12, from plane 23 - j at x + d_j,
    and assumes the symmetry without checking it: on the card, weights that
    break it give a different answer silently.  Only the card checks, which
    hold the kernel to the twin (which reads all 24 planes), detect that.

    CPU tensors go to the plain twin; CUDA tensors enqueue the whole loop
    on the card, two kernel launches an iteration, with no host sync (or
    the wrapper raises).  ``launches`` counts calls."""
    if u1.dim() != 2 or u1.numel() == 0:
        raise ValueError(f"u1 must be a non-empty (h, w) plane, got "
                         f"{tuple(u1.shape)}")
    h, w = u1.shape
    planes = (u1, u2, u1_, u2_, wt, i1wx, i1wy, grad, rho_c)
    stacks = (sc_p, sc_q, wp)
    if u1.device.type == "cpu":
        return nltv_global_loop_plain(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt,
                                      i1wx, i1wy, grad, rho_c, l_t, theta,
                                      tau, max_iters)
    names = ("u1", "u2", "u1_", "u2_", "wt", "i1wx", "i1wy", "grad", "rho_c")
    for name, t in zip(names, planes):
        kb.require_cuda_tensor(t, name, torch.float32, u1.device, (h, w))
    for name, t in zip(("sc_p", "sc_q", "wp"), stacks):
        kb.require_cuda_tensor(t, name, torch.float32, u1.device, (N_D, h, w))
    if max_iters <= 0:
        return None
    code = kb.library().faldoi_nltv_global_loop(
        *(t.data_ptr() for t in planes + stacks), h, w, float(l_t),
        float(theta), float(tau), int(max_iters), kb.stream_ptr(u1.device))
    kb.check(code, "nltv_global_loop")
    nltv_global_loop.launches += 1
    return None


nltv_global_loop.launches = 0   # K6 calls (a warp each), raised after a launch


def global_weights(i0_planes: np.ndarray, device):
    """The global step's support weights (24, h, w) and their sum (h, w)
    from the raw (pd, h, w) colour planes of I0, on ``device``."""
    wp, wt, _ = nltv_weights(rgb_to_lab_np(np.asarray(i0_planes)), NL_BETA,
                             GLOBAL_WS, GLOBAL_WI)
    return (torch.as_tensor(wp, device=device).contiguous(),
            torch.as_tensor(wt, device=device).contiguous())


def nltvl1_global(i0n: torch.Tensor, i1n: torch.Tensor, i0_planes: np.ndarray,
                  u1: torch.Tensor, u2: torch.Tensor, lambda_: float,
                  theta: float, tau: float, warps: int,
                  max_iters: int = MAX_ITERATIONS_GLOBAL, stats=None):
    """NLTV-L1 global refinement.  i0n, i1n: normalized+smoothed gray frames
    (h, w); i0_planes: I0's original (pd, h, w) colour planes for the Lab
    weights; u1, u2: the initial flow.  Returns the refined (u1, u2).

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``: ``max_iters`` each, as there is no tolerance exit)."""
    f32 = np.float32
    l_t = float(f32(lambda_) * f32(theta))
    theta, tau = float(f32(theta)), float(f32(tau))
    dev = i0n.device
    wp, wt = global_weights(i0_planes, dev)
    i1x, i1y = centered_gradient(i1n)
    i1_stack = torch.stack([i1n, i1x, i1y]).contiguous()
    u1 = u1.clone().contiguous()
    u2 = u2.clone().contiguous()
    sc_p = torch.zeros((N_D,) + tuple(u1.shape), dtype=u1.dtype, device=dev)
    sc_q = torch.zeros_like(sc_p)
    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_warp_stack(i1_stack, u1, u2, True)
        grad, rho_c = warp_constants(i0n, i1w, i1wx, i1wy, u1, u2)
        u1_, u2_ = u1.clone(), u2.clone()
        nltv_global_loop(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt, i1wx, i1wy,
                         grad, rho_c, l_t, theta, tau, max_iters)
    if stats is not None:
        stats["global_iters"] = [max_iters] * warps
    return u1, u2

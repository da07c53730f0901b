"""Global (whole-image) TV-CSAD and NLTV-CSAD refinement: kernels K14 and
K15, the PD loops with their own ranked v-step.

Port of ``faldoi_tpu/core/global_step_csad.py`` (``tvcsad_PD``,
global_faldoi.cpp:1449-1637; ``nltvcsad_PD``, :1642-1808).  Each of
``warps`` warps samples (I1, I1x, I1y) at (x + u) with K4's flow form,
``border_out=True``, builds the 48 CSAD breakpoint planes once, and runs the
PD loop, whose v-step is K8's selection (the median of the 2n + 1
breakpoints at the reference's index n + 1).  The duals are zeroed once and
carried across warps; u_bar restarts from u at each warp.

* ``tvcsad_global`` (methods 4 and 5): ``grad = hypot(|grad I1w|^2, 0.01)``
  (:1519), TV duals projected per flow component (``tvcsad_getD``,
  :1428-1446), and a tolerance exit on the mean squared update.  A warp's
  loop is kernel K14 (``tvcsad_global_loop``, ``csrc/csad_global.cu``): one
  call enqueues it, the tol exit is taken on the card, and the host reads
  the warps' PD iterations once, after the last warp.  The mean squared
  update is a float64 sum in a fixed order (``ordered_err``), so the card
  and the CPU stop at the same iteration.
* ``nltvcsad_global`` (methods 6 and 7): ``grad = |grad I1w|^2``, the
  breakpoints normalised by ``sqrt(grad)`` where ``grad > GRAD_IS_ZERO``
  (and v = u elsewhere, :1735-1737), the 24 non-local duals of the NLTV
  global step, and a fixed ``max_iters`` iterations.  A warp's loop is
  kernel K15 (``nltvcsad_global_loop``): one call enqueues it, K6's dual
  phase and a primal phase that selects v itself an iteration, with no
  host read.

Both loops rank each pixel's breakpoints once a warp and find the median
by a merge search every PD iteration (``csrc/csad_global.cu``), bit for bit
K8's selection (``csad_vstep_plain``, the twins' sort).
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.core.global_step_nltv import (
    N_D as NL_N_D, OFFS as NL_OFFS, global_weights,
)
from faldoi_tpu_torch.core.pd_common import hypot, sqrt_rn
from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
from faldoi_tpu_torch.ops.csad import N_D, csad_b, csad_vstep_plain, image_masks
from faldoi_tpu_torch.ops.nonlocal_ops import (
    nonlocal_divergence, nonlocal_gradient_duals, ordered_sum,
)
from faldoi_tpu_torch.ops.stencils import (
    centered_gradient, divergence, forward_gradient,
)
from faldoi_tpu_torch.params import GRAD_IS_ZERO, MAX_ITERATIONS_GLOBAL

# K14's primal launch sums the squared updates into a partial a run of 32
# pixels; its finish launch sums the partials with this many threads
ERR_BLOCK_CELLS = 32
ERR_FINISH_THREADS = 1024


def _f32(x) -> float:
    return float(np.float32(x))


def _warp(i1_stack, u1, u2):
    i1w, i1wx, i1wy = bicubic_warp_stack(i1_stack, u1, u2, True)
    return i1w, i1wx.contiguous(), i1wy.contiguous()


def _tree(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two) as a shuffle-down tree does: halve
    it, adding the upper half to the lower, until one element is left."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def ordered_err(e: torch.Tensor) -> torch.Tensor:
    """The float64 sum of the float32 squared updates ``e`` (h, w) in K14's
    order (``csrc/csad_global.cu``): the cells in raster order in blocks of
    32, each block's four runs of 8 by a tree and then in order; then the
    blocks' partials, partial i to thread i % 1024, each thread's in order,
    each warp's 32 threads by a tree, the 32 warps in order.  Returns a 0-d
    float64 tensor.  ``ordered_sum`` starts each run from 0, where the
    kernel starts from its first term: 0 + x is x for the squares, which are
    +0 or more (or NaN)."""
    x = e.reshape(-1).double()
    nb = -(-x.numel() // ERR_BLOCK_CELLS)
    x = torch.nn.functional.pad(x, (0, nb * ERR_BLOCK_CELLS - x.numel()))
    part = ordered_sum(_tree(x.view(nb, 4, 8)).t())
    m = -(-nb // ERR_FINISH_THREADS)
    part = torch.nn.functional.pad(part, (0, m * ERR_FINISH_THREADS - nb))
    per_thread = ordered_sum(part.view(m, ERR_FINISH_THREADS))
    return ordered_sum(_tree(per_thread.view(32, 32)))


def tvcsad_global_loop_plain(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, b,
                             i1wx, i1wy, grad, l_t, masks, ncount, theta, tau,
                             tol2, max_iters: int) -> torch.Tensor:
    """Plain twin of K14: one warp's TV-CSAD PD loop on the host's dispatch,
    updating u, u_bar and the duals in place; err, the mean squared update,
    is ``ordered_err`` over h w rounded to float32, read after every
    iteration.  Returns the iteration count as a (1,) int32 tensor.  theta
    and h w divide as tensors (see ``global_pd_iteration_plain``)."""
    dev = u1.device
    theta_t = torch.tensor(theta, dtype=u1.dtype, device=dev)
    hw = torch.tensor(float(u1.numel()), dtype=torch.float64, device=dev)
    err, n = float("inf"), 0
    while err > tol2 and n < max_iters:
        v1, v2 = csad_vstep_plain(u1, u2, b, i1wx, i1wy, grad, l_t, masks,
                                  ncount)
        u1x, u1y = forward_gradient(u1_)
        u2x, u2y = forward_gradient(u2_)
        # tvcsad_getD (:1428-1446): per-component projection
        n1 = torch.clamp(hypot(xi11, xi12), min=1.0)
        n2 = torch.clamp(hypot(xi21, xi22), min=1.0)
        xi11.copy_((xi11 + tau * u1x) / n1)
        xi12.copy_((xi12 + tau * u1y) / n1)
        xi21.copy_((xi21 + tau * u2x) / n2)
        xi22.copy_((xi22 + tau * u2y) / n2)
        nu1 = u1 - tau * (-divergence(xi11, xi12) + (u1 - v1) / theta_t)
        nu2 = u2 - tau * (-divergence(xi21, xi22) + (u2 - v2) / theta_t)
        d1, d2 = nu1 - u1, nu2 - u2
        err = float((ordered_err(d1 * d1 + d2 * d2) / hw).float())
        u1_.copy_(2.0 * nu1 - u1)
        u2_.copy_(2.0 * nu2 - u2)
        u1.copy_(nu1)
        u2.copy_(nu2)
        n += 1
    return torch.tensor([n], dtype=torch.int32, device=dev)


def ranked_scratch(h: int, w: int, dev):
    """The whole-image loops' scratch for a warp's ranked breakpoints: 48
    floats a pixel (each pixel's inside b in rank order) and a byte a pixel
    (``ok``: every inside b and l_t denom finite), written by the call's rank
    launch (``csrc/csad_global.cu``)."""
    return (torch.empty(h * w * N_D, dtype=torch.float32, device=dev),
            torch.empty(h * w, dtype=torch.uint8, device=dev))


def _check_plane_form(u1, name: str):
    """Refuse what the whole-image loops do not take: anything but an (h, w)
    plane, and on the card a side below 3 px (there ``image_masks``, as
    JAX's ``valid_mask``, wraps a negative slice end and counts neighbours
    past the far edge; K8 and the loops do not)."""
    if u1.dim() != 2:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)}: expected (h, w)")
    if u1.device.type != "cpu" and min(u1.shape) < 3:
        raise ValueError(f"{name}: u1 {tuple(u1.shape)}: the whole-image loop "
                         "takes 3 x 3 and up")


def tvcsad_global_loop(u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, b, i1wx,
                       i1wy, grad, l_t, masks, ncount, theta, tau, tol2,
                       max_iters: int) -> torch.Tensor:
    """K14: one warp's TV-CSAD PD loop of ``tvcsad_global`` on (h, w)
    float32 planes, in place (u, u_bar and the four duals): the v-step on
    the warp's breakpoints b (48, h, w) with i1wx, i1wy and grad, then the
    dual, primal and over-relaxation steps, while the mean squared update
    (``ordered_err`` / (h w), float32) is above ``tol2`` and fewer than
    ``max_iters`` iterations ran.  l_t, theta, tau, tol2: floats.  masks,
    ncount: ``image_masks`` (the twin reads them; the kernel derives them).
    Returns the iteration count, a (1,) int32 tensor on u1's device.

    CPU tensors go to the plain twin; CUDA tensors enqueue the whole loop on
    the card (an init launch, a launch that ranks each pixel's breakpoints
    once, then three launches an iteration, each of which returns at once
    after the tol exit) with no host read, or the wrapper raises.
    ``launches`` counts calls."""
    _check_plane_form(u1, "tvcsad_global_loop")
    args = (u1, u2, u1_, u2_, xi11, xi12, xi21, xi22, b, i1wx, i1wy, grad)
    if u1.device.type == "cpu":
        return tvcsad_global_loop_plain(*args, l_t, masks, ncount, theta, tau,
                                        tol2, max_iters)
    dev, (h, w) = u1.device, u1.shape
    names = ("u1", "u2", "u1_", "u2_", "xi11", "xi12", "xi21", "xi22")
    for name, t in zip(names + ("i1wx", "i1wy", "grad"), args[:8] + args[9:]):
        kb.require_cuda_tensor(t, name, torch.float32, dev, (h, w))
    kb.require_cuda_tensor(b, "b", torch.float32, dev, (N_D, h, w))
    part = torch.empty(-(-h * w // ERR_BLOCK_CELLS), dtype=torch.float64,
                       device=dev)
    state = torch.empty(3, dtype=torch.int32, device=dev)
    rb, ok = ranked_scratch(h, w, dev)
    code = kb.library().faldoi_tvcsad_global_loop(
        *(t.data_ptr() for t in args), part.data_ptr(), state.data_ptr(),
        rb.data_ptr(), ok.data_ptr(), h, w, _f32(l_t), _f32(theta), _f32(tau),
        _f32(tol2), int(max_iters), kb.stream_ptr(dev))
    kb.check(code, "tvcsad_global_loop")
    tvcsad_global_loop.launches += 1
    return state[:1]


tvcsad_global_loop.launches = 0   # K14 calls (a warp each), raised after a launch


def tvcsad_global(i0n: torch.Tensor, i1n: torch.Tensor, u1: torch.Tensor,
                  u2: torch.Tensor, lambda_: float, theta: float, tau: float,
                  tol: float, warps: int, max_iters: int = MAX_ITERATIONS_GLOBAL,
                  stats=None):
    """TV-CSAD global refinement.  i0n, i1n: normalized+smoothed gray frames
    (h, w); u1, u2: the initial flow.  Returns the refined (u1, u2).  Each
    warp's PD loop (K14) stops once the mean squared update is at most
    ``tol^2`` (float32) or after ``max_iters`` iterations.

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``), read from the card once, after the last warp."""
    dev = i0n.device
    h, w = i0n.shape
    l_t = _f32(np.float32(lambda_) * np.float32(theta))
    theta, tau = _f32(theta), _f32(tau)
    tol2 = _f32(np.float32(tol) * np.float32(tol))
    masks, ncount = image_masks(h, w, dev)
    i1x, i1y = centered_gradient(i1n)
    i1_stack = torch.stack([i1n, i1x, i1y]).contiguous()
    u1, u2 = u1.clone().contiguous(), u2.clone().contiguous()
    xi = [torch.zeros_like(u1) for _ in range(4)]
    iters = []
    for _ in range(warps):
        i1w, i1wx, i1wy = _warp(i1_stack, u1, u2)
        grad = hypot(i1wx * i1wx + i1wy * i1wy, 0.01)   # :1519
        b = csad_b(i0n, i1w, i1wx, i1wy, u1, u2, grad, masks)
        iters.append(tvcsad_global_loop(u1, u2, u1.clone(), u2.clone(), *xi, b,
                                        i1wx, i1wy, grad, l_t, masks, ncount,
                                        theta, tau, tol2, max_iters))
    if stats is not None:
        stats["global_iters"] = (torch.cat(iters).tolist() if iters else [])
    return u1, u2


def nltvcsad_global_loop_plain(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt, b, i1wx,
                               i1wy, sq, grad, l_t, masks, ncount, theta, tau,
                               max_iters: int) -> None:
    """Plain twin of K15: ``max_iters`` NLTV-CSAD PD iterations of one warp
    on the host's dispatch, updating u, u_bar (h, w) and the duals (24, h,
    w) in place: the v-step (``csad_vstep_plain`` on the breakpoints b
    normalised by ``sq``), v = u where ``grad <= GRAD_IS_ZERO``, the
    non-local dual steps and the divergence over wt, the primal step."""
    theta_t = torch.tensor(theta, dtype=u1.dtype, device=u1.device)
    gok = grad > GRAD_IS_ZERO
    for _ in range(max_iters):
        v1, v2 = csad_vstep_plain(u1, u2, b, i1wx, i1wy, sq, l_t, masks, ncount)
        v1 = torch.where(gok, v1, u1)   # :1735-1737
        v2 = torch.where(gok, v2, u2)
        sc_p.copy_(nonlocal_gradient_duals(sc_p, u1_, wp, wt, NL_OFFS, tau))
        sc_q.copy_(nonlocal_gradient_duals(sc_q, u2_, wp, wt, NL_OFFS, tau))
        nu1 = u1 - tau * (nonlocal_divergence(sc_p, wp, wt, NL_OFFS)
                          + (u1 - v1) / theta_t)
        nu2 = u2 - tau * (nonlocal_divergence(sc_q, wp, wt, NL_OFFS)
                          + (u2 - v2) / theta_t)
        u1_.copy_(2.0 * nu1 - u1)
        u2_.copy_(2.0 * nu2 - u2)
        u1.copy_(nu1)
        u2.copy_(nu2)


def nltvcsad_global_loop(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt, b, i1wx, i1wy,
                         sq, grad, l_t, masks, ncount, theta, tau,
                         max_iters: int) -> None:
    """K15: one warp's NLTV-CSAD PD loop of ``nltvcsad_global``, in place, a
    fixed ``max_iters`` iterations.  u1, u2, u1_, u2_, wt, i1wx, i1wy, sq
    (the breakpoints' denominator) and grad are (h, w) float32 planes; sc_p,
    sc_q and wp (24, h, w); b (48, h, w).  l_t, theta, tau: floats.  masks,
    ncount: ``image_masks`` (the twin reads them).

    Precondition: wp is symmetric, as ``nltv_global_loop`` (K6) states; K6's
    dual phase reads its planes 0-11.

    CPU tensors go to the plain twin; CUDA tensors enqueue the whole loop
    with one library call and no host read, or the wrapper raises: a launch
    that ranks each pixel's breakpoints once, then each iteration K6's dual
    phase and a primal phase that selects v itself (``csrc/
    csad_global.cu``).  ``launches`` counts calls."""
    _check_plane_form(u1, "nltvcsad_global_loop")
    if u1.device.type == "cpu":
        return nltvcsad_global_loop_plain(u1, u2, u1_, u2_, sc_p, sc_q, wp, wt,
                                          b, i1wx, i1wy, sq, grad, l_t, masks,
                                          ncount, theta, tau, max_iters)
    dev, (h, w) = u1.device, u1.shape
    planes = (u1, u2, u1_, u2_, wt, i1wx, i1wy, sq, grad)
    for name, t in zip(("u1", "u2", "u1_", "u2_", "wt", "i1wx", "i1wy", "sq",
                        "grad"), planes):
        kb.require_cuda_tensor(t, name, torch.float32, dev, (h, w))
    for name, t in (("sc_p", sc_p), ("sc_q", sc_q), ("wp", wp)):
        kb.require_cuda_tensor(t, name, torch.float32, dev, (NL_N_D, h, w))
    kb.require_cuda_tensor(b, "b", torch.float32, dev, (N_D, h, w))
    rb, ok = ranked_scratch(h, w, dev)
    code = kb.library().faldoi_nltvcsad_global_loop(
        *(t.data_ptr() for t in (u1, u2, u1_, u2_, wt, i1wx, i1wy, sq, grad, sc_p,
                                 sc_q, wp, b, rb, ok)),
        h, w, _f32(l_t), _f32(theta), _f32(tau), int(max_iters), kb.stream_ptr(dev))
    kb.check(code, "nltvcsad_global_loop")
    nltvcsad_global_loop.launches += 1
    return None


nltvcsad_global_loop.launches = 0   # K15 calls (a warp each), raised after a launch


def nltvcsad_global(i0n: torch.Tensor, i1n: torch.Tensor, i0_planes: np.ndarray,
                    u1: torch.Tensor, u2: torch.Tensor, lambda_: float,
                    theta: float, tau: float, warps: int,
                    max_iters: int = MAX_ITERATIONS_GLOBAL, stats=None):
    """NLTV-CSAD global refinement.  i0n, i1n: normalized+smoothed gray
    frames (h, w); i0_planes: I0's original (pd, h, w) colour planes for the
    Lab weights (global scales ws 2 / wi 5); u1, u2: the initial flow.
    Returns the refined (u1, u2) after ``max_iters`` iterations a warp (K15).

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``: ``max_iters`` each)."""
    dev = i0n.device
    h, w = i0n.shape
    l_t = _f32(np.float32(lambda_) * np.float32(theta))
    theta, tau = _f32(theta), _f32(tau)
    masks, ncount = image_masks(h, w, dev)
    wp, wt = global_weights(i0_planes, dev)
    i1x, i1y = centered_gradient(i1n)
    i1_stack = torch.stack([i1n, i1x, i1y]).contiguous()
    u1, u2 = u1.clone().contiguous(), u2.clone().contiguous()
    sc_p = torch.zeros((NL_N_D, h, w), dtype=u1.dtype, device=dev)
    sc_q = torch.zeros_like(sc_p)
    one = torch.ones((), dtype=u1.dtype, device=dev)
    for _ in range(warps):
        i1w, i1wx, i1wy = _warp(i1_stack, u1, u2)
        grad = i1wx * i1wx + i1wy * i1wy
        sq = sqrt_rn(torch.where(grad > GRAD_IS_ZERO, grad, one))
        b = csad_b(i0n, i1w, i1wx, i1wy, u1, u2, sq, masks)
        nltvcsad_global_loop(u1, u2, u1.clone(), u2.clone(), sc_p, sc_q, wp, wt,
                             b, i1wx, i1wy, sq, grad, l_t, masks, ncount, theta,
                             tau, max_iters)
    if stats is not None:
        stats["global_iters"] = [max_iters] * warps
    return u1, u2

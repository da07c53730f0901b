"""Batched canvas patch solvers for methods 0-8: TV-L1, NLTV-L1, TV-CSAD and
NLTV-CSAD, each plain and Gaussian-weighted, and TV-L1 with occlusions.

Port of ``faldoi_tpu/core/functionals.py::_solve_tvl1_family`` and
``_solve_nltv_family`` (reference ``tvl2_model.cpp:174-435``,
``tvl2w_model.cpp``, ``nltv_model.cpp``, ``nltvw_model.cpp``), run on B
patches at once.  Every patch lives on a fixed (P, P) canvas with a valid
box [0, ph) x [0, pw) whose origin in the image is (oy, ox):

* the source-frame crop goes through K0's stack form
  (``ops.patch_gather.gather_patches``, C = 1, from ``i0pad``);
* the warps of (I1, I1x, I1y) and the final I1 warp go through K4's patch
  form (``ops.bicubic.bicubic_sample_patches``) at the cells' displaced
  points, ``border_out=False``;
* the tol-gated PD loop is the static masked unroll of JAX's
  ``_bounded_pd_loop``: ``max_iters`` steps, and a lane freezes once its
  ``err <= tol^2``;
* the energy is the patch mean of data + coupling + regulariser.

The weighted methods (1, 3) weight the data term by a Gaussian window
centred on the patch's centre pixel: ``l_t`` becomes ``l_t * W`` per cell in
the threshold, and the eval's data term is multiplied by ``W``
(tvl2w_model.cpp:227, 374+).

The NLTV methods (2, 3) regularise with the 24 non-local duals of each flow
component, weighted by Lab similarity at the local scales (NL_BETA 2,
NL_INTENSITY 2): the weights are cropped from ``SolverConsts.wp_pad`` by K0's
planes form (C 24, into the (24, B, P, P) layout K7 reads coalesced), masked
to neighbours inside the box (``validate_ap_patch``), and normalised by the
patch-restricted ``wt``; the PD loop of a warp is kernel K7
(``nltv_patch_loop``, ``csrc/nltv.cu``), whose patch divergence is
unnormalised (aux_energy_model.cpp:178-212).

The CSAD methods (4-7) replace the L1 threshold by the exact prox of the
CSAD data term over the 7x7 window restricted to the box, the v-step of
kernel K8 (``ops.csad.csad_vstep``), with ``grad = hypot(|grad I1w|^2,
0.01)`` (tvcsad_model.cpp:361).  Methods 6 and 7 regularise with the NLTV
duals of methods 2 and 3 (plain PyTorch here); methods 4 and 5 keep the
reference's inert TV: its duals read flow-gradient buffers that are never
written, so they stay 0 and the eval's TV term is 0, and a warp's whole
PD loop is one launch of the K8 loop (``ops.csad.csad_patch_loop``)
(``true_tv=True`` runs the per-component TV projection instead, JAX's
``FALDOI_CSAD_TRUE_TV=1``).

Lanes (pairs mode): ``stack_solver_consts`` stacks the consts of L growing
lanes (the fwd and bwd directions of N frame pairs) along a leading axis,
and every solver of methods 0-7 takes a per-patch ``lane`` index ((B,)
int64) with them: the source crop (K0's stack form), the NLTV weight crop
(K0's planes form) and the warps (K4's patch form) read each patch's own
lane, one launch for the batch.  Everything else a solver does is per
canvas, so a patch's result does not depend on the batch it rides in.

Method 8 (TV-L1 with occlusions, ``solve_tvl1_occ``) solves u and a binary
occlusion field chi jointly over three frames: ``core.occlusion.
solve_occ_canvas``, whose PD loop of a warp is kernel K9's patch form.  Its
solver takes the chi canvases as the keyword ``chi`` and returns (u1, u2,
chi, ener); the solvers of methods 0-7 take no chi and return (u1, u2,
ener).

The TV-L1 patch PD arithmetic, and that of the CSAD methods but the inert
TV's loop, is plain PyTorch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.core.pd_common import (
    hypot, sqrt_rn, tvl1_threshold, tvl2_getD, tvl2_getP,
)
from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
from faldoi_tpu_torch.ops.csad import (
    canvas_masks, csad_b, csad_patch_loop, csad_vstep, neighbour_stack,
)
from faldoi_tpu_torch.ops.gaussian import gaussian1d_weight
from faldoi_tpu_torch.ops.nonlocal_ops import (
    neighbor_offsets, nltv_weights, nonlocal_divergence_sum,
    nonlocal_gradient_duals, ordered_sum, rgb_to_lab_np, shift_each,
)
from faldoi_tpu_torch.ops.patch_gather import (
    gather_patches, gather_plane_patches, pad_for_crops,
)
from faldoi_tpu_torch.ops.stencils import (
    canvas_ids, canvas_sum, centered_gradient, divergence_patch,
    forward_gradient_patch,
)


class SolverConsts(NamedTuple):
    """Per-growing constants of the patch solvers; the planes of L lanes'
    consts (``stack_solver_consts``) carry a leading lane axis."""

    i0pad: torch.Tensor      # (h+P, w+P) source frame, edge-padded bottom/right
    i1: torch.Tensor         # (h, w) target frame
    i1x: torch.Tensor
    i1y: torch.Tensor
    i1_stack: torch.Tensor   # (3, h, w) stacked (i1, i1x, i1y), K4's planes
    lambda_: torch.Tensor    # float32 scalars
    theta: torch.Tensor
    tau: torch.Tensor
    tol: torch.Tensor
    w1d: Optional[torch.Tensor] = None   # (2wr+1,) window of methods 1, 3
    wp_pad: Optional[torch.Tensor] = None  # (24, h+P, w+P) NLTV weights
    # method 8: (3, h, w) stacked (I_1, I_1x, I_1y) of the frame warped at -u
    # (I-1 forward, I2 backward), K4's planes; the padded weight g = 1 / (1 +
    # gamma |grad I0|) (h+P, w+P); (alpha, beta, mu, tau_u, tau_eta, tau_chi)
    i_1_stack: Optional[torch.Tensor] = None
    gpad: Optional[torch.Tensor] = None
    occ_prm: Optional[torch.Tensor] = None


NLTV_METHODS = (P.M_NLTVL1, P.M_NLTVL1_W)
CSAD_METHODS = (P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W)
# the methods whose consts carry the Gaussian window, and the NLTV weights
WEIGHTED_METHODS = (P.M_TVL1_W, P.M_NLTVL1_W, P.M_TVCSAD_W, P.M_NLTVCSAD_W)
NL_WEIGHT_METHODS = NLTV_METHODS + (P.M_NLTVCSAD, P.M_NLTVCSAD_W)
NLTV_OFFS = tuple(neighbor_offsets(P.NL_BETA))


def _scalar(x, dev):
    return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def make_solver_consts(i0: torch.Tensor, i1: torch.Tensor, lam, theta, tau,
                       tol, p: int, method: int = P.M_TVL1,
                       i0_planes: Optional[np.ndarray] = None,
                       i_1: Optional[torch.Tensor] = None,
                       occ_prm=None) -> SolverConsts:
    """SolverConsts of one growing direction (source i0, target i1).  The
    weighted methods (1, 3, 5, 7) add the window ``gaussian1d_weight(p //
    2)``; the NLTV-regularised methods (2, 3, 6, 7) add the local-scale
    weights of the source's raw
    (pd, h, w) colour planes ``i0_planes`` (0..255), zero-padded by p at the
    bottom and right as JAX pads them.  Method 8 adds the frame warped at -u,
    ``i_1`` (h, w), with its centred gradient, the weight g of i0, edge-padded
    by p, and ``occ_prm`` = (alpha, beta, mu, tau_u, tau_eta, tau_chi) as
    float32 (JAX's 4-frame set-up, match_growing.py:662-690)."""
    solver_for(method)
    i1x, i1y = centered_gradient(i1)
    dev = i0.device
    w1d = (torch.as_tensor(gaussian1d_weight(p // 2), device=dev)
           if method in WEIGHTED_METHODS else None)
    wp_pad = None
    if method in NL_WEIGHT_METHODS:
        if i0_planes is None:
            raise ValueError(f"method {method} (NLTV) needs the source's colour "
                             "planes (i0_planes)")
        wp, _, _ = nltv_weights(rgb_to_lab_np(np.asarray(i0_planes)), P.NL_BETA,
                                float(P.NL_BETA), float(P.NL_INTENSITY))
        wp_pad = torch.nn.functional.pad(torch.as_tensor(wp, device=dev),
                                         (0, p, 0, p)).contiguous()
    occ = {}
    if method == P.M_TVL1_OCC:
        from faldoi_tpu_torch.core.occlusion import init_weight

        if i_1 is None or occ_prm is None:
            raise ValueError("method 8 needs the frame warped at -u (i_1) and "
                             "the occlusion parameters (occ_prm)")
        i_1x, i_1y = centered_gradient(i_1)
        occ = dict(i_1_stack=torch.stack([i_1, i_1x, i_1y]).contiguous(),
                   gpad=pad_for_crops(init_weight(*centered_gradient(i0)), p),
                   occ_prm=torch.tensor(np.asarray(occ_prm, np.float32),
                                        device=dev))
    return SolverConsts(pad_for_crops(i0, p), i1, i1x, i1y,
                        torch.stack([i1, i1x, i1y]).contiguous(),
                        _scalar(lam, dev), _scalar(theta, dev), _scalar(tau, dev),
                        _scalar(tol, dev), w1d, wp_pad, **occ)


def stack_solver_consts(scs) -> SolverConsts:
    """The consts of L lanes (``make_solver_consts`` of one method, one
    frame shape) as one ``SolverConsts`` whose planes carry a leading lane
    axis: i0pad (L, H', W'), i1, i1x, i1y (L, h, w), i1_stack (L, 3, h, w),
    wp_pad (L, 24, H', W').  The scalars and ``w1d`` come from one set of
    parameters and are shared: they must be equal bit for bit in every
    lane.  Method 8's consts do not stack (K9's patch form has no lane
    index)."""
    scs = list(scs)
    if not scs:
        raise ValueError("no lanes to stack")
    first = scs[0]
    for k, sc in enumerate(scs):
        if sc.gpad is not None:
            raise ValueError("method 8's consts do not stack into lanes")
        for name in ("lambda_", "theta", "tau", "tol", "w1d"):
            a, b = getattr(first, name), getattr(sc, name)
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a, b)):
                raise ValueError(f"lane {k}: {name} differs from lane 0's; "
                                 "the lanes share one set of parameters")
        if (sc.wp_pad is None) != (first.wp_pad is None):
            raise ValueError(f"lane {k}: wp_pad given in some lanes only")
        if sc.i0pad.shape != first.i0pad.shape:
            raise ValueError(f"lane {k}: frame shape {tuple(sc.i1.shape)} "
                             f"differs from lane 0's {tuple(first.i1.shape)}")

    def stack(name):
        return torch.stack([getattr(sc, name) for sc in scs]).contiguous()

    return first._replace(
        i0pad=stack("i0pad"), i1=stack("i1"), i1x=stack("i1x"),
        i1y=stack("i1y"), i1_stack=stack("i1_stack"),
        wp_pad=None if first.wp_pad is None else stack("wp_pad"))


def _lane32(lane):
    """The int32 lane index K0's stack form and K4 take (None stays)."""
    return None if lane is None else lane.to(torch.int32).contiguous()


def solver_consts_from_numpy(sc, device) -> SolverConsts:
    """Carry a JAX ``SolverConsts`` (fields as arrays) into the port."""
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    occ = {}
    if sc.gpad is not None:
        occ = dict(i_1_stack=torch.stack([t(sc.i_1), t(sc.i_1x),
                                          t(sc.i_1y)]).contiguous(),
                   gpad=t(sc.gpad).contiguous(), occ_prm=t(sc.occ_prm))
    return SolverConsts(t(sc.i0pad).contiguous(), t(sc.i1), t(sc.i1x),
                        t(sc.i1y), t(sc.i1_stack).contiguous(), t(sc.lambda_),
                        t(sc.theta), t(sc.tau), t(sc.tol),
                        None if sc.w1d is None else t(sc.w1d),
                        None if sc.wp_pad is None else t(sc.wp_pad).contiguous(),
                        **occ)


def _weight2d(w1d, rows, cols, oy, ox, cj, ci, wr):
    """Gaussian-window weight of every canvas cell (tvl2w_model.cpp:227):
    W = w1d[row - cj + wr] * w1d[col - ci + wr] in global coordinates, the
    indices clipped to [0, 2wr] (so clamped boxes at the image edge keep the
    window centred on the patch's centre pixel).  (B,) -> (B, P, P)."""
    ridx = (oy[:, None, None] + rows - cj[:, None, None] + wr).clamp(0, 2 * wr)
    cidx = (ox[:, None, None] + cols - ci[:, None, None] + wr).clamp(0, 2 * wr)
    return w1d[ridx] * w1d[cidx]


def _solve_tvl1_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2,
                       p: int, warps: int, max_iters: int, weighted: bool,
                       lane=None):
    """Solve B TV-L1 patches, weighted (method 1) or not (method 0).

    ci, cj, oy, ox, ph, pw: (B,) int tensors (centre, canvas origin, valid
    box); u1, u2: (B, P, P) init canvases (zero outside the box); ``lane``:
    None, or the (B,) lane index into lane-stacked consts.  Returns
    (u1, u2, ener): the solved canvases (zero outside the box) and the (B,)
    patch energies.  The window radius is p // 2, as JAX passes it: the seed
    insertion's 3x3 solves of method 1 therefore read w1d[0..2], the tail
    of the 11-tap window (``seed_batch`` passes wr=1)."""
    dev = u1.device
    rows, cols = canvas_ids(p, dev)
    ph3, pw3 = ph[:, None, None], pw[:, None, None]
    inbox = (rows < ph3) & (cols < pw3)
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    ph32, pw32 = ph.to(torch.int32).contiguous(), pw.to(torch.int32).contiguous()
    box = (oy32, ox32, ph32, pw32)
    ln32 = _lane32(lane)
    i0_patch = gather_patches(sc.i0pad[..., None], oy32, ox32, p,
                              lane=ln32)[:, :, 0, :]
    i0_patch = i0_patch.permute(2, 0, 1)                        # (B, P, P)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)
        l_t = l_t * w2d
    tol2 = sc.tol * sc.tol

    xi = tuple(torch.zeros_like(u1) for _ in range(4))
    v1, v2 = u1, u2
    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_sample_patches(
            sc.i1_stack, *box, u1.contiguous(), u2.contiguous(), 3, lane=ln32)
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
    i1w = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 1, lane=ln32)[0]
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
               warps: int, max_iters: int, lane=None):
    """Solve B method-0 (TV-L1) patches; see ``_solve_tvl1_family``."""
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=False, lane=lane)


def solve_tvl1_w(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                 warps: int, max_iters: int, lane=None):
    """Solve B method-1 (Gaussian-weighted TV-L1) patches; ``sc.w1d`` must
    hold the window."""
    if sc.w1d is None:
        raise ValueError("solve_tvl1_w needs SolverConsts.w1d (method 1 consts)")
    return _solve_tvl1_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=True, lane=lane)


@functools.lru_cache(maxsize=None)
def _offset_grids(device):
    """(dy, dx) of the NLTV offsets as (24, 1, 1, 1) tensors on ``device``."""
    dy, dx = (torch.tensor([o[k] for o in NLTV_OFFS], device=device)
              .view(-1, 1, 1, 1) for k in (0, 1))
    return dy, dx


def nltv_crop_weights(wp_pad: torch.Tensor, oy, ox, ph, pw, p: int,
                      lane=None):
    """``_nltv_crop_weights``: the (24, B, P, P) weights of B patches cropped
    from the padded planes by K0's planes form (``lax.dynamic_slice`` of
    ``wp_pad`` at (oy, ox)), zeroed where the cell or its neighbour leaves
    the box (``validate_ap_patch``), and their patch-restricted sum
    ``wt = max(sum_j w_j, 1e-30)``, summed over j in order.  With ``lane``
    ((B,) int), ``wp_pad`` is (L, 24, H', W') and patch k reads lane
    lane[k]."""
    hp, wpp = wp_pad.shape[-2:]
    dev = wp_pad.device
    wpc = gather_plane_patches(
        wp_pad.unbind(0 if lane is None else 1),
        oy.to(torch.int64).contiguous(), ox.to(torch.int64).contiguous(), p,
        hp, wpp, lane=None if lane is None else lane.to(torch.int64).contiguous())
    rows, cols = canvas_ids(p, dev)
    dy, dx = _offset_grids(dev)
    ph4, pw4 = ph[None, :, None, None], pw[None, :, None, None]
    nr, nc = rows + dy, cols + dx
    mask = ((rows < ph4) & (cols < pw4) & (nr >= 0) & (nr < ph4)
            & (nc >= 0) & (nc < pw4))
    wp = torch.where(mask, wpc, torch.zeros((), dtype=wpc.dtype, device=dev))
    wt = torch.maximum(ordered_sum(wp), torch.tensor(1e-30, dtype=wp.dtype,
                                                     device=dev))
    return wp, wt


def nltv_patch_loop_plain(u1, u2, v1, v2, duals, i1wx, i1wy, grad, rho_c, wp,
                          wt, l_t, ph, pw, theta, tau, tol2, max_iters: int,
                          keep_duals: bool = False):
    """Plain twin of K7: the masked unroll of one warp's NLTV PD loop on B
    (P, P) canvases.  Returns (u1, u2, v1, v2, iterations (B,) int32, the
    (2, 24, B, P, P) duals if ``keep_duals`` else None); ``duals`` None
    starts them at zero.  The dual update is nltvl1_getD (nltv_model.cpp:
    211-273) with the patch-restricted wt, neighbours off the canvas read 0,
    and the divergence is not normalised."""
    dev = u1.device
    b, p = u1.shape[0], u1.shape[-1]
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    if duals is None:
        duals = torch.zeros((2, len(NLTV_OFFS)) + tuple(u1.shape),
                            dtype=u1.dtype, device=dev)
    npx = (ph * pw).to(u1.dtype)
    st = (u1, u2, u1, u2, duals[0], duals[1], v1, v2,
          torch.full((b,), float("inf"), dtype=u1.dtype, device=dev),
          torch.zeros((b,), dtype=torch.int32, device=dev))
    for _ in range(max_iters):
        c1, c2, c1_, c2_, sp, sq, _, _, err, n = st
        run = (err > tol2) & (n < max_iters)
        if not bool(run.any()):
            break
        nv1, nv2 = tvl1_threshold(c1, c2, rho_c, i1wx, i1wy, grad, l_t)
        sp = nonlocal_gradient_duals(sp, c1_, wp, wt, NLTV_OFFS, tau)
        sq = nonlocal_gradient_duals(sq, c2_, wp, wt, NLTV_OFFS, tau)
        nu1 = c1 - tau * (nonlocal_divergence_sum(sp, wp, NLTV_OFFS)
                          + (c1 - nv1) / theta)
        nu2 = c2 - tau * (nonlocal_divergence_sum(sq, wp, NLTV_OFFS)
                          + (c2 - nv2) / theta)
        e1, e2 = nu1 - c1, nu2 - c2
        nerr = canvas_sum(torch.where(inbox, e1 * e1 + e2 * e2, zero)) / npx
        new = (nu1, nu2, 2 * nu1 - c1, 2 * nu2 - c2, sp, sq, nv1, nv2, nerr,
               n + 1)
        st = tuple(torch.where(run.view((-1,) + (1,) * (a.dim() - 1))
                               if a.dim() < 4 else run.view(1, -1, 1, 1), nw, a)
                   for a, nw in zip(st, new))
    u1, u2, _, _, sp, sq, v1, v2, _, n = st
    return u1, u2, v1, v2, n, (torch.stack([sp, sq]) if keep_duals else None)


def nltv_patch_loop(u1, u2, v1, v2, duals, i1wx, i1wy, grad, rho_c, wp, wt,
                    l_t, ph, pw, theta, tau, tol2, max_iters: int,
                    keep_duals: bool = False):
    """K7: one warp's tol-gated NLTV PD loop of ``_solve_nltv_family`` on B
    (P, P) float32 canvases u1, u2, v1, v2 and the warp constants i1wx, i1wy,
    grad, rho_c; wp (24, B, P, P) box-masked weights, wt (B, P, P); l_t a
    0-d tensor or (B, P, P) canvas (method 3); ph, pw (B,) int32; theta, tau,
    tol2 0-d float32 tensors; ``duals`` (2, 24, B, P, P) or None (zeros).
    Returns new (u1, u2, v1, v2, iterations (B,) int32, duals or None); the
    inputs are not changed.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise).  The duals reach device memory only when given or asked for
    (``keep_duals``: the warps of a multi-warp solve but the last)."""
    if u1.dim() != 3 or u1.shape[1] != u1.shape[2]:
        raise ValueError(f"u1 must be (B, P, P), got {tuple(u1.shape)}")
    b, p = u1.shape[0], u1.shape[1]
    if p * p > 1024:
        raise ValueError(f"patch side {p}: the kernel takes P*P <= 1024")
    if u1.device.type == "cpu":
        return nltv_patch_loop_plain(u1, u2, v1, v2, duals, i1wx, i1wy, grad,
                                     rho_c, wp, wt, l_t, ph, pw, theta, tau,
                                     tol2, max_iters, keep_duals)
    dev = u1.device
    canv = (u1, u2, v1, v2, i1wx, i1wy, grad, rho_c, wt)
    for name, t in zip(("u1", "u2", "v1", "v2", "i1wx", "i1wy", "grad",
                        "rho_c", "wt"), canv):
        kb.require_cuda_tensor(t, name, torch.float32, dev, (b, p, p))
    n_d = len(NLTV_OFFS)
    kb.require_cuda_tensor(wp, "wp", torch.float32, dev, (n_d, b, p, p))
    lt_cells = l_t.dim() != 0
    kb.require_cuda_tensor(l_t, "l_t", torch.float32, dev,
                           (b, p, p) if lt_cells else ())
    for name, t in (("ph", ph), ("pw", pw)):
        kb.require_cuda_tensor(t, name, torch.int32, dev, (b,))
    if duals is not None:
        kb.require_cuda_tensor(duals, "duals", torch.float32, dev,
                               (2, n_d, b, p, p))
    scal = torch.stack([theta, tau, tol2]).to(torch.float32).contiguous()
    kb.require_cuda_tensor(scal, "theta, tau, tol2", torch.float32, dev, (3,))
    outs = [torch.empty_like(u1) for _ in range(4)]
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    dout = (torch.empty((2, n_d, b, p, p), dtype=torch.float32, device=dev)
            if keep_duals else None)
    if b == 0:
        return (*outs, iters, dout)
    code = kb.library().faldoi_nltv_patch_loop(
        *(t.data_ptr() for t in (u1, u2, v1, v2, i1wx, i1wy, grad, rho_c, wp,
                                 wt, l_t, scal, ph, pw)),
        None if duals is None else duals.data_ptr(),
        *(t.data_ptr() for t in outs), iters.data_ptr(),
        None if dout is None else dout.data_ptr(), b, p, int(lt_cells),
        int(max_iters), kb.stream_ptr(dev))
    kb.check(code, "nltv_patch_loop")
    nltv_patch_loop.launches += 1
    return (*outs, iters, dout)


nltv_patch_loop.launches = 0   # K7 launches, raised only after a launch


def _nltv_reg_energy(u1, u2, wp, wt):
    """The NLTV regulariser of the eval: sum_j w_j (|u1 - u1_j| + |u2 -
    u2_j|) / wt, summed over j in order (nltv_model.cpp:69-156)."""
    n1 = shift_each(u1.expand_as(wp), NLTV_OFFS)
    n2 = shift_each(u2.expand_as(wp), NLTV_OFFS)
    return ordered_sum(wp * ((u1 - n1).abs() + (u2 - n2).abs())) / wt


def _solve_nltv_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2,
                       p: int, warps: int, max_iters: int, weighted: bool,
                       lane=None):
    """Solve B NLTV-L1 patches, weighted (method 3) or not (method 2); the
    arguments and results of ``_solve_tvl1_family``.  The duals start at
    zero in every solve and carry across its warps; u_bar restarts from u at
    each warp."""
    if sc.wp_pad is None:
        raise ValueError("the NLTV solvers need SolverConsts.wp_pad (method 2 "
                         "or 3 consts)")
    dev = u1.device
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    ph32, pw32 = ph.to(torch.int32).contiguous(), pw.to(torch.int32).contiguous()
    box = (oy32, ox32, ph32, pw32)
    ln32 = _lane32(lane)
    i0_patch = gather_patches(sc.i0pad[..., None], oy32, ox32, p,
                              lane=ln32)[:, :, 0, :]
    i0_patch = i0_patch.permute(2, 0, 1)                        # (B, P, P)
    wp, wt = nltv_crop_weights(sc.wp_pad, oy, ox, ph, pw, p, lane)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)
        l_t = (l_t * w2d).contiguous()
    tol2 = sc.tol * sc.tol

    u1, u2 = u1.contiguous(), u2.contiguous()
    v1, v2 = u1, u2
    duals = None
    for k in range(warps):
        i1w, i1wx, i1wy = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 3,
                                                 lane=ln32)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0_patch
        u1, u2, v1, v2, _, duals = nltv_patch_loop(
            u1, u2, v1, v2, duals, i1wx, i1wy, grad, rho_c, wp, wt, l_t, ph32,
            pw32, sc.theta, sc.tau, tol2, max_iters, keep_duals=k < warps - 1)

    # eval (nltv_model.cpp:69-156): zero the out-of-box cells before the
    # shift-based regulariser (0 * inf = NaN)
    u1 = torch.where(inbox, u1, zero)
    u2 = torch.where(inbox, u2, zero)
    v1 = torch.where(inbox, v1, zero)
    v2 = torch.where(inbox, v2, zero)
    i1w = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 1, lane=ln32)[0]
    dt = sc.lambda_ * torch.abs(i1w - i0_patch)
    if weighted:
        dt = dt * w2d
    e1 = u1 - v1
    e2 = u2 - v2
    dc = (1.0 / (2.0 * sc.theta)) * (e1 * e1 + e2 * e2)
    g = _nltv_reg_energy(u1, u2, wp, wt)
    ener = canvas_sum(torch.where(inbox, dc + dt + g, zero)) / (ph * pw).to(u1.dtype)
    return u1, u2, ener


def solve_nltvl1(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                 warps: int, max_iters: int, lane=None):
    """Solve B method-2 (NLTV-L1) patches; ``sc.wp_pad`` must hold the
    weights."""
    return _solve_nltv_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=False, lane=lane)


def solve_nltvl1_w(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                   warps: int, max_iters: int, lane=None):
    """Solve B method-3 (Gaussian-weighted NLTV-L1) patches; ``sc.w1d`` and
    ``sc.wp_pad`` must hold the window and the weights."""
    if sc.w1d is None:
        raise ValueError("solve_nltvl1_w needs SolverConsts.w1d (method 3 consts)")
    return _solve_nltv_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=True, lane=lane)


def _solve_csad_family(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2,
                       p: int, warps: int, max_iters: int, weighted: bool,
                       nltv_reg: bool, true_tv: bool = False, lane=None):
    """Solve B CSAD patches: TV-CSAD (method 4, weighted 5) or NLTV-CSAD (6,
    weighted 7); the arguments and results of ``_solve_tvl1_family``.  Per
    warp, K4 samples the warp, ``grad = hypot(|grad I1w|^2, 0.01)`` and the 48
    breakpoint planes are built once, then the tol-gated masked unroll runs
    K8's v-step, the regulariser's step and the primal step; with the inert
    TV (methods 4, 5) that whole loop is one launch of the K8 loop
    (``ops.csad.csad_patch_loop``).  Out-of-box
    cells take +-inf or NaN in the v-step (no neighbour counts there) and
    carry them, as JAX does; every use masks them, and the eval zeroes them
    first.  ``true_tv`` (methods 4, 5): the per-component TV projection
    instead of the reference's inert TV (tvcsad_model.cpp:231-260)."""
    if nltv_reg and sc.wp_pad is None:
        raise ValueError("the NLTV-CSAD solvers need SolverConsts.wp_pad "
                         "(method 6 or 7 consts)")
    inert_tv = not nltv_reg and not true_tv
    dev = u1.device
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    ph32, pw32 = ph.to(torch.int32).contiguous(), pw.to(torch.int32).contiguous()
    box = (oy32, ox32, ph32, pw32)
    ln32 = _lane32(lane)
    i0_patch = gather_patches(sc.i0pad[..., None], oy32, ox32, p,
                              lane=ln32)[:, :, 0, :]
    i0_patch = i0_patch.permute(2, 0, 1)                        # (B, P, P)
    masks, ncount = canvas_masks(ph32, pw32, p)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)
        l_t = (l_t * w2d).contiguous()
    tol2 = sc.tol * sc.tol
    npx = (ph * pw).to(u1.dtype)

    if nltv_reg:
        wp, wt = nltv_crop_weights(sc.wp_pad, oy, ox, ph, pw, p, lane)
        reg = tuple(torch.zeros((len(NLTV_OFFS),) + tuple(u1.shape),
                                dtype=u1.dtype, device=dev) for _ in range(2))
    elif inert_tv:
        reg = ()
    else:
        reg = tuple(torch.zeros_like(u1) for _ in range(4))
    u1, u2 = u1.contiguous(), u2.contiguous()
    v1, v2 = u1, u2
    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 3,
                                                 lane=ln32)
        grad = hypot(i1wx * i1wx + i1wy * i1wy, 0.01)   # tvcsad_model.cpp:361
        b = csad_b(i0_patch, i1w, i1wx, i1wy, u1, u2, grad, masks)
        if inert_tv:
            # the duals stay 0 (the reference's never-written buffers): the
            # whole loop is the K8 loop, one launch
            u1, u2, v1, v2, _ = csad_patch_loop(
                u1, u2, v1, v2, b, i1wx, i1wy, grad, l_t, masks, ncount, ph32,
                pw32, sc.theta, sc.tau, tol2, max_iters)
            continue
        st = (u1, u2, u1, u2, reg, v1, v2,
              torch.full(u1.shape[:1], float("inf"), dtype=u1.dtype, device=dev),
              torch.zeros(u1.shape[:1], dtype=torch.int32, device=dev))
        for _ in range(max_iters):
            c1, c2, c1_, c2_, rg, _, _, err, n = st
            nv1, nv2 = csad_vstep(c1, c2, b, i1wx, i1wy, grad, l_t, masks,
                                  ncount, ph32, pw32)
            if nltv_reg:
                sp = nonlocal_gradient_duals(rg[0], c1_, wp, wt, NLTV_OFFS, sc.tau)
                sq = nonlocal_gradient_duals(rg[1], c2_, wp, wt, NLTV_OFFS, sc.tau)
                nu1 = c1 - sc.tau * (nonlocal_divergence_sum(sp, wp, NLTV_OFFS)
                                     + (c1 - nv1) / sc.theta)
                nu2 = c2 - sc.tau * (nonlocal_divergence_sum(sq, wp, NLTV_OFFS)
                                     + (c2 - nv2) / sc.theta)
                rg = (sp, sq)
            else:
                x11, x12, x21, x22 = rg
                u1x, u1y = forward_gradient_patch(c1_, ph, pw)
                u2x, u2y = forward_gradient_patch(c2_, ph, pw)
                n1 = torch.clamp(hypot(x11, x12), min=1.0)
                n2 = torch.clamp(hypot(x21, x22), min=1.0)
                x11, x12 = (x11 + sc.tau * u1x) / n1, (x12 + sc.tau * u1y) / n1
                x21, x22 = (x21 + sc.tau * u2x) / n2, (x22 + sc.tau * u2y) / n2
                d1 = divergence_patch(x11, x12, ph, pw)
                d2 = divergence_patch(x21, x22, ph, pw)
                nu1 = c1 - sc.tau * (-d1 + (c1 - nv1) / sc.theta)
                nu2 = c2 - sc.tau * (-d2 + (c2 - nv2) / sc.theta)
                rg = (x11, x12, x21, x22)
            e1, e2 = nu1 - c1, nu2 - c2
            nerr = canvas_sum(torch.where(inbox, e1 * e1 + e2 * e2, zero)) / npx
            run = (err > tol2) & (n < max_iters)
            lane = run.view(-1, 1, 1)
            rg = tuple(torch.where(run.view((1,) * (a.dim() - 3) + (-1, 1, 1)),
                                   nw, a) for a, nw in zip(st[4], rg))
            new = (nu1, nu2, 2 * nu1 - c1, 2 * nu2 - c2, nv1, nv2)
            old = st[:4] + st[5:7]
            u1, u2, u1b, u2b, v1, v2 = (torch.where(lane, nw, a)
                                        for a, nw in zip(old, new))
            st = (u1, u2, u1b, u2b, rg, v1, v2, torch.where(run, nerr, err),
                  torch.where(run, n + 1, n))
        u1, u2, reg, v1, v2 = st[0], st[1], st[4], st[5], st[6]

    # eval (tvcsad_model.cpp:87-175 and the NLTV-CSAD analogues): zero the
    # out-of-box cells first (0 * inf = NaN through the shifts)
    u1 = torch.where(inbox, u1, zero)
    u2 = torch.where(inbox, u2, zero)
    v1 = torch.where(inbox, v1, zero)
    v2 = torch.where(inbox, v2, zero)
    i1w = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 1, lane=ln32)[0]
    i0n, i1wn = neighbour_stack(i0_patch), neighbour_stack(i1w)
    dt = ordered_sum(torch.where(masks, (i0_patch - i0n - i1w + i1wn).abs(), zero))
    dt = dt * sc.lambda_
    if weighted:
        dt = dt * w2d
    e1 = u1 - v1
    e2 = u2 - v2
    dc = (1.0 / (2.0 * sc.theta)) * (e1 * e1 + e2 * e2)
    if nltv_reg:
        g = _nltv_reg_energy(u1, u2, wp, wt)
    elif inert_tv:
        g = zero                 # eval_tvcsad reads the same zero buffers
    else:
        u1x, u1y = forward_gradient_patch(u1, ph, pw)
        u2x, u2y = forward_gradient_patch(u2, ph, pw)
        g = sqrt_rn(u1x * u1x + u1y * u1y + u2x * u2x + u2y * u2y)
    ener = canvas_sum(torch.where(inbox, dc + dt + g, zero)) / (ph * pw).to(u1.dtype)
    return u1, u2, ener


def solve_tvcsad(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                 warps: int, max_iters: int, true_tv: bool = False, lane=None):
    """Solve B method-4 (TV-CSAD) patches; see ``_solve_csad_family``."""
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=False, nltv_reg=False,
                              true_tv=true_tv, lane=lane)


def solve_tvcsad_w(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                   warps: int, max_iters: int, true_tv: bool = False,
                   lane=None):
    """Solve B method-5 (Gaussian-weighted TV-CSAD) patches; ``sc.w1d`` must
    hold the window."""
    if sc.w1d is None:
        raise ValueError("solve_tvcsad_w needs SolverConsts.w1d (method 5 consts)")
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=True, nltv_reg=False,
                              true_tv=true_tv, lane=lane)


def solve_nltvcsad(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                   warps: int, max_iters: int, lane=None):
    """Solve B method-6 (NLTV-CSAD) patches; ``sc.wp_pad`` must hold the
    weights."""
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=False, nltv_reg=True,
                              lane=lane)


def solve_nltvcsad_w(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                     warps: int, max_iters: int, lane=None):
    """Solve B method-7 (Gaussian-weighted NLTV-CSAD) patches; ``sc.w1d`` and
    ``sc.wp_pad`` must hold the window and the weights."""
    if sc.w1d is None:
        raise ValueError("solve_nltvcsad_w needs SolverConsts.w1d (method 7 "
                         "consts)")
    return _solve_csad_family(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps,
                              max_iters, weighted=True, nltv_reg=True,
                              lane=lane)


def solve_tvl1_occ(sc: SolverConsts, ci, cj, oy, ox, ph, pw, u1, u2, p: int,
                   warps: int, max_iters: int, chi, lane=None):
    """Solve B method-8 (TV-L1 with occlusions) patches from the u1, u2 and
    ``chi`` init canvases; ``sc`` must hold method 8's
    consts.  The source and weight crops go through K0's stack form, the
    rest is ``core.occlusion.solve_occ_canvas``.  Returns (u1, u2, chi,
    ener).  The caller passes the PD cap ``iterations_of``, not
    ``max_iter_patch`` (tvl2_model_occ.cpp:653).  It takes no lanes: K9's
    patch form samples I1 and I-1 itself and has no lane index."""
    from faldoi_tpu_torch.core.occlusion import local_scalars, solve_occ_canvas

    if lane is not None:
        raise ValueError("method 8's solver takes no lane index")
    if sc.gpad is None:
        raise ValueError("solve_tvl1_occ needs method 8's SolverConsts "
                         "(i_1_stack, gpad, occ_prm)")
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    ph32, pw32 = ph.to(torch.int32).contiguous(), pw.to(torch.int32).contiguous()
    i0_patch, g_patch = (
        gather_patches(pl[:, :, None], oy32, ox32, p)[:, :, 0, :]
        .permute(2, 0, 1).contiguous() for pl in (sc.i0pad, sc.gpad))
    scal = local_scalars(sc.lambda_, sc.theta, sc.occ_prm, sc.tol)
    return solve_occ_canvas(i0_patch, sc.i1_stack, sc.i_1_stack, g_patch, oy32,
                            ox32, ph32, pw32, u1, u2, chi, scal, warps, max_iters)


# method -> patch solver (JAX's ``functionals.SOLVERS``)
SOLVERS = {P.M_TVL1: solve_tvl1, P.M_TVL1_W: solve_tvl1_w,
           P.M_NLTVL1: solve_nltvl1, P.M_NLTVL1_W: solve_nltvl1_w,
           P.M_TVCSAD: solve_tvcsad, P.M_TVCSAD_W: solve_tvcsad_w,
           P.M_NLTVCSAD: solve_nltvcsad, P.M_NLTVCSAD_W: solve_nltvcsad_w,
           P.M_TVL1_OCC: solve_tvl1_occ}


def solver_for(method: int):
    """The patch solver of ``method``; an unknown method raises."""
    if method not in SOLVERS:
        raise ValueError(f"unknown method {method} (the methods are 0-8)")
    return SOLVERS[method]

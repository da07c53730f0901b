"""TV-L1 with occlusion estimation (method 8), with kernel K9 for its
primal-dual loop.

Port of ``faldoi_tpu/core/occlusion.py`` (Ballester et al., DAGM 2012;
reference ``tvl2_model_occ.cpp``): the flow u and a binary occlusion field
chi are minimised jointly over three frames (I-1, I0, I1).  Occluded pixels
use the backward data term rho(I-1) with the flow negated; the regulariser
is weighted by g = 1/(1 + gamma |grad I0|); every PD iteration runs 24 dual
steps of xi (the flow) and 24 of eta and chi, and chi is binarised at 0.6
after every chi loop (``tvl2coupled_get_chi_patch``, :411-484).

One PD loop serves both domains, as the reference's
``guided_tvl2coupled_occ`` (:492-779) does: the patch solver runs it on B
(P, P) canvases with valid boxes ``[0, ph) x [0, pw)``; the global step on
the whole image as one canvas with the box (h, w).

* ``occ_pd_step``: one PD iteration of every canvas in plain PyTorch (the
  v-step, ``get_xi``, ``get_chi``, the squared update's in-box maximum).
* ``occ_patch_loop`` (K9's patch form, ``csrc/occlusion.cu``): one warp's
  whole tol-gated PD loop of B canvases in one launch; its twin
  ``occ_patch_loop_plain`` is the masked loop of ``occ_pd_step``.
* ``occ_global_loop`` (K9's whole-image form): one warp's whole tol-gated
  PD loop over the image in one cooperative launch, the tol exit on the
  card; its twin ``occ_global_loop_plain`` is ``occ_patch_loop_plain`` on
  the image as one canvas.
* ``solve_occ_canvas``: the patch solver (warps by K4's patch form, the
  energy ``eval_tvl2coupled_occ`` in plain ops); ``tvl2_occ_global``: the
  global step (warps by K4's flow form, K9's whole-image form once a warp),
  returning (u1, u2, chi).

The state of a loop is one (11, ..., H, W) tensor in the order ``STATE``;
the per-warp constants one (8, ..., H, W) tensor in the order
``WARP_CONSTS``; the scalars one (14,) float32 tensor in the order
``SCALARS``, derived as JAX derives them: in float32 from the local step's
float32 constants (``local_scalars``), in float64 and rounded once from the
global step's Python floats (``global_scalars``).

Kept from JAX, where it deviates from the reference by design: ``div_u`` is
computed from the current flow (the reference reads memory it never
writes), and ``eta`` starts at 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.pd_common import sqrt_rn
from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches, bicubic_warp_planes
from faldoi_tpu_torch.ops.stencils import (
    canvas_sum, centered_gradient, divergence_patch, forward_gradient_patch,
    grid_ids,
)

STATE = ("u1", "u2", "chi", "xi11", "xi12", "xi21", "xi22", "eta1", "eta2",
         "v1", "v2")
WARP_CONSTS = ("i1wx", "i1wy", "i_1wx", "i_1wy", "grad_1", "grad__1",
               "rho_c1", "rho_c_1")
SCALARS = ("lam", "theta", "beta", "mu", "tau_chi", "l_t", "mu_t_occ",
           "alpha_i_occ", "lam_coef", "theta_beta", "tau_theta", "mu_tau_eta",
           "alpha_2", "tol2")
_S = {name: k for k, name in enumerate(SCALARS)}
# K9's float operations a cell a PD iteration, counted from
# csrc/occlusion.cu: the v-step 30, chi's gradient 2, 24 xi steps of 50 (g xi
# 4, two divergences 6, v + theta div + theta beta grad chi 8, two gradients
# 4, g grad 4, two norms 12, four updates 12), the primal step 18, the
# squared update 5, F and G 14, div nu 3, 24 eta / chi steps of 29 (eta 13,
# g eta 2, the divergence 3, chi 9, the gradient 2)
PD_OPS = 30 + 2 + 24 * 50 + 18 + 5 + 14 + 3 + 24 * 29


def init_weight(i0x: torch.Tensor, i0y: torch.Tensor) -> torch.Tensor:
    """g = 1 / (1 + gamma |grad I0|) (utils.cpp:838-852)."""
    one = torch.ones((), dtype=i0x.dtype, device=i0x.device)
    return one / (one + P.PAR_DEFAULT_GAMMA * sqrt_rn(i0x * i0x + i0y * i0y))


def local_scalars(lambda_, theta, occ_prm, tol) -> torch.Tensor:
    """The scalars of the local step, from its float32 0-d tensors (lambda,
    theta, tol) and ``occ_prm`` (alpha, beta, mu, tau_u, tau_eta, tau_chi),
    in float32 as JAX traces them."""
    alpha, beta, mu, tau_u, tau_eta, tau_chi = occ_prm.unbind(0)
    one = torch.ones((), dtype=torch.float32, device=occ_prm.device)
    l_t = lambda_ * theta
    at = alpha * theta
    opat = one + at
    return torch.stack([lambda_, theta, beta, mu, tau_chi, l_t, l_t / opat,
                        one / opat, at / opat, theta * beta, tau_u / theta,
                        mu * tau_eta, alpha / (2 * one), tol * tol]).contiguous()


def global_scalars(prm: P.Parameters, device) -> torch.Tensor:
    """The scalars of the global step: JAX's static Python floats, each
    expression evaluated in float64 and rounded to float32 once."""
    lam, th, al, be, mu = prm.lambda_, prm.theta, prm.alpha, prm.beta, prm.mu
    opat = 1.0 + al * th
    vals = (lam, th, be, mu, prm.tau_chi, lam * th, lam * th / opat, 1.0 / opat,
            al * th / opat, th * be, prm.tau_u / th, mu * prm.tau_eta, al / 2.0,
            prm.tol_OF * prm.tol_OF)
    return torch.tensor(np.array(vals, dtype=np.float32), device=device)


class _Scal:
    """The scalars as 0-d tensors, by name."""

    def __init__(self, scal):
        for name, k in _S.items():
            setattr(self, name, scal[k])


def _box(ph, pw, like):
    rows, cols = grid_ids(like)
    return (rows < ph[:, None, None]) & (cols < pw[:, None, None])


def _div_g(g, a, b, ph, pw):
    return divergence_patch(g * a, g * b, ph, pw)


def get_xi(xi, g, v1, v2, chix, chiy, ph, pw, s: _Scal):
    """tvl2coupled_get_xi_patch (:312-407): ITER_XI - 1 = 24 dual steps on
    (B, H, W) canvases; returns (xi, div(g xi_1), div(g xi_2))."""
    xi11, xi12, xi21, xi22 = xi
    one = torch.ones((), dtype=v1.dtype, device=v1.device)
    for _ in range(1, P.ITER_XI):
        d1 = _div_g(g, xi11, xi12, ph, pw)
        d2 = _div_g(g, xi21, xi22, ph, pw)
        vi1 = v1 + s.theta * d1 + s.theta_beta * chix
        vi2 = v2 + s.theta * d2 + s.theta_beta * chiy
        g1x, g1y = forward_gradient_patch(vi1, ph, pw)
        g2x, g2y = forward_gradient_patch(vi2, ph, pw)
        vec11, vec12, vec21, vec22 = g * g1x, g * g1y, g * g2x, g * g2y
        den1 = one + s.tau_theta * sqrt_rn(vec11 * vec11 + vec12 * vec12)
        den2 = one + s.tau_theta * sqrt_rn(vec21 * vec21 + vec22 * vec22)
        xi11 = (xi11 + s.tau_theta * vec11) / den1
        xi12 = (xi12 + s.tau_theta * vec12) / den1
        xi21 = (xi21 + s.tau_theta * vec21) / den2
        xi22 = (xi22 + s.tau_theta * vec22) / den2
    return ((xi11, xi12, xi21, xi22), _div_g(g, xi11, xi12, ph, pw),
            _div_g(g, xi21, xi22, ph, pw))


def get_chi(chi, F, G, g, eta1, eta2, div_u, ph, pw, inbox, s: _Scal):
    """tvl2coupled_get_chi_patch (:411-484): ITER_CHI - 1 = 24 eta / chi
    steps, then chi binarised at THRESHOLD_DELTA and zeroed outside the box.
    The clip to [0, 1] and the projection scale are written as selections
    (a NaN stays NaN, a zero keeps its sign), as the kernel does them."""
    one = torch.ones((), dtype=chi.dtype, device=chi.device)
    zero = torch.zeros((), dtype=chi.dtype, device=chi.device)
    chix, chiy = forward_gradient_patch(chi, ph, pw)
    for _ in range(1, P.ITER_CHI):
        e1 = eta1 + s.mu_tau_eta * g * chix
        e2 = eta2 + s.mu_tau_eta * g * chiy
        ne = sqrt_rn(e1 * e1 + e2 * e2)
        scale = torch.where(ne <= 1.0, one, ne)
        eta1, eta2 = e1 / scale, e2 / scale
        dge = _div_g(g, eta1, eta2, ph, pw)
        chi = chi + s.tau_chi * (s.mu * dge - s.beta * div_u - F - G)
        chi = torch.where(chi < 0.0, zero, torch.where(chi > 1.0, one, chi))
        chix, chiy = forward_gradient_patch(chi, ph, pw)
    chi = torch.where((chi > P.THRESHOLD_DELTA) & inbox, one, zero)
    return chi, eta1, eta2


def occ_pd_step(st, wc, g, ph, pw, scal):
    """One PD iteration (the ``while_loop`` body of ``solve_occ_canvas``) of
    every canvas: st (11, B, H, W), wc (8, B, H, W), g (B, H, W), ph, pw
    (B,) int, scal (14,).  Returns (new st, err (B,)), err the largest
    squared update inside the box (NaN if any is NaN)."""
    s = _Scal(scal)
    u1, u2, chi, x11, x12, x21, x22, eta1, eta2, _, _ = st.unbind(0)
    i1wx, i1wy, i_1wx, i_1wy, grad_1, grad__1, rho_c1, rho_c_1 = wc.unbind(0)
    inbox = _box(ph, pw, u1)
    one = torch.ones((), dtype=u1.dtype, device=u1.device)
    zero = torch.zeros((), dtype=u1.dtype, device=u1.device)
    rho_1 = rho_c1 + i1wx * u1 + i1wy * u2
    rho__1 = rho_c_1 + i_1wx * u1 + i_1wy * u2
    occ = chi != 0.0
    eps = torch.where(occ, -one, one)
    alpha_i = torch.where(occ, s.alpha_i_occ, one)
    mu_t = torch.where(occ, s.mu_t_occ, s.l_t)
    lam_v = torch.where(occ, rho__1 + s.lam_coef * (u1 * i_1wx + u2 * i_1wy),
                        rho_1)
    grad = torch.where(occ, grad__1, grad_1)
    iwx = torch.where(occ, i_1wx, i1wx)
    iwy = torch.where(occ, i_1wy, i1wy)
    rho = torch.where(occ, rho__1, rho_1)
    small = grad < P.GRAD_IS_ZERO
    gs = torch.where(small, one, grad)
    vm1 = torch.where(small, u1, u1 - eps * rho * iwx / gs)
    vm2 = torch.where(small, u2, u2 - eps * rho * iwy / gs)
    hi = lam_v > mu_t * grad
    lo = lam_v < -mu_t * grad
    v1 = torch.where(hi, alpha_i * u1 - mu_t * eps * iwx,
                     torch.where(lo, alpha_i * u1 + mu_t * eps * iwx, vm1))
    v2 = torch.where(hi, alpha_i * u2 - mu_t * eps * iwy,
                     torch.where(lo, alpha_i * u2 + mu_t * eps * iwy, vm2))

    chix, chiy = forward_gradient_patch(chi, ph, pw)
    xi, d1, d2 = get_xi((x11, x12, x21, x22), g, v1, v2, chix, chiy, ph, pw, s)
    nu1 = v1 + s.theta * d1 + s.theta_beta * chix
    nu2 = v2 + s.theta * d2 + s.theta_beta * chiy
    e1, e2 = nu1 - u1, nu2 - u2
    diff = e1 * e1 + e2 * e2
    rho__1v = rho_c_1 + i_1wx * v1 + i_1wy * v2
    rho_1v = rho_c1 + i1wx * v1 + i1wy * v2
    F = s.lam * (rho__1v.abs() - rho_1v.abs())
    G = s.alpha_2 * (v1 * v1 + v2 * v2)
    div_u = divergence_patch(nu1, nu2, ph, pw)
    chi, eta1, eta2 = get_chi(chi, F, G, g, eta1, eta2, div_u, ph, pw, inbox, s)
    err = torch.where(inbox, diff, zero).amax(dim=(-2, -1))
    return torch.stack([nu1, nu2, chi, *xi, eta1, eta2, v1, v2]), err


def occ_patch_loop_plain(st, wc, g, ph, pw, scal, max_iters: int):
    """Plain twin of K9's patch form: the tol-gated PD loop of one warp on B
    canvases, as JAX's vmapped ``while_loop``: a canvas runs while its err >
    tol^2 (err starts at +inf; a NaN err stops it) and its count <
    ``max_iters``, and keeps its state once it stops.  Returns (st,
    iterations (B,) int32)."""
    tol2 = scal[_S["tol2"]]
    b = st.shape[1]
    err = torch.full((b,), float("inf"), dtype=st.dtype, device=st.device)
    n = torch.zeros((b,), dtype=torch.int32, device=st.device)
    for _ in range(max_iters):
        run = (err > tol2) & (n < max_iters)
        if not bool(run.any()):
            break
        new, nerr = occ_pd_step(st, wc, g, ph, pw, scal)
        st = torch.where(run.view(1, -1, 1, 1), new, st)
        err = torch.where(run, nerr, err)
        n = torch.where(run, n + 1, n)
    return st, n


def _check_loop_args(st, wc, g, scal, shape, dev):
    kb.require_cuda_tensor(st, "state", torch.float32, dev,
                           (len(STATE),) + shape)
    kb.require_cuda_tensor(wc, "warp constants", torch.float32, dev,
                           (len(WARP_CONSTS),) + shape)
    kb.require_cuda_tensor(g, "g", torch.float32, dev, shape)
    kb.require_cuda_tensor(scal, "scalars", torch.float32, dev, (len(SCALARS),))


def occ_patch_loop(st, wc, g, ph, pw, scal, max_iters: int):
    """K9, patch form: one warp's whole tol-gated occlusion PD loop on B
    (P, P) canvases.  st (11, B, P, P) float32 (``STATE``), wc (8, B, P, P)
    (``WARP_CONSTS``), g (B, P, P), ph, pw (B,) int32 boxes, scal (14,)
    (``SCALARS``).  Returns (new st, iterations (B,) int32); the inputs are
    not changed.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise), one launch for the loop.  ``launches`` counts launches."""
    if st.dim() != 4 or st.shape[2] != st.shape[3]:
        raise ValueError(f"state must be (11, B, P, P), got {tuple(st.shape)}")
    nb, p = st.shape[1], st.shape[2]
    if p * p > 1024:
        raise ValueError(f"patch side {p}: the kernel takes P*P <= 1024")
    if st.device.type == "cpu":
        return occ_patch_loop_plain(st, wc, g, ph, pw, scal, max_iters)
    dev = st.device
    _check_loop_args(st, wc, g, scal, (nb, p, p), dev)
    for name, t in (("ph", ph), ("pw", pw)):
        kb.require_cuda_tensor(t, name, torch.int32, dev, (nb,))
    out = torch.empty_like(st)
    iters = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return out, iters
    code = kb.library().faldoi_occ_patch_loop(
        *(t.data_ptr() for t in (st, wc, g, ph, pw, scal, out, iters)), nb, p,
        int(max_iters), kb.stream_ptr(dev))
    kb.check(code, "occ_patch_loop")
    occ_patch_loop.launches += 1
    return out, iters


occ_patch_loop.launches = 0   # K9 patch-form launches, raised after a launch


def occ_global_loop_plain(st, wc, g, scal, max_iters: int):
    """Plain twin of K9's whole-image form: ``occ_patch_loop_plain`` on the
    image as one canvas with the box (h, w).  st (11, h, w), wc (8, h, w),
    g (h, w).  Returns (new st, iterations: a 0-d int32 tensor)."""
    h, w = g.shape
    box = (torch.tensor([h], dtype=torch.int32, device=g.device),
           torch.tensor([w], dtype=torch.int32, device=g.device))
    new, n = occ_patch_loop_plain(st[:, None], wc[:, None], g[None], *box, scal,
                                  max_iters)
    return new[:, 0], n[0]


@functools.lru_cache(maxsize=None)
def _plan(dev: int, h: int, w: int) -> tuple:
    out = (ctypes.c_longlong * 8)()
    kb.check(kb.library().faldoi_occ_global_loop_plan(h, w, out),
             "occ_global_loop plan")
    return tuple(out)


def global_plan(h: int, w: int) -> dict:
    """How K9's whole-image form tiles an h x w image on the current CUDA
    device: the scratch floats a call needs, tile rows and columns, tiles
    down and across, blocks, whether each block holds its tile for the whole
    launch (``resident``) and the shared bytes a block.  Planned once for
    each device and shape; the launch plans again in C, where it sets the
    kernel's shared memory and checks the scratch against this size."""
    keys = ("scratch", "th", "tw", "ty", "tx", "blocks", "resident", "smem")
    return dict(zip(keys, _plan(torch.cuda.current_device(), h, w)))


def _global_call(fn, st, wc, g, scal, max_iters, *extra):
    """Check the whole-image arguments, clone the state and call the C entry
    ``fn`` with a fresh scratch; returns (out, scratch, code)."""
    dev = st.device
    h, w = st.shape[1:]
    _check_loop_args(st, wc, g, scal, (h, w), dev)
    out = st.clone()
    n = global_plan(h, w)["scratch"] if h * w else 4
    scratch = torch.empty((n,), dtype=torch.float32, device=dev)
    code = fn(*(t.data_ptr() for t in (out, wc, g, scal, scratch)), n, h, w,
              int(max_iters), *extra)
    return out, scratch, code


def occ_global_loop(st, wc, g, scal, max_iters: int):
    """K9, whole-image form: one warp's whole tol-gated occlusion PD loop over
    an (h, w) image.  st (11, h, w) float32 (``STATE``), wc (8, h, w), g (h,
    w), scal (14,).  Returns (new st, iterations: a 0-d int32 tensor on the
    device); the loop runs while the largest squared update > tol^2 (it
    starts at +inf; a NaN stops it) and its count < ``max_iters``, its tol
    exit on the card.

    CPU tensors go to the plain twin; CUDA tensors make one cooperative
    launch (or raise).  ``launches`` counts launches."""
    if st.dim() != 3:
        raise ValueError(f"state must be (11, h, w), got {tuple(st.shape)}")
    if st.device.type == "cpu":
        return occ_global_loop_plain(st, wc, g, scal, max_iters)
    if st.shape[1] * st.shape[2] == 0:
        _check_loop_args(st, wc, g, scal, tuple(st.shape[1:]), st.device)
        return st.clone(), torch.zeros((), dtype=torch.int32, device=st.device)
    out, scratch, code = _global_call(kb.library().faldoi_occ_global_loop, st,
                                      wc, g, scal, max_iters,
                                      kb.stream_ptr(st.device))
    kb.check(code, "occ_global_loop")
    occ_global_loop.launches += 1
    return out, scratch[3:4].view(torch.int32)[0].clone()


occ_global_loop.launches = 0   # K9 whole-image launches, raised after a launch


def occ_global_loop_kernels(st, wc, g, scal, max_iters: int = 1) -> int:
    """The kernel launches that one ``occ_global_loop`` call on these CUDA
    tensors enqueues, counted as the kernel nodes of a CUDA graph captured
    from one call (the graph is never run; ``launches`` is not raised)."""
    if st.device.type != "cuda":
        raise ValueError("occ_global_loop_kernels counts launches on a CUDA "
                         "device; got a tensor on " + st.device.type)
    n = ctypes.c_int(0)
    _, _, code = _global_call(kb.library().faldoi_occ_global_loop_kernels, st,
                              wc, g, scal, max_iters, ctypes.addressof(n))
    kb.check(code, "occ_global_loop_kernels")
    return n.value


def warp_constants(i0, w1, w_1, u1, u2):
    """The per-warp constants (``WARP_CONSTS``, stacked on a new leading
    axis) from the warped (I1, I1x, I1y) ``w1`` at u and (I-1, I-1x, I-1y)
    ``w_1`` at -u (tvl2_model_occ.cpp:556-575)."""
    i1w, i1wx, i1wy = w1
    i_1w, i_1wx, i_1wy = w_1
    return torch.stack([
        i1wx, i1wy, i_1wx, i_1wy, i1wx * i1wx + i1wy * i1wy,
        i_1wx * i_1wx + i_1wy * i_1wy, i1w - i1wx * u1 - i1wy * u2 - i0,
        i_1w - i_1wx * u1 - i_1wy * u2 - i0]).contiguous()


def solve_occ_canvas(i0_patch, stack1, stack_1, g_patch, oy, ox, ph, pw, u1, u2,
                     chi, scal, warps: int, max_iters: int):
    """``guided_tvl2coupled_occ`` on B canvases: i0_patch, g_patch (B, P,
    P) crops of I0 and g; stack1, stack_1 the (3, h, w) stacks (I1, I1x, I1y)
    and (I-1, I-1x, I-1y); oy, ox, ph, pw (B,) int32 boxes; u1, u2, chi (B,
    P, P) init canvases; scal from ``local_scalars``.  Each warp samples both
    stacks by K4's patch form (at u and at -u) and runs K9's patch form.
    Returns (u1, u2, chi, ener): canvases zero outside the box, and the (B,)
    energies of ``eval_tvl2coupled_occ`` (:177-304)."""
    s = _Scal(scal)
    dev = u1.device
    inbox = _box(ph, pw, u1)
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    box = (oy, ox, ph, pw)
    z = torch.zeros_like(u1)
    st = torch.stack([u1, u2, chi, z, z, z, z, z, z, u1, u2])
    for _ in range(warps):
        u1, u2 = st[0], st[1]
        w1 = bicubic_sample_patches(stack1, *box, u1, u2, 3).unbind(0)
        w_1 = bicubic_sample_patches(stack_1, *box, -u1, -u2, 3).unbind(0)
        wc = warp_constants(i0_patch, w1, w_1, u1, u2)
        st, _ = occ_patch_loop(st, wc, g_patch, ph, pw, scal, max_iters)

    # eval (:177-304), on canvases zeroed outside the box (every read of
    # the energy is in the box: the stencils, the warps, the sum)
    u1, u2, chi, v1, v2 = (torch.where(inbox, st[k], zero).contiguous()
                           for k in (0, 1, 2, 9, 10))
    u1x, u1y = forward_gradient_patch(u1, ph, pw)
    u2x, u2y = forward_gradient_patch(u2, ph, pw)
    chix, chiy = forward_gradient_patch(chi, ph, pw)
    div_u = divergence_patch(u1, u2, ph, pw)
    i1w, i1wx, i1wy = bicubic_sample_patches(stack1, *box, u1, u2, 3).unbind(0)
    i_1w, i_1wx, i_1wy = bicubic_sample_patches(stack_1, *box, -u1, -u2,
                                                3).unbind(0)
    one = torch.ones((), dtype=u1.dtype, device=dev)
    diff_uv = (one / (2 * s.theta)) * ((u1 - v1) * (u1 - v1) + (u2 - v2) * (u2 - v2))
    norm_v = s.alpha_2 * chi * (v1 * v1 + v2 * v2)
    div_u_t = s.beta * chi * div_u
    rho_1 = (i1w - i1wx * u1 - i1wy * u2 - i0_patch + i1wx * v1 + i1wy * v2).abs()
    rho__1 = (i_1w - i_1wx * u1 - i_1wy * u2 - i0_patch + i_1wx * v1
              + i_1wy * v2).abs()
    data = s.lam * ((one - chi) * rho_1 + chi * rho__1)
    smooth = g_patch * (sqrt_rn(u1x * u1x + u1y * u1y)
                        + sqrt_rn(u2x * u2x + u2y * u2y)
                        + s.mu * sqrt_rn(chix * chix + chiy * chiy))
    ener = canvas_sum(torch.where(inbox, data + smooth + div_u_t + norm_v + diff_uv,
                                  zero)) / (ph * pw).to(u1.dtype)
    return u1, u2, chi, ener


def tvl2_occ_global(i0n, i1n, i_1n, u1, u2, occ_init, prm: P.Parameters,
                    stats=None):
    """The global step of method 8 (global_faldoi.cpp:2161-2165): i0n, i1n,
    i_1n the normalised, smoothed frames I0, I1, I-1 (h, w); u1, u2 the
    initial flow; ``occ_init`` an (h, w) array (the input occlusion mask) or
    None (chi starts at 0).  ``prm`` gives lambda, theta, the occlusion
    parameters, tol_OF, the warps and the PD cap ``iterations_of``.  Each
    warp samples both stacks by K4's flow form (at u and at -u,
    ``border_out=False``) and runs K9's whole-image form, one call a warp,
    until its err <= tol^2 or ``iterations_of`` iterations, the tol exit on
    the card.  Returns (u1, u2, chi); JAX's energy is discarded, so it is
    not computed.

    ``stats`` (a dict, optional) receives the PD iterations of every warp
    (``global_iters``), each read from the device after the last warp."""
    dev = i0n.device
    h, w = i0n.shape
    scal = global_scalars(prm, dev)
    i1x, i1y = centered_gradient(i1n)
    i_1x, i_1y = centered_gradient(i_1n)
    i0x, i0y = centered_gradient(i0n)
    g = init_weight(i0x, i0y).contiguous()
    stack1 = torch.stack([i1n, i1x, i1y]).contiguous()
    stack_1 = torch.stack([i_1n, i_1x, i_1y]).contiguous()
    chi = (torch.zeros_like(u1) if occ_init is None else torch.as_tensor(
        np.asarray(occ_init, np.float32), device=dev))
    z = torch.zeros_like(u1)
    st = torch.stack([u1, u2, chi, z, z, z, z, z, z, u1, u2]).contiguous()
    iters = []
    for _ in range(prm.warps):
        u1, u2 = st[0], st[1]
        w1 = bicubic_warp_planes(stack1, u1, u2, False).unbind(0)
        w_1 = bicubic_warp_planes(stack_1, -u1, -u2, False).unbind(0)
        wc = warp_constants(i0n, w1, w_1, u1, u2)
        st, n = occ_global_loop(st, wc, g, scal, prm.iterations_of)
        iters.append(n)
    if stats is not None:
        stats["global_iters"] = [int(n) for n in iters]
    return st[0], st[1], st[2]

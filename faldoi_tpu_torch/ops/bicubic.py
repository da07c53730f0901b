"""Bicubic (Catmull-Rom-style) sampling with the reference's exact C
semantics — kernel K4 and its plain twin.

Port of ``faldoi_tpu/ops/bicubic.py::bicubic_interp_at`` (``src/
bicubic_interpolation.c:146-163``):

* integer positions by C ``(int)`` casts (truncation toward zero),
* the 4x4 stencil laid out with sign steps ``sx = sign(uu)``, ``sy =
  sign(vv)``, including the quirk that the row stencil's ``my`` uses ``sx``
  (bicubic_interpolation.c:159),
* Neumann clamping with an out-of-domain flag; ``border_out=True`` returns 0
  there, ``border_out=False`` extrapolates with the clamped stencil,
* fractions ``uu - x_clamped``.

Each sample reads one 4x4 window; the basis coefficient of every stencil
element is accumulated onto its clamped window offset first (as the JAX
functions do), then the window is contracted over rows and then over columns
with fused multiply-adds: the order and rounding of XLA's CPU dot in the
one-hot contractions of ``bicubic_window_sample``, which is what the JAX main
path samples with (measured bit-identical given the same weights).  The port
samples every point exactly: it does not carry over the JAX package's
windowed one-hot forms (``bicubic_window_sample*``, the tiled
``bicubic_warp_stack``), which clamp samples beyond their window.

K4 (``csrc/bicubic.cu``) has three forms, one thread per sample point each,
the weights shared across the C planes, bound by the 16 scattered 4-byte
reads per point and plane (each a 32-byte sector), which neighbouring
threads mostly share through L1/L2:

* ``bicubic_sample``, the point form, at given points;
* ``bicubic_warp_planes``, the flow form for the whole-image warps (global
  step, FB check, uniformity test): it takes the flow where it lies and
  forms the points ``(j + u, i + v)`` in the kernel, a 16 x 16 pixel tile a
  block, so a warp is one launch with no glue ops before it;
* ``bicubic_sample_patches``, the patch form for the patch solver: the
  caller passes the patch boxes and flow canvases, not points, and each
  thread forms its cell's point as the solver did (``cell + flow`` inside
  the valid box).  With a per-patch ``lane`` index it samples a stack of L
  lanes' frames (pairs mode: one launch for the 2N growing lanes), each
  patch clamped at its own lane's edge.
"""

from __future__ import annotations

from typing import Optional

import torch

from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.stencils import canvas_ids


def _basis(t):
    """Catmull-Rom basis over the stencil order [m, 0, d, dd]
    (cubic_interpolation_cell, bicubic_interpolation.c:103-111)."""
    t2 = t * t
    t3 = t2 * t
    a0 = 0.5 * (-t + 2.0 * t2 - t3)
    a1 = 1.0 - 2.5 * t2 + 1.5 * t3
    a2 = 0.5 * (t + 4.0 * t2 - 3.0 * t3)
    a3 = 0.5 * (t3 - t2)
    return a0, a1, a2, a3


def _fma(a, b, c):
    """Fused multiply-add a*b + c rounded once to float32 (the float64 product
    of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _trunc(x):
    """C ``(int)`` cast (NaN -> 0, saturated at +-1e9 so later index
    arithmetic never overflows; such samples are far out of any image)."""
    return torch.nan_to_num(x, nan=0.0).clamp(-1e9, 1e9).to(torch.int64)


def _window_weights(elems, start, n, origin):
    """Accumulate the basis coefficients of the 4 (clamped) stencil elements
    onto their offsets in the 4-window at ``start``.  Returns (weights, out)."""
    out = torch.zeros(origin.shape, dtype=torch.bool, device=origin.device)
    cl = []
    for p in elems:
        out = out | (p < 0) | (p >= n)
        cl.append(p.clamp(0, n - 1))
    if start is None:
        start = torch.minimum(torch.minimum(cl[0], cl[1]),
                              torch.minimum(cl[2], cl[3])).clamp(0, max(n - 4, 0))
    else:
        start = start.clamp(0, max(n - 4, 0))
    a = _basis(origin - cl[1].to(origin.dtype))
    zero = torch.zeros((), dtype=origin.dtype, device=origin.device)
    w = [torch.zeros_like(origin) for _ in range(4)]
    for ai, pi in zip(a, cl):
        rel = (pi - start).clamp(0, 3)
        for k in range(4):
            w[k] = w[k] + torch.where(rel == k, ai, zero)
    return start, w, out


def _sample_weights(ny: int, nx: int, uu, vv):
    """Window starts (wy, wx), per-axis window weights and the out flag."""
    sx = torch.where(uu < 0, -1, 1).to(torch.int64)
    sy = torch.where(vv < 0, -1, 1).to(torch.int64)
    iu = _trunc(uu)
    iv = _trunc(vv)
    wx, wxs, ox = _window_weights(
        [iu - sx, iu, iu + sx, iu + 2 * sx],
        torch.where(sx > 0, iu - 1, iu - 2), nx, uu)
    # sic: the row stencil's 'm' element steps by sx (bicubic_interpolation.c:159)
    wy, wys, oy = _window_weights(
        [iv - sx, iv, iv + sy, iv + 2 * sy], None, ny, vv)
    return wy, wx, wys, wxs, ox | oy


def bicubic_sample_plain(planes: torch.Tensor, uu: torch.Tensor,
                         vv: torch.Tensor, border_out: bool,
                         lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch twin of K4: sample the (C, H, W) ``planes`` at (x=uu,
    y=vv) of any shape; returns (C, *uu.shape).  With ``lane`` (the shape of
    uu), ``planes`` is (L, C, H, W) and each point samples its lane's."""
    c, ny, nx = planes.shape[-3:]
    shape = uu.shape
    uu = uu.reshape(-1)
    vv = vv.reshape(-1)
    wy, wx, wys, wxs, out = _sample_weights(ny, nx, uu, vv)
    r = torch.zeros((c, uu.shape[0]), dtype=planes.dtype, device=planes.device)
    base = wy * nx + wx
    if lane is None:
        flat = planes.reshape(c, ny * nx)
    else:
        # the lanes side by side along the flat axis, a lane's base shifted
        flat = planes.transpose(0, 1).reshape(c, -1)
        base = base + lane.reshape(-1).to(torch.int64) * (ny * nx)
    for l in range(4):
        col = torch.zeros_like(r)
        for k in range(4):
            col = _fma(wys[k], flat[:, base + k * nx + l], col)
        r = _fma(col, wxs[l], r)
    if border_out:
        r = torch.where(out, torch.zeros((), dtype=r.dtype, device=r.device), r)
    return r.reshape((c,) + tuple(shape))


def bicubic_sample(planes: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor,
                   border_out: bool) -> torch.Tensor:
    """K4, point form: bicubic samples of the (C, H, W) ``planes`` at (uu, vv).

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise).  Replaces the XLA-lowered ``faldoi_tpu.ops.bicubic.
    bicubic_interp_at`` / ``bicubic_window_sample*`` / ``bicubic_warp_stack``.
    """
    if planes.dim() != 3:
        raise ValueError(f"planes must be (C, H, W), got {tuple(planes.shape)}")
    if uu.shape != vv.shape:
        raise ValueError(f"uu {tuple(uu.shape)} and vv {tuple(vv.shape)} differ")
    c, ny, nx = planes.shape
    if ny < 4 or nx < 4:
        raise ValueError("bicubic sampling needs an image of at least 4x4")
    if planes.device.type == "cpu":
        return bicubic_sample_plain(planes, uu, vv, border_out)
    kb.require_cuda_tensor(planes, "planes", torch.float32)
    kb.require_cuda_tensor(uu, "uu", torch.float32, planes.device)
    kb.require_cuda_tensor(vv, "vv", torch.float32, planes.device)
    out = torch.empty((c,) + tuple(uu.shape), dtype=torch.float32,
                      device=planes.device)
    npts = uu.numel()
    if npts == 0:
        return out
    code = kb.library().faldoi_bicubic_sample(
        planes.data_ptr(), uu.data_ptr(), vv.data_ptr(), out.data_ptr(),
        c, ny, nx, npts, int(bool(border_out)), kb.stream_ptr(planes.device))
    kb.check(code, "bicubic_sample")
    bicubic_sample.launches += 1
    return out


bicubic_sample.launches = 0   # launches of K4's point form, raised after a launch


def _patch_points(oy, ox, ph, pw, u1, u2):
    """The patch solver's sample points: cell (ox + col, oy + row) plus the
    flow inside the valid box [0, ph) x [0, pw), the bare cell outside it."""
    rows, cols = canvas_ids(u1.shape[-1], u1.device)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=u1.device)
    gx = (ox[:, None, None] + cols).to(u1.dtype)
    gy = (oy[:, None, None] + rows).to(u1.dtype)
    return gx + torch.where(inbox, u1, zero), gy + torch.where(inbox, u2, zero)


def bicubic_sample_patches_plain(stack, oy, ox, ph, pw, u1, u2,
                                 nplanes: int, lane=None) -> torch.Tensor:
    """Plain twin of K4's patch form: the first ``nplanes`` planes of
    ``stack`` sampled at the patch points, ``border_out=False``; with
    ``lane``, patch k from lane lane[k] of the (L, C, H, W) stack."""
    uu, vv = _patch_points(oy, ox, ph, pw, u1, u2)
    if lane is None:
        return bicubic_sample_plain(stack[:nplanes], uu, vv, False)
    return bicubic_sample_plain(stack[:, :nplanes], uu, vv, False,
                                lane[:, None, None].expand(uu.shape))


def bicubic_sample_patches(stack: torch.Tensor, oy: torch.Tensor,
                           ox: torch.Tensor, ph: torch.Tensor, pw: torch.Tensor,
                           u1: torch.Tensor, u2: torch.Tensor,
                           nplanes: int,
                           lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4, patch form: sample the first ``nplanes`` planes of the
    (C, H, W) ``stack`` at the points of B patch canvases — cell (ox + col,
    oy + row) plus (u1, u2) inside the valid box [0, ph) x [0, pw), the bare
    cell outside it — with ``border_out=False``.  oy, ox, ph, pw: (B,) int32;
    u1, u2: (B, P, P) float32.  Returns (nplanes, B, P, P).  With ``lane``
    ((B,) int32), ``stack`` is (L, C, H, W) and patch k samples lane lane[k]
    (0 <= lane[k] < L, unchecked on the card), clamped at that lane's edge.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise).  Replaces the solver's ``_warp3``/``_warp1`` windowed samples of
    ``faldoi_tpu/core/functionals.py``."""
    if stack.dim() != (3 if lane is None else 4):
        raise ValueError(f"stack must be {'(' if lane is None else '(L, '}"
                         f"C, H, W), got {tuple(stack.shape)}")
    c, ny, nx = stack.shape[-3:]
    if ny < 4 or nx < 4:
        raise ValueError("bicubic sampling needs an image of at least 4x4")
    if not 1 <= nplanes <= c:
        raise ValueError(f"nplanes {nplanes} must lie in [1, {c}]")
    if u1.dim() != 3 or u1.shape[1] != u1.shape[2] or u2.shape != u1.shape:
        raise ValueError(f"u1 {tuple(u1.shape)} and u2 {tuple(u2.shape)} must "
                         "be one (B, P, P) shape")
    b, p = u1.shape[0], u1.shape[1]
    named = [("oy", oy), ("ox", ox), ("ph", ph), ("pw", pw)]
    if lane is not None:
        named.append(("lane", lane))
    for name, t in named:
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected ({b},)")
    if stack.device.type == "cpu":
        return bicubic_sample_patches_plain(stack, oy, ox, ph, pw, u1, u2,
                                            nplanes, lane)
    kb.require_cuda_tensor(stack, "stack", torch.float32)
    for name, t in named:
        kb.require_cuda_tensor(t, name, torch.int32, stack.device)
    kb.require_cuda_tensor(u1, "u1", torch.float32, stack.device)
    kb.require_cuda_tensor(u2, "u2", torch.float32, stack.device)
    out = torch.empty((nplanes, b, p, p), dtype=torch.float32,
                      device=stack.device)
    if b == 0:
        return out
    code = kb.library().faldoi_bicubic_sample_patches(
        stack.data_ptr(), oy.data_ptr(), ox.data_ptr(), ph.data_ptr(),
        pw.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        None if lane is None else lane.data_ptr(),
        0 if lane is None else c * ny * nx, out.data_ptr(), nplanes,
        ny, nx, b, p, kb.stream_ptr(stack.device))
    kb.check(code, "bicubic_sample_patches")
    bicubic_sample_patches.launches += 1
    bicubic_sample_patches.launches_lane += lane is not None
    return out


bicubic_sample_patches.launches = 0   # launches of K4's patch form
bicubic_sample_patches.launches_lane = 0   # those of them with a lane index


def bicubic_interp_at(img: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor,
                      border_out: bool) -> torch.Tensor:
    """Sample the (h, w) ``img`` at positions (x=uu, y=vv)."""
    return bicubic_sample(img[None].contiguous(), uu, vv, border_out)[0]


def warp_coords(u: torch.Tensor, v: torch.Tensor):
    """Absolute sample coordinates (j + u, i + v) of a whole-image warp."""
    ny, nx = u.shape
    jj = torch.arange(nx, dtype=u.dtype, device=u.device)[None, :]
    ii = torch.arange(ny, dtype=u.dtype, device=u.device)[:, None]
    return (jj + u).contiguous(), (ii + v).contiguous()


def bicubic_warp_planes_plain(planes: torch.Tensor, u: torch.Tensor,
                              v: torch.Tensor, border_out: bool) -> torch.Tensor:
    """Plain twin of K4's flow form: the points of ``warp_coords`` sampled
    by the point form's twin."""
    return bicubic_sample_plain(planes, *warp_coords(u, v), border_out)


def bicubic_warp_planes(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        border_out: bool) -> torch.Tensor:
    """K4, flow form: warp the (C, H, W) ``planes`` by the (H, W) flow,
    out[c, i, j] = planes[c](j + u[i, j], i + v[i, j]); returns (C, H, W),
    contiguous.  u and v are read where they lie (any strides).

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if planes.dim() != 3:
        raise ValueError(f"planes must be (C, H, W), got {tuple(planes.shape)}")
    c, ny, nx = planes.shape
    if tuple(u.shape) != (ny, nx) or tuple(v.shape) != (ny, nx):
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} must be "
                         f"({ny}, {nx}) like the planes")
    if ny < 4 or nx < 4:
        raise ValueError("bicubic sampling needs an image of at least 4x4")
    if planes.device.type == "cpu":
        return bicubic_warp_planes_plain(planes, u, v, border_out)
    kb.require_cuda_tensor(planes, "planes", torch.float32)
    for name, t in (("u", u), ("v", v)):
        if t.device != planes.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"float32 on {planes.device}")
    out = torch.empty_like(planes)
    if c == 0:
        return out
    code = kb.library().faldoi_bicubic_warp_planes(
        planes.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), c, ny,
        nx, *u.stride(), *v.stride(), int(bool(border_out)),
        kb.stream_ptr(planes.device))
    kb.check(code, "bicubic_warp_planes")
    bicubic_warp_planes.launches += 1
    return out


bicubic_warp_planes.launches = 0   # launches of K4's flow form


def bicubic_warp_stack(planes: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       border_out: bool) -> torch.Tensor:
    """Warp (C, ny, nx) planes by one flow: out[c, i, j] = planes[c](j+u, i+v)
    (bicubic_interpolation.c:245-266), every point sampled exactly."""
    return bicubic_warp_planes(planes.contiguous(), u, v, border_out)


def bicubic_warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 border_out: bool) -> torch.Tensor:
    """Warp one (h, w) image by the flow (u, v)."""
    return bicubic_warp_stack(img[None], u, v, border_out)[0]

"""Batched patch crop — kernel K0 in its two forms, and their plain twins.

Counterpart of ``faldoi_tpu/ops/pallas_sweep.py::_pallas_gather_patches``,
the repo's one Pallas kernel: B copies of (p, p, C) windows at (oy[k], ox[k])
from an edge-padded (H', W', C) stack into a (p, p, C, B) block.  Mosaic
rejected it (minor-dim DMAs must be 128-aligned), so the JAX sweep crops with
a vmapped ``lax.dynamic_slice`` (``_xla_gather_patches``).  The port puts the
kernel where the JAX package could not, in two forms
(``csrc/patch_gather.cu``):

* the **stack form** ``gather_patches``, the Pallas kernel's signature:
  (H', W', C) -> (p, p, C, B).  It crops the patch solver's source frame
  (C = 1, from ``SolverConsts.i0pad``; p = 11 in the sweep, p = 3 in the seed
  insertion).  A warp's threads are 32 lanes, so its stores are contiguous;
  a thread copies a whole window row, so its sectors are reused through L1.
* the **planes form** ``gather_plane_patches``, the sweep's state crop
  (``faldoi_tpu/core/local_step.py:564-577``: ``jnp.stack``, ``jnp.pad(mode=
  "edge")``, ``dynamic_slice``): it reads the C state planes where they lie,
  clamps to the last row and column instead of padding, and returns
  (C, B, p, p), lane-major, so each plane's canvases are one contiguous
  (B, p, p) block and no stack, pad or permute is dispatched.  It also
  crops the NLTV solver's 24 weight planes (``SolverConsts.wp_pad``,
  zero-padded to (h + P, w + P)) into (24, B, p, p).

Semantics are ``lax.dynamic_slice``'s on the padded array in both forms: a
negative start counts from the padded end (``allow_negative_indices``), then
the start is clamped so the window fits, so lanes at the dump index (whose
geometry points below the image) crop in bounds and harmlessly.  Both are
pure copies, so each kernel equals its twin bit for bit.  Both are bound by
device-memory traffic and launch latency.

Both forms take an optional per-window ``lane`` index (pairs mode: the
2N growing lanes of N frame pairs, one launch for all): the sources then
carry a leading lane axis, window k reads lane ``lane[k]`` and clamps at
that lane's edge, never reading another lane (which is why the lanes are
not stacked as one tall image: its edge pad would read the next lane's
rows).  ``lane=None`` is the one-image call.

``gather_patches.launches`` and ``gather_plane_patches.launches`` count the
launches of the two kernels (one for a whole lane batch), and their
``launches_lane`` those of them with a lane index;
``gather_plane_patches.launches_by_planes`` splits the planes form's by the
number of planes (5: the state crop, 24: the NLTV weights).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from faldoi_tpu_torch.kernels import build as kb

MAX_PLANES = 24    # kMaxPlanes of csrc/patch_gather.cu


def pad_for_crops(img: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-pad an (h, w, ...) array bottom/right by p
    (``patch_solver.pad_for_crops``)."""
    h, w = img.shape[:2]
    rows = torch.arange(h + p, device=img.device).clamp(max=h - 1)
    cols = torch.arange(w + p, device=img.device).clamp(max=w - 1)
    return img.index_select(0, rows).index_select(1, cols).contiguous()


def gather_patches_plain(stack: torch.Tensor, oy: torch.Tensor,
                         ox: torch.Tensor, p: int,
                         lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of K0's stack form: (H', W', C), (B,), (B,) -> (p, p, C, B);
    with ``lane``, an (L, H', W', C) stack and window k from lane lane[k]."""
    hp, wp, _ = stack.shape[-3:]
    ar = torch.arange(p, device=stack.device)
    oy, ox = oy.to(torch.int64), ox.to(torch.int64)
    oyc = torch.where(oy < 0, oy + hp, oy).clamp(0, hp - p)
    oxc = torch.where(ox < 0, ox + wp, ox).clamp(0, wp - p)
    rows = oyc[:, None] + ar[None, :]                     # (B, p)
    cols = oxc[:, None] + ar[None, :]
    if lane is None:
        out = stack[rows[:, :, None], cols[:, None, :], :]    # (B, p, p, C)
    else:
        out = stack[lane.to(torch.int64)[:, None, None], rows[:, :, None],
                    cols[:, None, :], :]
    return out.permute(1, 2, 3, 0).contiguous()


def _check_lane(lane, b: int, dtype, device):
    if tuple(lane.shape) != (b,):
        raise ValueError(f"lane: shape {tuple(lane.shape)}, expected ({b},)")
    if device.type == "cuda":
        kb.require_cuda_tensor(lane, "lane", dtype, device)


def gather_patches(stack: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   p: int, lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K0, stack form: (H', W', C) float32, (B,) int32 origins -> (p, p, C, B)
    crops.  With ``lane`` ((B,) int32), ``stack`` is (L, H', W', C) and
    window k is cut from lane lane[k] (0 <= lane[k] < L, unchecked on the
    card).

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if stack.dim() != (3 if lane is None else 4):
        raise ValueError(f"stack must be {'(' if lane is None else '(L, '}"
                         f"H', W', C), got {tuple(stack.shape)}")
    hp, wp, c = stack.shape[-3:]
    if p > hp or p > wp:
        raise ValueError(f"patch {p} larger than the stack {hp}x{wp}")
    if oy.shape != ox.shape or oy.dim() != 1:
        raise ValueError("oy and ox must be (B,) vectors of one length")
    b = oy.shape[0]
    if lane is not None:
        _check_lane(lane, b, torch.int32, stack.device)
    if stack.device.type == "cpu":
        return gather_patches_plain(stack, oy, ox, p, lane)
    kb.require_cuda_tensor(stack, "stack", torch.float32)
    kb.require_cuda_tensor(oy, "oy", torch.int32, stack.device)
    kb.require_cuda_tensor(ox, "ox", torch.int32, stack.device)
    out = torch.empty((p, p, c, b), dtype=torch.float32, device=stack.device)
    if out.numel() == 0:
        return out
    code = kb.library().faldoi_gather_patches(
        stack.data_ptr(), oy.data_ptr(), ox.data_ptr(),
        None if lane is None else lane.data_ptr(), out.data_ptr(),
        hp, wp, c, b, p, kb.stream_ptr(stack.device))
    kb.check(code, "gather_patches")
    gather_patches.launches += 1
    gather_patches.launches_lane += lane is not None
    return out


gather_patches.launches = 0   # stack-form launches, raised only after a launch
gather_patches.launches_lane = 0   # those of them with a lane index


def _check_planes(planes, h: int, w: int, lanes: Optional[int] = None):
    """Validate the planes form's planes: each h*w (or h*w + 1) elements,
    contiguous; with ``lanes``, each (L, ...) with every lane's h*w (or h*w +
    1) elements contiguous, lane strides free."""
    planes = tuple(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, got {len(planes)}")
    for c, pl in enumerate(planes):
        one = pl if lanes is None else pl[0]
        if lanes is not None and (pl.dim() < 2 or pl.shape[0] != lanes):
            raise ValueError(f"plane {c}: shape {tuple(pl.shape)}, expected a "
                             f"leading lane axis of {lanes}")
        if one.numel() not in (h * w, h * w + 1):
            raise ValueError(f"plane {c}: {one.numel()} elements a lane, "
                             f"expected {h}*{w} (or one more, the dump slot)")
        if pl.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"plane {c}: dtype {pl.dtype}, expected "
                            "torch.float32 or torch.int32")
        if pl.device != planes[0].device:
            raise ValueError(f"plane {c}: on {pl.device}, expected "
                             f"{planes[0].device}")
        if not one.is_contiguous():
            raise ValueError(f"plane {c}: tensor must be contiguous"
                             + ("" if lanes is None else " within a lane"))
    return planes


def gather_plane_patches_plain(planes, oy: torch.Tensor, ox: torch.Tensor,
                               p: int, h: int, w: int,
                               lane: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain twin of K0's planes form, the composition the kernel replaces:
    stack the planes' (h, w) images, edge-pad by p, crop with the stack
    form's twin; (C, B, p, p).  With ``lane``, each plane is (L, ...) and the
    images of every lane are stacked and padded alike."""
    if lane is None:
        stack = torch.stack([pl.reshape(-1)[:h * w].view(h, w).to(torch.float32)
                             for pl in planes], dim=-1)
        out = gather_patches_plain(pad_for_crops(stack, p), oy, ox, p)
    else:
        nl = planes[0].shape[0]
        stack = torch.stack([pl.reshape(nl, -1)[:, :h * w].reshape(nl, h, w)
                             .to(torch.float32) for pl in planes], dim=-1)
        rows = torch.arange(h + p, device=stack.device).clamp(max=h - 1)
        cols = torch.arange(w + p, device=stack.device).clamp(max=w - 1)
        stack = stack.index_select(1, rows).index_select(2, cols)
        out = gather_patches_plain(stack, oy, ox, p, lane)
    return out.permute(2, 3, 0, 1).contiguous()


def gather_plane_patches(planes, oy: torch.Tensor, ox: torch.Tensor, p: int,
                         h: int, w: int,
                         lane: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K0, planes form: C planes of one (h, w) image each -> (C, B, p, p).

    ``planes``: 1 to 24 contiguous float32 or int32 tensors of h*w elements
    (or h*w + 1: the sweep's flat state planes with their dump slot, which
    is never read); ``oy``, ``ox``: (B,) int64 window origins.  Cell (r, c)
    of lane k is ``plane[min(y0 + r, h - 1), min(x0 + c, w - 1)]`` with
    (y0, x0) the start ``dynamic_slice`` takes on the plane edge-padded to
    (h + p, w + p); an int32 plane comes out as float32.  ``out[c]`` is
    plane c's contiguous (B, p, p) canvases.

    ``lane`` ((B,) int64): every plane is (L, ...), one image a lane (each
    lane's h*w or h*w + 1 elements contiguous; the lane stride is the
    plane's own, so a plane may be a slice such as ``wp_pad[:, c]``), and
    window k is cut from lane lane[k] (0 <= lane[k] < L, unchecked on the
    card), clamped at that lane's edge.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if oy.shape != ox.shape or oy.dim() != 1:
        raise ValueError("oy and ox must be (B,) vectors of one length")
    planes = tuple(planes)
    nl = None if lane is None else (planes[0].shape[0] if planes else 0)
    planes = _check_planes(planes, h, w, nl)
    if p < 1 or h < 1 or w < 1 or h * w >= 2 ** 31:
        raise ValueError(f"bad geometry: p {p}, image {h}x{w}")
    dev = planes[0].device
    b = oy.shape[0]
    if lane is not None:
        _check_lane(lane, b, torch.int64, dev)
    if dev.type == "cpu":
        return gather_plane_patches_plain(planes, oy, ox, p, h, w, lane)
    if dev.type != "cuda":
        raise ValueError(f"planes: expected CUDA tensors, got {dev}")
    kb.require_cuda_tensor(oy, "oy", torch.int64, dev)
    kb.require_cuda_tensor(ox, "ox", torch.int64, dev)
    if b * p * p > 2 ** 31 - 4096:
        raise ValueError(f"{b} windows of {p}x{p} exceed the kernel's 32-bit "
                         "cell index")
    out = torch.empty((len(planes), b, p, p), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    ptrs = (ctypes.c_void_p * len(planes))(*(pl.data_ptr() for pl in planes))
    strides = (None if lane is None else
               (ctypes.c_longlong * len(planes))(*(pl.stride(0) for pl in planes)))
    int_mask = sum(1 << c for c, pl in enumerate(planes)
                   if pl.dtype == torch.int32)
    code = kb.library().faldoi_gather_plane_patches(
        ptrs, strides, len(planes), int_mask, oy.data_ptr(), ox.data_ptr(),
        None if lane is None else lane.data_ptr(), out.data_ptr(), h, w, b, p,
        kb.stream_ptr(dev))
    kb.check(code, "gather_plane_patches")
    gather_plane_patches.launches += 1
    gather_plane_patches.launches_lane += lane is not None
    gather_plane_patches.launches_by_planes[len(planes)] += 1
    return out


gather_plane_patches.launches = 0   # planes-form launches
gather_plane_patches.launches_lane = 0   # those of them with a lane index
gather_plane_patches.launches_by_planes = Counter()   # the same, by plane count

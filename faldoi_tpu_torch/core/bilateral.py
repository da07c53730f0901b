"""Bilateral pre-fill of the untrusted working flow — kernel K11 and its
plain twin.

Port of ``faldoi_tpu/core/bilateral.py::bilateral_filter_flow`` (the
reference's dormant ``bilateral_filter`` hook, local_faldoi.cpp:380-482,
701-702), which ``match_growing(bilateral=True)`` runs after each prune and
requeue: ``ITER_BILATERAL_FILTER`` Jacobi iterations of a range-and-space
weighted average at the pixels that are neither trusted nor fixed, seeded
with the kept flow and 0 elsewhere.

The 25 taps are JAX's, including what its shift does: ``_shift(a, dy, dx)``
returns a[y - dy, x] with zero padding (the column offset drops out), while
the ``_inside`` factor of the weight tests (y + dy, x + dx).  The port
follows JAX there.

The weights hold ``exp``, which XLA, PyTorch's CPU and CUDA's ``expf`` do
not round alike.  So the 6 distinct spatial constants are frozen from JAX
(``SPATIAL``), and the colour factor, which depends on the tap's row
offset alone, is computed once a call on the host as 5 planes
(``bilateral_colour_planes``: float32 arithmetic, the exponential in
float64 rounded once to float32).  A tap's weight is SPATIAL[d2] * (colour
* inside), two float32 products: ``bilateral_weights`` forms the 25 planes
the twin reads, and the kernel forms the same values from the 5 planes
itself.
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.params import (
    ITER_BILATERAL_FILTER, PATCH_BILATERAL_FILTER, SIGMA_BILATERAL_COLOR,
)

# the taps (dy, dx) in JAX's order, dy outer
SHIFTS = tuple((dy, dx) for dy in range(-PATCH_BILATERAL_FILTER,
                                        PATCH_BILATERAL_FILTER + 1)
               for dx in range(-PATCH_BILATERAL_FILTER,
                               PATCH_BILATERAL_FILTER + 1))
# the row offsets dy of the taps, one colour plane each
ROWS = tuple(range(-PATCH_BILATERAL_FILTER, PATCH_BILATERAL_FILTER + 1))
# squared tap distance -> JAX's jnp.float32(jnp.exp(-0.5 d2 /
# SIGMA_BILATERAL_DIST ** 2)), frozen (each value is a float32)
SPATIAL = {0: 1.0, 1: 0.9692332148551941, 2: 0.9394130706787109,
           4: 0.8824968934059143, 5: 0.8553453087806702,
           8: 0.7788007855415344}


def _row_shift(a, dy: int):
    """a[..., y - dy, :] with zero padding: JAX's ``_shift(a, dy, dx)``."""
    h = a.shape[-2]
    lo, hi = max(dy, 0), max(-dy, 0)
    if isinstance(a, np.ndarray):
        ap = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(lo, hi), (0, 0)])
    else:
        ap = torch.nn.functional.pad(a, (0, 0, lo, hi))
    return ap[..., hi:hi + h, :]


def bilateral_colour_planes(i0n: torch.Tensor) -> torch.Tensor:
    """The 5 colour planes (5, h, w) of the normalized frame ``i0n`` on its
    device, one a row offset dy = -2..2: exp(-0.5 ((i0 - tap(i0)) /
    SIGMA_COLOR)^2), tap(i0) = i0[y - dy, x] (0 outside).  Computed on the
    host, float32 arithmetic as JAX's, the exponential in float64 rounded
    once to float32."""
    i0 = i0n.detach().cpu().numpy().astype(np.float32)
    sig = np.float32(SIGMA_BILATERAL_COLOR)
    out = np.empty((len(ROWS),) + i0.shape, np.float32)
    for r, dy in enumerate(ROWS):
        t = (i0 - _row_shift(i0, dy)) / sig
        a = np.float32(-0.5) * (t * t)
        out[r] = np.exp(a.astype(np.float64)).astype(np.float32)
    return torch.as_tensor(out, device=i0n.device)


def spatial_taps() -> torch.Tensor:
    """SPATIAL[dy^2 + dx^2] for the 25 taps in ``SHIFTS`` order (float32)."""
    return torch.tensor([SPATIAL[dy * dy + dx * dx] for dy, dx in SHIFTS],
                        dtype=torch.float32)


def bilateral_weights(i0n: torch.Tensor, colour=None) -> torch.Tensor:
    """The 25 weight planes (25, h, w) of the normalized frame ``i0n`` on
    its device: SPATIAL[d2] * (colour_dy * inside), inside = (y + dy, x +
    dx) in the image, from ``bilateral_colour_planes(i0n)`` (``colour`` if
    already at hand), float32 products on the host."""
    if colour is None:
        colour = bilateral_colour_planes(i0n)
    col = colour.detach().cpu().numpy()
    _, h, w = col.shape
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    out = np.empty((len(SHIFTS), h, w), np.float32)
    for s, (dy, dx) in enumerate(SHIFTS):
        inside = (((yy + dy >= 0) & (yy + dy < h))
                  & ((xx + dx >= 0) & (xx + dx < w))).astype(np.float32)
        out[s] = (np.float32(SPATIAL[dy * dy + dx * dx])
                  * (col[dy + PATCH_BILATERAL_FILTER] * inside))
    return torch.as_tensor(out, device=i0n.device)


def _keep(trust, fixed):
    return (trust != 0) | (fixed != 0)


def bilateral_filter_flow_plain(weights, u1, u2, trust, fixed,
                                iters: int = ITER_BILATERAL_FILTER):
    """Plain twin of K11: (u1, u2) of shape (..., h, w) (lanes of one
    frame), the (25, h, w) ``weights`` of ``bilateral_weights``, ``trust``
    and ``fixed`` of u1's shape; returns the filtered (u1, u2)."""
    keep = _keep(trust, fixed)
    zero = torch.zeros((), dtype=u1.dtype, device=u1.device)
    f1 = torch.where(keep, u1, zero)
    f2 = torch.where(keep, u2, zero)
    for _ in range(iters):
        num1 = torch.zeros_like(f1)
        num2 = torch.zeros_like(f2)
        den = torch.zeros_like(f1)
        for s, (dy, _dx) in enumerate(SHIFTS):
            wgt = weights[s]
            num1 = num1 + wgt * _row_shift(f1, dy)
            num2 = num2 + wgt * _row_shift(f2, dy)
            den = den + wgt
        den = den.clamp(min=1e-12)
        f1 = torch.where(keep, f1, num1 / den)
        f2 = torch.where(keep, f2, num2 / den)
    return torch.where(keep, u1, f1), torch.where(keep, u2, f2)


def bilateral_filter_flow(i0n: torch.Tensor, u1: torch.Tensor,
                          u2: torch.Tensor, trust: torch.Tensor,
                          fixed: torch.Tensor,
                          iters: int = ITER_BILATERAL_FILTER, colour=None):
    """K11: fill and smooth (u1, u2) at the pixels where trust == 0 and
    fixed == 0 by bilateral weighted averaging of the surrounding flow
    (``faldoi_tpu.core.bilateral.bilateral_filter_flow``).  ``i0n``: the
    (h, w) normalized frame the weights come from; u1, u2: (h, w) or (L, h,
    w) lanes of that frame; trust, fixed: int or bool masks of u1's shape.
    ``colour``: ``bilateral_colour_planes(i0n)`` if already at hand.
    Returns the filtered (u1, u2).

    CPU tensors go to the plain twin (on the 25 planes of
    ``bilateral_weights``); CUDA tensors launch the kernel, one launch for
    all lanes and iterations (or raise)."""
    h, w = i0n.shape
    if u1.shape != u2.shape or u1.shape[-2:] != (h, w) or u1.dim() > 3:
        raise ValueError(f"u1 {tuple(u1.shape)} and u2 {tuple(u2.shape)} must "
                         f"be (h, w) or (L, h, w) with (h, w) = ({h}, {w})")
    if trust.shape != u1.shape or fixed.shape != u1.shape:
        raise ValueError("trust and fixed must have the flow's shape")
    if colour is None:
        colour = bilateral_colour_planes(i0n)
    if tuple(colour.shape) != (len(ROWS), h, w):
        raise ValueError(f"colour: shape {tuple(colour.shape)}, expected "
                         f"({len(ROWS)}, {h}, {w})")
    if u1.device.type == "cpu":
        return bilateral_filter_flow_plain(bilateral_weights(i0n, colour), u1,
                                           u2, trust, fixed, iters)
    dev = u1.device
    kb.require_cuda_tensor(colour, "colour", torch.float32, dev)
    kb.require_cuda_tensor(u1, "u1", torch.float32, dev)
    kb.require_cuda_tensor(u2, "u2", torch.float32, dev)
    keep = _keep(trust, fixed).to(torch.uint8).contiguous()
    nl = 1 if u1.dim() == 2 else u1.shape[0]
    o1, o2 = torch.empty_like(u1), torch.empty_like(u2)
    spatial = spatial_taps()
    code = kb.library().faldoi_bilateral_filter(
        colour.data_ptr(), spatial.data_ptr(), keep.data_ptr(), u1.data_ptr(),
        u2.data_ptr(), o1.data_ptr(), o2.data_ptr(), nl, h, w, iters,
        kb.stream_ptr(dev))
    kb.check(code, "bilateral_filter_flow")
    bilateral_filter_flow.launches += 1
    return o1, o2


bilateral_filter_flow.launches = 0   # launches of K11, one a filter of all lanes

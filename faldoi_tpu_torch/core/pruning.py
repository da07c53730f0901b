"""Flow pruning between local-growing iterations.

Port of ``faldoi_tpu/core/pruning.py`` (``local_faldoi.cpp:131-270``):

* ``fb_consistency_check``: |u_fwd(x) + u_bwd(x + u_fwd(x))| > eps marks x
  untrusted, with the backward flow sampled by K4 (``border_out=True``) at
  every pixel exactly;
* ``too_uniform_areas``: x is untrusted where its 3x3 neighbourhood (edge
  padded) varies by less than ``tol`` in frame a or in frame b warped by the
  flow (K4, ``border_out=True``).  Off by default, as in the reference.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.core.pd_common import hypot
from faldoi_tpu_torch.ops.bicubic import bicubic_warp, bicubic_warp_stack


def fb_consistency_check(u1, u2, bu1, bu2, epsilon):
    """Trust mask (int32: 1 trusted / 0 untrusted) of the forward flow
    (u1, u2) given the backward flow (bu1, bu2)."""
    bstack = torch.stack([torch.nan_to_num(bu1), torch.nan_to_num(bu2)])
    u1w, u2w = bicubic_warp_stack(bstack, u1, u2, True)
    tol = hypot(u1 + u1w, u2 + u2w)
    return (tol <= epsilon).to(torch.int32)


def _too_uniform(img, tol):
    """int32 1 where max |I(x + d) - I(x)| over the 3x3 offsets d (the image
    edge-padded, as ``jnp.pad(mode="edge")``) is < tol; a NaN pixel is never
    uniform (local_faldoi.cpp:79-115)."""
    h, w = img.shape
    rows = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    pads = img.index_select(0, rows).index_select(1, cols)
    diffs = [(pads[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] - img).abs()
             for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return (torch.stack(diffs).amax(dim=0) < tol).to(torch.int32)


def too_uniform_areas(a, b, u1, u2, tol):
    """Trust mask (int32) from the uniformity test on frame a and on frame b
    warped by (u1, u2) (local_faldoi.cpp:131-151)."""
    bw = bicubic_warp(b, u1, u2, True)
    bad = (_too_uniform(a, tol) == 1) | (_too_uniform(bw, tol) == 1)
    return (~bad).to(torch.int32)


def prune(i0n, i1n, fwd_flow, bwd_flow, epsilon, use_fb=True, use_tu=False,
          tu_tol=0.01):
    """pruning_method (local_faldoi.cpp:209-270): returns (trust_go,
    trust_ba), the product of the enabled tests."""
    h, w = i0n.shape
    trust_go = torch.ones((h, w), dtype=torch.int32, device=i0n.device)
    trust_ba = torch.ones((h, w), dtype=torch.int32, device=i0n.device)
    if use_fb:
        trust_go = trust_go * fb_consistency_check(
            fwd_flow[..., 0], fwd_flow[..., 1], bwd_flow[..., 0],
            bwd_flow[..., 1], epsilon)
        trust_ba = trust_ba * fb_consistency_check(
            bwd_flow[..., 0], bwd_flow[..., 1], fwd_flow[..., 0],
            fwd_flow[..., 1], epsilon)
    if use_tu:
        trust_go = trust_go * too_uniform_areas(
            i0n, i1n, fwd_flow[..., 0], fwd_flow[..., 1], tu_tol)
        trust_ba = trust_ba * too_uniform_areas(
            i0n, i1n, bwd_flow[..., 0], bwd_flow[..., 1], tu_tol)
    return trust_go, trust_ba

"""Forward-backward consistency pruning between local-growing iterations.

Port of ``faldoi_tpu/core/pruning.py`` (``local_faldoi.cpp:167-270``):
|u_fwd(x) + u_bwd(x + u_fwd(x))| > eps marks x untrusted, with the backward
flow sampled by K4 (``border_out=True``) at every pixel exactly.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.core.pd_common import sqrt_rn
from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack


def _hypot(x, y):
    """``jnp.hypot``'s formula (max * sqrt(1 + (min/max)^2)), so the trust
    threshold rounds as in the JAX reference on every device."""
    a, b = x.abs(), y.abs()
    is_inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    safe = torch.where(hi == 0, torch.ones_like(hi), hi)
    q = lo / safe
    r = torch.where(hi == 0, hi, hi * sqrt_rn(1 + q * q))
    return torch.where(is_inf, torch.full_like(r, float("inf")), r)


def fb_consistency_check(u1, u2, bu1, bu2, epsilon):
    """Trust mask (int32: 1 trusted / 0 untrusted) of the forward flow
    (u1, u2) given the backward flow (bu1, bu2)."""
    bstack = torch.stack([torch.nan_to_num(bu1), torch.nan_to_num(bu2)])
    u1w, u2w = bicubic_warp_stack(bstack, u1, u2, True)
    tol = _hypot(u1 + u1w, u2 + u2w)
    return (tol <= epsilon).to(torch.int32)


def prune(i0n, i1n, fwd_flow, bwd_flow, epsilon):
    """pruning_method (local_faldoi.cpp:209-270) with the FB test only (the
    uniformity test is off by default): returns (trust_go, trust_ba)."""
    trust_go = fb_consistency_check(fwd_flow[..., 0], fwd_flow[..., 1],
                                    bwd_flow[..., 0], bwd_flow[..., 1], epsilon)
    trust_ba = fb_consistency_check(bwd_flow[..., 0], bwd_flow[..., 1],
                                    fwd_flow[..., 0], fwd_flow[..., 1], epsilon)
    return trust_go, trust_ba

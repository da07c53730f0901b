"""Batched patch crop — kernel K0 and its plain twin.

Counterpart of ``faldoi_tpu/ops/pallas_sweep.py::_pallas_gather_patches``,
the repo's one Pallas kernel: B copies of (p, p, C) windows at (oy[k], ox[k])
from an edge-padded (H', W', C) stack into a (p, p, C, B) block.  Mosaic
rejected it (minor-dim DMAs must be 128-aligned), so the JAX sweep crops with
a vmapped ``lax.dynamic_slice`` (``_xla_gather_patches``).  The port puts the
kernel where the JAX package could not: in the crop stage of every sweep
(C = 5 state planes, p = 11), in the patch solver's source-frame crop (C = 1)
and in the seed insertion (p = 3).

Semantics are ``lax.dynamic_slice``'s: a negative start counts from the end
(``allow_negative_indices``), then the start is clamped into
``[0, H'-p] x [0, W'-p]``, so lanes at the dump index (whose geometry points
below the image) crop in bounds and harmlessly.  It is a pure copy, so the
kernel equals the twin bit for bit.

K0 (``csrc/patch_gather.cu``) runs one thread per output element, ordered
with the batch index fastest, so the writes of a warp are coalesced; the
reads are (p*C)-float runs per window row.  At (447, 1035, 5), p = 11,
B = 8192 it moves 19.8 MB out and at most as much in, so it is bound by
device-memory traffic and launch latency (a few microseconds), not compute.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.kernels import build as kb


def gather_patches_plain(stack: torch.Tensor, oy: torch.Tensor,
                         ox: torch.Tensor, p: int) -> torch.Tensor:
    """Plain twin of K0: (H', W', C), (B,), (B,) -> (p, p, C, B)."""
    hp, wp, _ = stack.shape
    ar = torch.arange(p, device=stack.device)
    oy, ox = oy.to(torch.int64), ox.to(torch.int64)
    oyc = torch.where(oy < 0, oy + hp, oy).clamp(0, hp - p)
    oxc = torch.where(ox < 0, ox + wp, ox).clamp(0, wp - p)
    rows = oyc[:, None] + ar[None, :]                     # (B, p)
    cols = oxc[:, None] + ar[None, :]
    out = stack[rows[:, :, None], cols[:, None, :], :]    # (B, p, p, C)
    return out.permute(1, 2, 3, 0).contiguous()


def gather_patches(stack: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   p: int) -> torch.Tensor:
    """K0: (H', W', C) float32, (B,) int32 origins -> (p, p, C, B) crops.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if stack.dim() != 3:
        raise ValueError(f"stack must be (H', W', C), got {tuple(stack.shape)}")
    hp, wp, c = stack.shape
    if p > hp or p > wp:
        raise ValueError(f"patch {p} larger than the stack {hp}x{wp}")
    if oy.shape != ox.shape or oy.dim() != 1:
        raise ValueError("oy and ox must be (B,) vectors of one length")
    if stack.device.type == "cpu":
        return gather_patches_plain(stack, oy, ox, p)
    kb.require_cuda_tensor(stack, "stack", torch.float32)
    kb.require_cuda_tensor(oy, "oy", torch.int32, stack.device)
    kb.require_cuda_tensor(ox, "ox", torch.int32, stack.device)
    b = oy.shape[0]
    out = torch.empty((p, p, c, b), dtype=torch.float32, device=stack.device)
    if b == 0:
        return out
    code = kb.library().faldoi_gather_patches(
        stack.data_ptr(), oy.data_ptr(), ox.data_ptr(), out.data_ptr(),
        hp, wp, c, b, p, kb.stream_ptr(stack.device))
    kb.check(code, "gather_patches")
    gather_patches.launches += 1
    return out


gather_patches.launches = 0   # K0 launches, raised only after a launch

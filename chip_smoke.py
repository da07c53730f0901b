#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``faldoi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from a checkout of the repo on a machine with one CUDA card and needs no
network.  It builds the hand-written kernels from ``faldoi_tpu_torch/csrc``
(one nvcc per source, in parallel), holds each against its plain PyTorch
twin at its path's shapes, runs crops of the synthetic pair through the port
on the CPU (the twins, which the tests hold against JAX) and on the card —
method 0 with the warm requeue, and method 1 with the cold requeue — and
then drives three paths, each with the kernels' launch counts set to 0 just
before it and read just after:

* the m0 main path at 436x1024 — seeds -> local growing -> global
  refinement — on a SYNTHETIC textured pair with a known two-layer flow,
  seeded at the positions of the golden DeepMatching seeds
  (``tests/golden/deep_mt_{1,2}.flo``);
* the probe path, ``faldoi_tpu_torch.cli.kernel_probe`` (P1-P3);
* the frames-to-flow entry point ``faldoi_tpu_torch.cli.faldoi_sift -vm 1``
  on the same pair written as ``.npy`` frames: SIFT matches (host), sparse
  seeds, the weighted TV-L1 growing and the global step, on the card.

Every kernel's record carries its time, its twin's, its bound (the larger
of its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
counted from this run's inputs) and, where one PyTorch call computes the
same function (K0's two forms: one ``aten::index``; P1: ``torch.add``), that
call's time as a yardstick the port never calls.  K0 is checked and timed at
every shape the paths launch (a record's ``shapes``), its planes form also
beside the crop stage it replaced.  K4's flow form (the whole-image warp) is
held bit-equal to the point form and timed beside the stage it replaced, the
point form alone and a device copy of the same bytes, for a noisy, a smooth,
a constant and a torn flow, then at the pruning's shapes (C 2 and C 1 by the
stride-2 halves of an (H, W, 2) flow) and, after the paths, on the very flows
the m0 and ``faldoi_sift`` runs gave the FB check (its record's ``shapes``);
the point form itself lies on no path any more: it is checked there and
keeps a record with 0 launches.  The m0 and ``faldoi_sift`` runs print the global step's
stages as milliseconds between CUDA events.  Every phase prints its own
lines; any failure raises (non-zero exit, no result line).  The line before
the last is the kernels' JSON record; the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024             # the Sintel frame size the golden seeds are on
BSZ = 8192
CROP = (96, 128)             # the CPU-vs-card crop
SEED = 0
# keys of a kernel's record printed beside the required ones
EXTRA = ("launches_m0", "shape", "eager_ms", "wrapper_ms", "per_iter_us",
         "point_ms", "point_glue_ms", "former_ms", "copy_ms", "flows",
         "ms_spread", "library_spread", "shapes")
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")
# PD iterations per global warp, identical on the CPU twins and the card
# (the m0 path's since PR 1; every warp of the SIFT-seeded m1 flow hits the
# 400-iteration cap)
ITERS_M0 = [400, 111, 133, 115, 160]
ITERS_SIFT = [400] * 5


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def same_bits(a, b):
    """Equal bit for bit (NaN payloads included)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def crop_origins(dev, rng, b, p):
    """(B,) int64 window origins as the sweep forms them: ``patch_geometry``
    of random candidate indices, with the corners and the dump index first,
    then starts that are negative and past the end."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    idx[:8] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W, H * W, H * W,
                               H * W - 2, 5 * W], device=dev)   # corners + dump
    _, _, oy, ox, _, _ = patch_geometry(idx, H, W, p // 2)
    oy[8:12] = torch.as_tensor([-3, H + 50, 0, 2 * H], device=dev)
    ox[8:12] = torch.as_tensor([W + 40, -7, -1, 0], device=dev)
    return oy.contiguous(), ox.contiguous()


def padded_windows(oy, ox, p, hp, wp):
    """Rows (B, p) and columns (B, p) that ``dynamic_slice`` windows of side
    p at the (oy, ox) starts read in an (hp, wp) padded array."""
    ar = torch.arange(p, device=oy.device)
    rows = torch.where(oy < 0, oy + hp, oy).clamp(0, hp - p)[:, None] + ar
    cols = torch.where(ox < 0, ox + wp, ox).clamp(0, wp - p)[:, None] + ar
    return rows, cols


def check_k0(dev, rng, n_seeds):
    """K0's two forms at every shape the paths launch, bit for bit against
    their twins, each with its own bound and one ``aten::index`` with
    prebuilt indices as its yardstick.

    Stack form: the state stack of former trees (447, 1035, 5) p 11, the
    solver's source crop (447, 1035, 1) p 11, both at B 8192 and 1900, and
    the seed insertion's (447, 1035, 1) p 3 at the seed count.  Planes
    form: five (436, 1024) planes, p 11, B 8192 and 1900, with a float32 and
    an int32 trust map, beside the crop stage it replaced (stack, pad, casts,
    stack form, in one CUDA graph).  Returns the two records."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms, touched
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_patches, gather_patches_plain, gather_plane_patches,
        gather_plane_patches_plain, pad_for_crops,
    )

    n = H * W
    flat = [torch.as_tensor(rng.standard_normal(n + 1).astype(np.float32), device=dev)
            for _ in range(4)]
    for pl in flat:
        pl[torch.as_tensor(rng.random(n + 1) < 0.05, device=dev)] = float("nan")
    trust_i = torch.as_tensor((rng.random((H, W)) > 0.02).astype(np.int32), device=dev)
    trust_f = trust_i.to(torch.float32)
    # every stack is padded by the sweep's patch side, 11: the seed
    # insertion crops its 3x3 windows from the same padded source frame
    hp, wp = H + 11, W + 11
    st5 = pad_for_crops(torch.stack([pl[:n].view(H, W) for pl in flat] + [trust_f],
                                    dim=-1), 11)
    stacks = {5: st5, 1: st5[:, :, :1].contiguous()}

    def former_crop(oy, ox, p):
        """The sweep's crop stage before the planes form."""
        st = torch.stack([pl[:n].view(H, W) for pl in flat]
                         + [trust_f.to(torch.float32)], dim=-1)
        oy32, ox32 = oy.to(torch.int32), ox.to(torch.int32)
        return gather_patches(pad_for_crops(st, p), oy32, ox32, p).permute(3, 0, 1, 2)

    stack_rows, plane_rows = [], []
    for c, p, b in ((5, 11, BSZ), (5, 11, 1900), (1, 11, BSZ), (1, 11, 1900),
                    (1, 3, n_seeds)):
        oy, ox = crop_origins(dev, rng, b, p)
        oy32, ox32 = oy.to(torch.int32), ox.to(torch.int32)
        stack = stacks[c]
        got = gather_patches(stack, oy32, ox32, p)
        want = gather_patches_plain(stack, oy32, ox32, p)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"K0 gather_patches C={c} p={p} B={b} differs "
                                 "from its twin")
        rows, cols = padded_windows(oy, ox, p, hp, wp)
        ri, ci = rows[:, :, None], cols[:, None, :]
        row = dict(shape=f"({hp},{wp},{c}) p {p} B {b}",
                   ms=cuda_ms(lambda: gather_patches(stack, oy32, ox32, p), graph=True),
                   plain_ms=cuda_ms(lambda: gather_patches_plain(stack, oy32, ox32, p)),
                   library_ms=cuda_ms(lambda: stack[ri, ci, :], graph=True),
                   **bound(touched((hp, wp), rows, cols) * c * 4
                           + b * p * p * c * 4 + 2 * b * 4))
        stack_rows.append(row)
        log(f"K0 gather_patches (stack form) {row['shape']}: bit-exact  kernel "
            f"{row['ms']:.4f} ms  twin {row['plain_ms']:.4f} ms  one aten::index "
            f"{row['library_ms']:.4f} ms  bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']})")
        if (c, p) != (5, 11):
            continue
        # the planes form on the same origins, against its twin (the former
        # composition) with both trust dtypes, and against the former stage
        for trust in (trust_f, trust_i):
            planes = (*flat, trust)
            got = gather_plane_patches(planes, oy, ox, p, H, W)
            want = gather_plane_patches_plain(planes, oy, ox, p, H, W)
            torch.cuda.synchronize()
            if not (same_bits(got, want)
                    and same_bits(got, former_crop(oy, ox, p).permute(3, 0, 1, 2))):
                raise AssertionError(f"K0 gather_plane_patches B={b} trust "
                                     f"{trust.dtype} differs from its twin")
        planes = (*flat, trust_f)
        crows, ccols = rows.clamp(max=H - 1), cols.clamp(max=W - 1)
        row = dict(shape=f"5 x ({H},{W}) p {p} B {b}",
                   ms=cuda_ms(lambda: gather_plane_patches(planes, oy, ox, p, H, W),
                              graph=True),
                   plain_ms=cuda_ms(lambda: gather_plane_patches_plain(
                       planes, oy, ox, p, H, W)),
                   library_ms=stack_rows[-1]["library_ms"],
                   former_ms=cuda_ms(lambda: former_crop(oy, ox, p), graph=True),
                   **bound(touched((H, W), crows, ccols) * c * 4
                           + b * p * p * c * 4 + 2 * b * 8))
        plane_rows.append(row)
        log(f"K0 gather_plane_patches (planes form) {row['shape']}: bit-exact "
            f"(float32 and int32 trust)  kernel {row['ms']:.4f} ms  the former "
            f"stage (stack, pad, casts, stack form) {row['former_ms']:.4f} ms  "
            f"twin {row['plain_ms']:.4f} ms  one aten::index on the prebuilt "
            f"stack {row['library_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    common = dict(route="cuda", source="faldoi_tpu_torch/csrc/patch_gather.cu",
                  max_abs_err=0.0)
    # a record's own numbers are those of its most frequent launch on the
    # path: the solver's source crop, and the state crop at B 8192
    return [dict(common, name="gather_patches",
                 replaces="faldoi_tpu/ops/pallas_sweep.py:49", **stack_rows[2],
                 shapes=stack_rows),
            dict(common, name="gather_plane_patches",
                 replaces="faldoi_tpu/core/local_step.py:564", **plane_rows[0],
                 shapes=plane_rows)]


def window_cells(ny, nx, uu, vv):
    """Distinct pixels that bicubic samples at (uu, vv) read (4x4 windows)."""
    from faldoi_tpu_torch.cli.kernel_probe import touched
    from faldoi_tpu_torch.ops.bicubic import _sample_weights

    wy, wx = _sample_weights(ny, nx, uu.reshape(-1), vv.reshape(-1))[:2]
    ar = torch.arange(4, device=uu.device)
    return touched((ny, nx), wy[:, None] + ar, wx[:, None] + ar)


def smooth_flow(rng, noise=2.0):
    """A smooth (H, W) flow pair reaching out of the domain, plus noise."""
    yy, xx = np.mgrid[0:H, 0:W]
    u = 14 * np.sin(xx / 37.0) + 9 * np.cos(yy / 23.0) + rng.normal(0, noise, (H, W))
    v = 11 * np.cos(xx / 29.0) - 8 * np.sin(yy / 41.0) + rng.normal(0, noise, (H, W))
    return u.astype(np.float32), v.astype(np.float32)


# K4's float operations a point: ~40 for the two axes' weights, then 16
# FMAs (32 operations) a plane
K4_OPS_POINT, K4_OPS_PLANE = 40, 32


def k4_warp_row(planes, u, v, shape, timed=True):
    """One call of K4's flow form as a path makes it (u, v with any strides,
    NaNs allowed), ``border_out=True``: within 1e-5 of its twin, bit-equal to
    the point form at the same points; timed beside the stage it replaced.
    Returns the shape's row: its error, times and bound."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_warp_planes, bicubic_warp_planes_plain,
        warp_coords,
    )

    c, ny, nx = planes.shape
    uu, vv = warp_coords(u, v)
    got = bicubic_warp_planes(planes, u, v, True)
    want = bicubic_warp_planes_plain(planes, u, v, True)
    if not same_bits(got, bicubic_sample(planes, uu, vv, True)):
        raise AssertionError(f"K4 flow form at {shape} differs from the point form")
    nan = got.isnan()
    if not torch.equal(nan, want.isnan()):
        raise AssertionError(f"K4 flow form at {shape}: NaNs where the twin has none")
    err = (got - want)[~nan].abs().max().item() if not nan.all() else 0.0
    if not err <= 1e-5 * max(float(planes.abs().max()), 1.0):
        raise AssertionError(f"K4 flow form at {shape}: max abs err {err} > 1e-5")
    out = ((uu < 0) | (uu >= nx) | (vv < 0) | (vv >= ny)).float().mean().item()
    npts = ny * nx
    row = dict(shape=shape, max_abs_err=err, flow_strides=[list(u.stride()),
                                                           list(v.stride())],
               flow_nan=int(u.isnan().sum() + v.isnan().sum()),
               flow_max=float(torch.nan_to_num(torch.stack([u, v])).abs().max()),
               out_of_domain=out,
               **bound(window_cells(ny, nx, uu, vv) * c * 4 + npts * (2 + c) * 4,
                       npts * (2 + K4_OPS_POINT + c * K4_OPS_PLANE)))
    if timed:
        row.update(
            ms=cuda_ms(lambda: bicubic_warp_planes(planes, u, v, True), graph=True),
            former_ms=cuda_ms(lambda: bicubic_sample(planes, *warp_coords(u, v), True),
                              graph=True))
    log(f"K4 flow form {shape} (strides {row['flow_strides'][0]}): bit-equal to "
        f"the point form, max_abs_err {err:.3e}; flow NaNs {row['flow_nan']}, max "
        f"|flow| {row['flow_max']:.1f} px, {100 * out:.2f}% of the points out of "
        f"the domain" + (f"; flow form {row['ms']:.4f} ms  the former stage "
                         f"{row['former_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms"
                         if timed else ""))
    return row


class fb_warps:
    """While active, keeps the arguments of every warp the FB check makes
    (``core.pruning``), so that the kernel can be held to its twin on the
    very flows a path gave it.  Launches are counted as ever."""

    def __enter__(self):
        from faldoi_tpu_torch.core import pruning

        self.calls, self.inner = [], pruning.bicubic_warp_stack

        def keep(planes, u, v, border_out):
            self.calls.append((planes, u, v))
            return self.inner(planes, u, v, border_out)

        pruning.bicubic_warp_stack = keep
        return self.calls

    def __exit__(self, *exc):
        from faldoi_tpu_torch.core import pruning

        pruning.bicubic_warp_stack = self.inner


def check_k4_path(path, calls):
    """K4's flow form on the FB check's own calls of a path (C 2, the flow's
    halves at stride 2): each checked, the first prune's pair and the last
    call timed."""
    if len(calls) != 6:
        raise AssertionError(f"{path}: {len(calls)} FB warps kept, expected 6")
    rows = []
    for k, (planes, u, v) in enumerate(calls):
        if u.stride() != (2 * W, 2) or tuple(planes.shape) != (2, H, W):
            raise AssertionError(f"{path}: FB warp {k} is not a C 2 warp by the "
                                 f"halves of an (H, W, 2) flow: {u.stride()}")
        rows.append(k4_warp_row(planes, u, v, f"{path} prune {k // 2} "
                                f"{('fwd', 'bwd')[k % 2]}, 2x{H}x{W}",
                                timed=k in (0, 1, 5)))
    return rows


def check_k4_warp(dev, rng):
    """K4's flow form on 3 planes at 436x1024 (the whole-image warp of the
    global step) with flows reaching out of the domain, both border modes:
    within 1e-5 of its twin and bit-equal to the point form at the same
    points; the point form against its own twin as before.  Timed, for a
    noisy, a smooth, a constant and a torn flow, beside the stage it
    replaced (``warp_coords`` + point form in one graph) and the point form
    alone, and beside a device copy of the same bytes; then at the pruning's
    shapes.  Returns the flow form's record and the point form's."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_plain, bicubic_warp_planes,
        bicubic_warp_planes_plain, warp_coords,
    )

    planes = torch.as_tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                             device=dev)
    flows = {"noisy": smooth_flow(rng), "smooth": smooth_flow(rng, noise=0.0),
             "constant": (np.full((H, W), 2.6, np.float32),
                          np.full((H, W), -1.4, np.float32)),
             "torn": tuple(rng.uniform(-300, 300, (2, H, W)).astype(np.float32))}
    flows = {k: tuple(torch.as_tensor(x, device=dev) for x in f)
             for k, f in flows.items()}
    bound_err = 1e-5 * float(planes.abs().max())
    worst = worst_point = 0.0
    times = {}
    for name, (u, v) in flows.items():
        uu, vv = warp_coords(u, v)
        if name != "constant" and not ((uu < 0).any() and (vv < 0).any()
                                       and (uu >= W).any() and (vv >= H).any()):
            raise AssertionError(f"K4 {name} test flow does not leave the domain")
        for border_out in (True, False):
            point = bicubic_sample(planes, uu, vv, border_out)
            worst_point = max(worst_point, (point - bicubic_sample_plain(
                planes, uu, vv, border_out)).abs().max().item())
            got = bicubic_warp_planes(planes, u, v, border_out)
            worst = max(worst, (got - bicubic_warp_planes_plain(
                planes, u, v, border_out)).abs().max().item())
            torch.cuda.synchronize()
            if not same_bits(got, point):
                raise AssertionError(f"K4 flow form ({name} flow, border_out="
                                     f"{border_out}) differs from the point form")
        if not max(worst, worst_point) <= bound_err:
            raise AssertionError(f"K4 {name} flow: flow form {worst}, point form "
                                 f"{worst_point} > {bound_err}")
        times[name] = dict(
            ms=cuda_ms(lambda: bicubic_warp_planes(planes, u, v, True), graph=True),
            former_ms=cuda_ms(lambda: bicubic_sample(planes, *warp_coords(u, v), True),
                              graph=True),
            point_ms=cuda_ms(lambda: bicubic_sample(planes, uu, vv, True), graph=True))
        log(f"K4 {name} flow 3x{H}x{W}: flow form {times[name]['ms']:.4f} ms  the "
            f"former stage (warp_coords + point form) {times[name]['former_ms']:.4f} "
            f"ms  point form alone {times[name]['point_ms']:.4f} ms")
    u, v = flows["noisy"]
    uu, vv = warp_coords(u, v)
    # the pruning's calls: C 2 (the FB check) and C 1 (the uniformity warp)
    # with u, v the stride-2 halves of one (H, W, 2) flow, read where they lie
    halves = torch.stack([u, v], dim=-1)
    strided = [k4_warp_row(planes[:c], halves[..., 0], halves[..., 1],
                           f"{c}x{H}x{W}, noisy flow as (H,W,2) halves")
               for c in (2, 1)]
    src, dst = torch.empty((2, 4, H, W), device=dev).unbind(0)
    copy_ms = cuda_ms(lambda: dst.copy_(src), graph=True)
    plain = cuda_ms(lambda: bicubic_warp_planes_plain(planes, u, v, True), reps=5)
    npts = H * W
    least = bound(window_cells(H, W, uu, vv) * 3 * 4 + npts * (2 + 3) * 4,
                  npts * (2 + K4_OPS_POINT + 3 * K4_OPS_PLANE))
    log(f"K4 bicubic_warp_planes (flow form) 3x{H}x{W} image warp, noisy flow: "
        f"max_abs_err {worst:.3e} (point form {worst_point:.3e}; bound "
        f"{bound_err:.3e}), bit-equal to the point form; copy of 4 planes onto 4 "
        f"{copy_ms:.4f} ms  twin {plain:.4f} ms  bound {least['bound_ms']:.4f} ms "
        f"({least['bound_by']})")
    common = dict(route="cuda", source="faldoi_tpu_torch/csrc/bicubic.cu",
                  shape="3x436x1024", library_ms=None, **least)
    # the point form lies on no path: its record is the check above
    return [dict(common, name="bicubic_warp_planes",
                 replaces="faldoi_tpu/ops/bicubic.py:301", max_abs_err=worst,
                 plain_ms=plain, copy_ms=copy_ms, flows=times,
                 shapes=strided, **times["noisy"]),
            dict(common, name="bicubic_sample",
                 replaces="faldoi_tpu/ops/bicubic.py:122",
                 max_abs_err=worst_point, ms=times["noisy"]["point_ms"],
                 plain_ms=cuda_ms(lambda: bicubic_sample_plain(planes, uu, vv, True),
                                  reps=5))]


def solver_patches(dev, rng, b, p=11):
    """The patch solver's call at B patches: boxes from ``patch_geometry`` of
    random candidate indices (corners and the dump index first), canvases
    of a smooth flow sampled at the cells (zero outside the box), and a
    motion edge of 30 px inside 2% of the patches."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    idx[:5] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W, H * W], device=dev)
    _, _, oy, ox, ph, pw = patch_geometry(idx, H, W, p // 2)
    u, v = smooth_flow(rng, noise=0.3)
    ar = torch.arange(p, device=dev)
    rr = (oy[:, None, None] + ar[None, :, None]).clamp(max=H - 1)
    cc = (ox[:, None, None] + ar[None, None, :]).clamp(max=W - 1)
    inbox = (ar[None, :, None] < ph[:, None, None]) & (ar[None, None, :] < pw[:, None, None])
    zero = torch.zeros((), device=dev)
    u1 = torch.where(inbox, torch.as_tensor(u, device=dev)[rr, cc], zero)
    u2 = torch.where(inbox, torch.as_tensor(v, device=dev)[rr, cc], zero)
    edge = torch.as_tensor(rng.random(b) < 0.02, device=dev)[:, None, None] & \
        (ar[None, None, :] > p // 2)
    u1 = torch.where(edge & inbox, u1 + 30.0, u1).contiguous()
    return [x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw)] + [u1, u2.contiguous()]


def check_k4_patches(dev, rng):
    """K4's patch form at the solver's call (3 planes, P 11) for B 8192 and
    1900, bit for bit against its twin and against the point form at the
    same points; timed beside the point form alone and with the glue the
    solver ran before it.  The record is B 8192's; B 1900 is logged."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.ops.bicubic import (
        _patch_points, bicubic_sample, bicubic_sample_patches,
        bicubic_sample_patches_plain,
    )
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    planes = torch.as_tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                             device=dev)
    rec = None
    for b in (BSZ, 1900):
        geo = solver_patches(dev, rng, b)
        oy, ox, ph, pw, u1, u2 = geo
        got = bicubic_sample_patches(planes, *geo, 3)
        want = bicubic_sample_patches_plain(planes, *geo, 3)
        uu, vv = _patch_points(*geo)
        point = bicubic_sample(planes, uu.contiguous(), vv.contiguous(), False)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, point)):
            d = (got - want).abs().max().item()
            raise AssertionError(f"K4 patch form B={b} differs from its twin "
                                 f"(max abs {d}) or from the point form")
        # the solver's former warp: its glue (where, add, where, add), then
        # the point form; the boxes' cells were built once per solve
        rows, cols = canvas_ids(11, dev)
        inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
        gx = (ox[:, None, None] + cols).float()
        gy = (oy[:, None, None] + rows).float()
        zero = torch.zeros((), device=dev)

        def old_warp():
            return bicubic_sample(planes, (gx + torch.where(inbox, u1, zero)).contiguous(),
                                  (gy + torch.where(inbox, u2, zero)).contiguous(), False)

        uu, vv = uu.contiguous(), vv.contiguous()
        ms = cuda_ms(lambda: bicubic_sample_patches(planes, *geo, 3), graph=True)
        point_ms = cuda_ms(lambda: bicubic_sample(planes, uu, vv, False), graph=True)
        glue_ms = cuda_ms(old_warp, graph=True)
        npts = b * 121
        least = bound(window_cells(H, W, uu, vv) * 3 * 4 + npts * (2 + 3) * 4 + b * 16,
                      npts * (2 + K4_OPS_POINT + 3 * K4_OPS_PLANE))
        log(f"K4 bicubic_sample_patches 3x(B={b}x11x11) at the solver's points: "
            f"bit-exact; patch form {ms:.4f} ms  point form {point_ms:.4f} ms  point "
            f"form with the solver's former glue {glue_ms:.4f} ms  bound "
            f"{least['bound_ms']:.4f} ms ({least['bound_by']})")
        if rec is None:
            plain = cuda_ms(lambda: bicubic_sample_patches_plain(planes, *geo, 3), reps=5)
            rec = dict(name="bicubic_sample_patches", route="cuda",
                       source="faldoi_tpu_torch/csrc/bicubic.cu",
                       replaces="faldoi_tpu/core/functionals.py:180",
                       shape=f"3x({b}x11x11)", max_abs_err=0.0, ms=ms,
                       plain_ms=plain, library_ms=None, point_ms=point_ms,
                       point_glue_ms=glue_ms, **least)
    return rec


# K5's float operations a pixel an iteration: ~24 in the dual phase, ~41 in
# the primal phase (threshold, divergence, getP, over-relaxation, u_n)
K5_OPS = 65
K5_PLANES = 20     # 12 planes read once and 8 written once a launch


def warp_state(dev, a, b, flow):
    """A warp's PD state and constants, as tvl2_global builds them."""
    from faldoi_tpu_torch.core.pd_common import warp_constants
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, i1wx, i1wy = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    grad, rho_c = warp_constants(a, i1w, i1wx, i1wy, u1, u2)
    xi = [torch.zeros_like(u1) for _ in range(4)]
    return [u1, u2, u1.clone(), u2.clone(), *xi, i1wx.contiguous(),
            i1wy.contiguous(), grad.contiguous(), rho_c.contiguous()]


def check_k5(dev, rng, a, b, gf):
    """The K5 loop: one iteration from a random state, a whole warp from a
    real one (the same iteration count as the twin loop), timed at the
    400-iteration cap, and a whole tvl2_global against the CPU twins."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.global_step import (
        global_pd_iteration_plain, global_pd_loop, global_pd_loop_plain,
        tvl2_global,
    )
    from faldoi_tpu_torch.synthetic import epe

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()

    l_t, theta, tau = float(np.float32(40) * np.float32(0.3)), 0.3, 0.125
    tol2 = float(np.float32(0.01) * np.float32(0.01))
    st = [gf[..., 0], gf[..., 1], gf[..., 0] + rng.normal(0, 0.1, (H, W)),
          gf[..., 1] + rng.normal(0, 0.1, (H, W))]
    st += [rng.uniform(-0.9, 0.9, (H, W)) for _ in range(4)]
    gx, gy = rng.normal(0, 0.05, (H, W)), rng.normal(0, 0.05, (H, W))
    consts = [t(gx), t(gy), t(gx * gx + gy * gy), t(rng.normal(0, 0.1, (H, W)))]
    ka = [t(x) for x in st]
    kb_ = [x.clone() for x in ka]
    if global_pd_loop(*ka, *consts, l_t, theta, tau, tol2, 1) != 1:
        raise AssertionError("K5 loop with max_iters 1 ran another count")
    global_pd_iteration_plain(*kb_, *consts, torch.empty(1, device=dev), l_t, theta, tau)
    worst = max((x - y).abs().max().item() for x, y in zip(ka, kb_))
    # a whole warp from the state tvl2_global builds: same count, same planes
    flow = t(gf + rng.normal(0, 0.5, gf.shape))
    ws = warp_state(dev, a, b, flow)
    wt = [x.clone() for x in ws]
    n = global_pd_loop(*ws, l_t, theta, tau, tol2, 400)
    n_twin = global_pd_loop_plain(*wt, l_t, theta, tau, tol2, 400)
    worst = max([worst] + [(x - y).abs().max().item() for x, y in zip(ws, wt)])
    if n != n_twin or not worst <= 1e-5:
        raise AssertionError(f"K5 loop: {n} iterations against the twin's "
                             f"{n_twin}, max abs diff {worst} (bound 1e-5)")
    # at the cap: tol2 < 0 never stops a loop early
    ms = cuda_ms(lambda: global_pd_loop(*ws, l_t, theta, tau, -1.0, 400), reps=5, warmup=1)
    plain = cuda_ms(lambda: global_pd_loop_plain(*wt, l_t, theta, tau, -1.0, 400),
                    reps=1, warmup=1)
    least = bound(K5_PLANES * H * W * 4, K5_OPS * H * W * 400)
    # a whole tvl2_global: kernels vs the same run on the twins (CPU)
    f0 = t(gf + rng.normal(0, 0.3, gf.shape))
    st_card, st_cpu = {}, {}
    t0 = time.perf_counter()
    u1, u2 = tvl2_global(a, b, f0[..., 0].contiguous(), f0[..., 1].contiguous(),
                         stats=st_card)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c1, c2 = tvl2_global(a.cpu(), b.cpu(), f0[..., 0].cpu().contiguous(),
                         f0[..., 1].cpu().contiguous(), stats=st_cpu)
    e = epe(torch.stack([u1, u2], -1).cpu().numpy(), torch.stack([c1, c2], -1).numpy())
    if st_card["global_iters"] != st_cpu["global_iters"] or not e <= 1e-3:
        raise AssertionError(f"tvl2_global card vs CPU twins: iterations "
                             f"{st_card['global_iters']} vs {st_cpu['global_iters']}, "
                             f"EPE {e} (bound 1e-3)")
    log(f"K5 global_pd_loop 436x1024: max_abs_err {worst:.3e}; a warp from a real "
        f"state {n} iterations (twin loop {n_twin}); at the 400-iteration cap kernel "
        f"{ms:.4f} ms a launch = {ms / 400 * 1e3:.2f} us an iteration, twin loop "
        f"{plain:.4f} ms; bound {least['bound_ms']:.4f} ms a launch "
        f"({least['bound_by']}; bytes alone {bound(K5_PLANES * H * W * 4)['bound_ms']:.4f} "
        f"ms); "
        f"tvl2_global card vs CPU twins EPE {e:.3e} px, iterations "
        f"{st_card['global_iters']} on both ({secs:.3f} s on the card)")
    return dict(name="global_pd_loop", route="cuda",
                source="faldoi_tpu_torch/csrc/global_pd.cu",
                replaces="faldoi_tpu/core/global_step.py:74",
                shape="436x1024, 400 iterations a launch", max_abs_err=worst,
                ms=ms, plain_ms=plain, library_ms=None, per_iter_us=ms / 400 * 1e3,
                **least)


def run_slice(i0, i1, go, ba, device, stats, method=0, warm_band=10):
    """The port's main path: prepare_pair -> match_growing -> tvl2_global
    (the global step of methods 0 and 1)."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    dev = torch.device(device)
    t0 = time.perf_counter()
    a, b = prepare_pair(i0, i1, device=device)
    prm = P.Parameters()
    prm.val_method = method
    flow, _ = match_growing(go, ba, a, b, prm, bsz=BSZ, stats=stats,
                            warm_band=warm_band)
    t1 = time.perf_counter()
    u1, u2 = tvl2_global(a, b, flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                         stats=stats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stats["seconds"]["global"] = time.perf_counter() - t1
    stats["seconds"]["total"] = time.perf_counter() - t0
    return flow.cpu().numpy(), torch.stack([u1, u2], -1).cpu().numpy()


def log_global_ms(path, st):
    """The global step's spans between CUDA events (``tvl2_global(stats=)``):
    the set-up, then each stage summed over the warps, and the K5 spans."""
    ms = st["global_ms"]
    sums = {k: round(sum(v), 3) for k, v in ms.items() if k != "setup"}
    log(f"{path} global step, ms between device events: setup "
        f"{ms['setup']:.3f}; summed over {len(ms['warp'])} warps "
        f"{json.dumps(sums)}; per warp: warp "
        f"{[round(x, 4) for x in ms['warp']]}, pd_loop "
        f"{[round(x, 3) for x in ms['pd_loop']]}")


def run_sift_path(i0, i1, gf, wrappers):
    """``faldoi_sift -vm 1 -device cuda`` on the pair written as ``.npy``
    frames; checks the final flow and returns the launches of ``wrappers``
    on this path."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli import faldoi_sift
    from faldoi_tpu_torch.io.flo import read_flo

    with tempfile.TemporaryDirectory() as tmp:
        names = []
        for k, im in enumerate((i0, i1)):
            names.append(os.path.join(tmp, f"frame_{k}.npy"))
            np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
        with open(os.path.join(tmp, "ims.txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
        res = os.path.join(tmp, "out") + os.sep
        for fn in wrappers:
            fn.launches = 0
        st = {}
        t0 = time.perf_counter()
        rc = faldoi_sift.main([os.path.join(tmp, "ims.txt"), "-vm", "1",
                               "-device", "cuda", "-bsz", str(BSZ),
                               "-res_path", res], stats=st)
        secs = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        if rc != 0:
            raise AssertionError(f"faldoi_sift exited {rc}")
        rg = read_flo(res + "frame_0_sift_rg.flo")
        var = read_flo(res + "frame_0_sift_var.flo")
    fill = float(np.isfinite(rg).all(-1).mean())
    stages = {k: round(v, 3) for k, v in st["stages"].items()}
    grow = {k: round(v, 3) for k, v in st["seconds"].items()}
    log(f"faldoi_sift -vm 1 {H}x{W} SYNTHETIC .npy frames, bsz {BSZ}: "
        f"{secs:.2f} s; matcher {st['matcher']}; matches fwd/bwd "
        f"{st['matches']}")
    log(f"faldoi_sift stage seconds: {json.dumps(stages)}")
    log(f"faldoi_sift growing seconds: {json.dumps(grow)}")
    log(f"faldoi_sift sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"faldoi_sift global PD iterations per warp: {st['global_iters']}")
    log_global_ms("faldoi_sift", st)
    log("faldoi_sift global stage, host seconds: " + json.dumps(
        {k: round(v, 4) for k, v in st["global_seconds"].items()}))
    log(f"launches on the faldoi_sift path: {json.dumps(launches)}")
    log(f"faldoi_sift fill {100 * fill:.3f}%  rg EPE vs known flow "
        f"{syn.epe(rg, gf):.4f} px  var EPE vs known flow "
        f"{syn.epe(var, gf):.4f} px (synthetic)")
    if fill < 1.0:
        raise AssertionError(f"faldoi_sift growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in faldoi_sift's final flow")
    if st["global_iters"] != ITERS_SIFT:
        raise AssertionError(f"faldoi_sift global iterations {st['global_iters']}, "
                             f"expected {ITERS_SIFT}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.global_step import global_pd_loop
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.io.flo import read_flo
    from faldoi_tpu_torch.kernels import build as kb
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_patches, bicubic_warp_planes,
    )
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_plane_patches

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # phase 2: build the kernels from the checkout's sources (in parallel)
    t0 = time.perf_counter()
    path = kb.build(verbose=True)
    kb.library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, HERE)}")

    # the synthetic pair and the golden seed positions
    rng = np.random.default_rng(SEED)
    i0, i1, gf, gb = syn.make_pair(H, W, seed=SEED)
    gold = os.path.join(HERE, "tests", "golden")
    pos_f = syn.seed_positions_from_flo(read_flo(os.path.join(gold, "deep_mt_1.flo")), H, W)
    pos_b = syn.seed_positions_from_flo(read_flo(os.path.join(gold, "deep_mt_2.flo")), H, W)
    go = syn.make_seeds(gf, pos_f, rng)
    ba = syn.make_seeds(gb, pos_b, rng)
    log(f"data: SYNTHETIC textured pair {H}x{W} (seed {SEED}), known flow "
        f"bg {syn.BG_FLOW} / rect {syn.FG_FLOW}; seeds at the golden positions: "
        f"{len(pos_f)} fwd, {len(pos_b)} bwd, 5% perturbed 3-6 px")

    # phase 3: each path kernel against its twin on the card
    a, b = prepare_pair(i0, i1, device="cuda")
    kernels = [*check_k0(dev, rng, len(pos_f)), *check_k4_warp(dev, rng),
               check_k4_patches(dev, rng), check_k5(dev, rng, a, b, gf)]

    # phase 3b: the probe kernels P1-P3 against their twins
    from faldoi_tpu_torch.cli import kernel_probe as kp

    probe_recs = kp.run_probes(dev, np.random.default_rng(SEED))
    for r in probe_recs:
        log(kp.describe(r))

    # phase 4: crops through the CPU twins and through the card, m0 with the
    # warm requeue and m1 with the cold one
    ch, cw = CROP
    cut = (slice(0, ch), slice(0, cw))
    crop = (i0[:, :ch, :cw], i1[:, :ch, :cw], go[cut], ba[cut])
    for method, band in ((0, 10), (1, 0)):
        res = {}
        for device in ("cpu", "cuda"):
            st = {}
            t0 = time.perf_counter()
            res[device] = run_slice(*crop, device, st, method, band)
            log(f"crop {ch}x{cw} m{method} warm_band {band} on {device}: "
                f"{time.perf_counter() - t0:.2f} s, "
                f"sweeps {[s['sweeps'] for s in st['sweeps']]}")
        e_rg = syn.epe(res["cuda"][0], res["cpu"][0])
        e_var = syn.epe(res["cuda"][1], res["cpu"][1])
        log(f"crop m{method} warm_band {band} card vs CPU twins: rg EPE "
            f"{e_rg:.3e} px, final (var) EPE {e_var:.3e} px (bound 0.01)")
        if not e_var <= 0.01:
            raise AssertionError(f"crop m{method} card vs CPU: final EPE "
                                 f"{e_var} > 0.01")

    # phase 5: the full m0 main path on the card, counting launches
    # K4's point form comes last: it is counted to show that no path
    # launches it any more (the whole-image warps take the flow form)
    wrappers = (gather_patches, gather_plane_patches, bicubic_warp_planes,
                bicubic_sample_patches, global_pd_loop, bicubic_sample)
    for fn in wrappers:
        fn.launches = 0
    st = {}
    with fb_warps() as fb_m0:
        rg, var = run_slice(i0, i1, go, ba, "cuda", st)
    launches_m0 = {fn.__name__: fn.launches for fn in wrappers}
    fill = float(np.isfinite(rg).all(-1).mean())
    secs = {k: round(v, 3) for k, v in st["seconds"].items()}
    log(f"full {H}x{W} SYNTHETIC main path (m0), bsz {BSZ}: seconds "
        f"{json.dumps(secs)}")
    log(f"sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"global PD iterations per warp: {st['global_iters']}")
    log_global_ms("m0 main path", st)
    log(f"launches on the m0 main path: {json.dumps(launches_m0)}")
    chunks = sum(-(-len(pos) // 2048) for pos in (pos_f, pos_b))
    log(f"of gather_patches' launches, {chunks} at p 3 (one a chunk of 2048 seeds, "
        f"B {len(pos_f)} and {len(pos_b)}); the rest at p 11, one a non-empty sweep")
    log(f"fill {100 * fill:.3f}%  rg EPE vs known flow {syn.epe(rg, gf):.4f} px  "
        f"var EPE vs known flow {syn.epe(var, gf):.4f} px (synthetic)")
    if fill < 1.0:
        raise AssertionError(f"growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in the final flow")
    if st["global_iters"] != ITERS_M0:
        raise AssertionError(f"global iterations {st['global_iters']}, expected "
                             f"{ITERS_M0}")

    # phase 6: the probe path (its entry point), counting launches
    from faldoi_tpu_torch.ops import probes

    probe_wrappers = (probes.probe_axpy, probes.probe_roll4,
                      probes.probe_window_fetch)
    for fn in probe_wrappers:
        fn.launches = 0
    if kp.main([]) != 0:
        raise AssertionError("kernel_probe failed")
    launches_probe = {fn.__name__: fn.launches for fn in probe_wrappers}
    log(f"launches on the probe path: {json.dumps(launches_probe)}")

    # phase 7: frames to flow, faldoi_sift -vm 1 at full width, counting
    # launches
    with fb_warps() as fb_sift:
        launches_sift = run_sift_path(i0, i1, gf, wrappers)

    # phase 8: K4's flow form on the flows the two paths gave the FB check
    # (after the paths, so these launches are in no path's count)
    flow_rec = [k for k in kernels if k["name"] == "bicubic_warp_planes"][0]
    flow_rec["shapes"] = (flow_rec["shapes"] + check_k4_path("m0", fb_m0)
                          + check_k4_path("faldoi_sift", fb_sift))

    kernels = [dict(k, launches=launches_sift[k["name"]],
                    launches_m0=launches_m0[k["name"]]) for k in kernels]
    p3 = [r for r in probe_recs if r["name"] == "probe_window_fetch"][-1]
    for r in [r for r in probe_recs if r["name"] != "probe_window_fetch"] + [p3]:
        kernels.append(dict(r, launches=launches_probe[r["name"]]))
    if launches_m0["bicubic_sample"] or launches_sift["bicubic_sample"]:
        raise AssertionError("K4's point form was launched on a path: a "
                             "whole-image warp did not take the flow form")
    for k in kernels:
        if k["name"] == "bicubic_sample":
            continue
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on its path")
        if k.get("launches_m0", 1) <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the m0 path")

    print(json.dumps({"kernels": [
        {k: d[k] for k in KEYS + EXTRA if k in d} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

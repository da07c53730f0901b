#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``faldoi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from a checkout of the repo on a machine with one CUDA card and needs no
network.  It builds the hand-written kernels from ``faldoi_tpu_torch/csrc``
(one nvcc per source, in parallel), holds each against its plain PyTorch
twin at its path's shapes, runs crops of the synthetic pair through the port
on the CPU (the twins, which the tests hold against JAX) and on the card —
methods 0, 2, 4 and 6 with the warm requeue, methods 1, 3, 5 and 7 with the
cold one, at 96x128 (methods 0-3) and 48x64 (the CSAD methods 4-7); the CPU
runs go in eight child processes, one thread each, started at once beside
the card's phases, and the CSAD crops must give the card's flows exactly —
and then drives these paths, each with the kernels' launch counts set to 0
just before it and read just after:

* the m0 main path at 436x1024 — seeds -> local growing -> global
  refinement — on a SYNTHETIC textured pair with a known two-layer flow,
  seeded at the positions of the golden DeepMatching seeds
  (``tests/golden/deep_mt_{1,2}.flo``);
* the m2 (NLTV-L1) path at 436x1024 through the stage CLIs,
  ``local_faldoi -m 2`` then ``global_faldoi -m 2``, from the same seeds on
  the pair written as ``.npy`` frames: K0 crops the 24 weight planes, K7
  runs the patch PD loops and K6 the global ones;
* the m4 (TV-CSAD) path the same way, ``local_faldoi -m 4`` then
  ``global_faldoi -m 4``: the K8 loop runs the whole PD loop of every patch
  solve batch and warp in one launch, and K8 (the CSAD median prox) the
  v-step of every global PD iteration;
* the m8 (TV-L1 with occlusions) path the same way on the four-frame
  sequence, ``local_faldoi -m 8`` then ``global_faldoi -m 8``: K9's patch
  form runs every patch solve batch and warp (its calls timed where they
  run), K9's whole-image form every global warp in one cooperative launch
  with its tol exit on the card;
* F1, the growing's parity frontier at 436x1024: ``local_faldoi -m 0
  -warm_band 0 -relax_late 1 -polish 1`` (the cold requeue, label-correcting
  relax from the second outer iteration on, a re-polish pass of every fixed
  pixel after the drains of iterations 1, 2 and the final one), then
  ``global_faldoi``;
* F2, the growing's whole-image fills at 436x1024: ``match_growing(fill=
  "dense", bilateral=True)`` then ``tvl2_global``: K10 (the jump-flood
  nearest fill) once a sweep that accepts, K11 (the bilateral pre-fill) once
  a prune;
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
keeps a record with 0 launches.  K6 (the global NLTV loop) is held bit for
bit to its twin on one 400-iteration warp at 436x1024 (its log line gives
the streamed floor beside the bound: the state through device memory once
an iteration), K7
(the patch NLTV loop) at B 8192 and 1900 (P 11) and at the seed count (P 3),
methods 2 and 3, and K0's planes form on the 24 weight planes at the same
shapes.  K8 is held bit for bit to its twin in its whole-image form at
436x1024 (a corner pixel has 15 neighbours) and 5x7, and in its patch form
at P 11 with B 8192, 297, 1 and 1900 on boxes clipped at the image edge
(out-of-box cells: NaN and +-inf included); it is timed beside its twin,
beside ``torch.sort`` + ``gather`` of the 97 stacked entries (no single
PyTorch call selects a per-cell rank) and beside the times of its former
design (a thread a cell, insertion sort; a constant).  The K8 loop is held bit for bit to its twin and to
the per-iteration form it replaced (K8's patch form and plain ops an
iteration) at P 11 with B 8192, 297, 1 and 1900 (m5's per-cell l_t), P 3 at
the seed count and B 297 under a tol that stops every canvas after one
step, and after the paths at the m4 path's median B; the m4 path's loop
calls are then replayed through both forms and their times summed.  K9 is
held bit for bit to its twins: the patch form at every shape the m8 path
gives it, the whole-image loop (state and count) at 436x1024, 5x7 and
1088x1920, one kernel node a captured call; both beside their former
designs' times (constants, in the log only; ``cli/k9_variants.py`` times
the former forms themselves); the m8 path's patch-form calls are held to the
list ``cli/k9_m8_calls.json`` that ``k9_variants`` replays.  K10 is held
bit for bit to its twin at 436x1024, 97x131 and 5x7, one and two lanes, with
no finite cell, one, and the golden seed positions, and K11 at the same
shapes; each is timed in a CUDA graph of 20 calls at the F2 path's shapes.
The growing's ordering modes and fills (relax, exactmin 11 with bands 0, 1
and 2, defer 0.25 over 21 px, polish, dense, bilateral, relax_late) run on
m0 crops, warm and cold (96x128; exactmin and defer 48x64, the final drain
alone, as they take ~300-500 sweeps a drain), on the card and through the
CPU twins (child processes started after the paths); each card flow must
equal its CPU run bit for bit.
The m0
and ``faldoi_sift`` runs print the global step's
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
EXTRA = ("launches_m0", "launches_m2", "launches_m4", "launches_m8",
         "launches_sift", "launches_pairs", "launches_f1", "launches_f2",
         "launches_per_call",
         "launches_c24_m2", "shape", "eager_ms", "wrapper_ms", "per_iter_us",
         "point_ms", "point_glue_ms", "former_ms", "copy_ms", "flows",
         "ms_spread", "library_spread", "sort_ms", "corner_n", "shapes",
         "per_iteration_ms", "path_calls", "path_per_iteration_s", "path_loop_s",
         "path_call_ms", "former_spread", "former_bound_ms", "setup_ms",
         "former_setup_ms")
KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")
# PD iterations per global warp, identical on the CPU twins and the card
# (the m0 path's since PR 1; every warp of the SIFT-seeded m1 flow hits the
# 400-iteration cap, as JAX's warps do on such a flow:
# tests/test_torch_m1_global_iters.py)
ITERS_M0 = [400, 111, 133, 115, 160]
ITERS_SIFT = [400] * 5
# the kernels whose main path is the m2 one, and the m4 one (every other
# kernel's is the faldoi_sift path, and it runs on the m0 path too)
M2_KERNELS = ("nltv_global_loop", "nltv_patch_loop")
M4_KERNELS = ("csad_vstep", "csad_patch_loop")
M8_KERNELS = ("occ_patch_loop", "occ_global_loop")
# the lane forms' records, whose main path is pairs mode (N = 4)
PAIRS_KERNELS = ("gather_patches_lanes", "gather_plane_patches_lanes",
                 "bicubic_sample_patches_lanes")
# pairs mode's pair counts: N synthetic pairs grown together
PAIRS_N = (1, 2, 4)
# K8's card times in its former design (a thread a cell, insertion sort), a
# graph of 20 calls on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel
# table), printed beside this run's
FORMER_K8_MS = {"436x1024": "1.0456-1.0480", "5x7": "0.080-0.081",
                "P 11 B 8192": "2.942-2.958", "P 11 B 1": "0.054",
                "P 11 B 1900 m5, per-cell l_t": "0.736-0.746",
                "P 11 B 297": "0.166-0.171"}
# K9's card times in its former designs (the patch form a thread a cell, a
# canvas a 128-thread block; the whole-image form one PD iteration as 99
# launches, ms a PD iteration), a graph of 20 calls on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md's kernel table), printed in the log beside this
# run's and in no record
FORMER_K9_MS = {"P 11 B 8192": "1.772-1.785", "P 11 B 1900": "0.469-0.473",
                "P 11 B 297": "0.148-0.151", "P 11 B 1": "0.132-0.133",
                "P 3 B 1703": "0.135-0.136", "436x1024": "0.473-0.509",
                "436x1024 occ_init": "0.473-0.509", "5x7 occ_init": "0.167-0.168"}
# PD iterations of a timed whole-image call (the path's calls run 400)
GLOBAL_TIMED_ITERS = 10
# the CPU-vs-card crops of methods 4-7: smaller than CROP, as their CPU
# twins (the 97-entry sort, the exact raster fill) take ~2 min at 48x64 on
# one thread
CSAD_CROP = (48, 64)
# every crop (method, warm band, shape); their CPU twins run in child
# processes, one thread each, beside the card's phases
CROPS = ((0, 10, CROP), (1, 0, CROP), (2, 10, CROP), (3, 0, CROP),
         (4, 10, CSAD_CROP), (5, 0, CSAD_CROP), (6, 10, CSAD_CROP),
         (7, 0, CSAD_CROP), (8, 10, CSAD_CROP))
# the crops that must give the card's results exactly: the CSAD ones and
# method 8's (its binary chi feeds back into u, so the bound of 0.01 px the
# TV-L1 crops keep would not say much)
EXACT_CROPS = (4, 5, 6, 7, 8)
# the growing's ordering modes and fills on m0 crops, warm (band 10) or cold
# (0): name -> (warm band, outer iterations, crop, match_growing's
# keywords); the card's final flow must equal the CPU twins' bit for bit;
# their CPU twins run in child processes started after the paths.  exactmin
# and defer accept a few candidates a window a sweep (~300-500 sweeps a
# drain at 48x64 as at 96x128, ~15 ms each on the card), so they run only
# the final drain (no outer iteration) on CSAD_CROP; the sweeps with a
# pruned hole in the trust map are held against JAX's on the CPU
# (tests/test_torch_ordering.py)
MODE_CROPS = {
    "relax": (10, 3, CROP, dict(relax=True)),
    "exactmin11_band0": (0, 0, CSAD_CROP, dict(exactmin=11)),
    "exactmin11_band1": (0, 0, CSAD_CROP, dict(exactmin=11, exactmin_band="1")),
    "exactmin11_band2": (0, 0, CSAD_CROP, dict(exactmin=11, exactmin_band="2")),
    "defer0.25_win21": (0, 0, CSAD_CROP, dict(defer=0.25, defer_win=21)),
    "polish1": (0, 3, CROP, dict(polish=1)),
    "dense": (10, 3, CROP, dict(fill="dense")),
    "bilateral": (0, 3, CROP, dict(bilateral=True)),
    "relax_late": (0, 3, CROP, dict(relax_late=True)),
}
# the full-width paths of the growing's modes: F1 the parity frontier
# (local_faldoi -m 0 with these flags, then global_faldoi), F2 the dense
# fill and the bilateral pre-fill (match_growing's keywords, then
# tvl2_global); K10 and K11 run on F2 only
F1_FLAGS = ("-warm_band", "0", "-relax_late", "1", "-polish", "1")
F2_MODES = dict(fill="dense", bilateral=True)
F2_KERNELS = ("nearest_fill_image", "bilateral_filter_flow")


def log(msg):
    print(msg, flush=True)


def reset_launches(wrappers):
    """Set every wrapper's launch counts to 0 (with a lane index too)."""
    for fn in wrappers:
        fn.launches = 0
        if hasattr(fn, "launches_lane"):
            fn.launches_lane = 0


def read_launches(wrappers):
    """Every wrapper's launches by name; the lane-indexed launches of K0's
    two forms and K4's patch form under ``<name>_lanes``."""
    out = {fn.__name__: fn.launches for fn in wrappers}
    out.update({f"{fn.__name__}_lanes": fn.launches_lane for fn in wrappers
                if hasattr(fn, "launches_lane")})
    return out


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def digest(a) -> str:
    """The first 16 hex digits of the sha256 of an array's bytes: a flow
    later runs can compare bit for bit."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


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


def solver_patches(dev, rng, b, p=11, centres=False):
    """The patch solver's call at B patches: boxes from ``patch_geometry`` of
    random candidate indices (corners and the dump index first), canvases
    of a smooth flow sampled at the cells (zero outside the box), and a
    motion edge of 30 px inside 2% of the patches; ``centres`` adds the
    patches' centres (i, j) at the end."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    idx[:5] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W, H * W],
                              device=dev)[:b]
    ci, cj, oy, ox, ph, pw = patch_geometry(idx, H, W, p // 2)
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
    return ([x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw)]
            + [u1, u2.contiguous()] + ([ci, cj] if centres else []))


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


def lane_origins(dev, rng, lanes, b, p):
    """(lane, oy, ox) of b windows of side p over ``lanes`` lanes as the
    lane-batched sweep forms them: ``patch_geometry`` of candidate indices,
    each lane's four corner pixels first (the boxes clamped at every edge of
    the lane), then random lanes and candidates.  lane and origins int64."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    corners = [0, W - 1, (H - 1) * W, H * W - 1]
    lane = torch.as_tensor(rng.integers(0, lanes, b), device=dev)
    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    k = min(b, 4 * lanes)
    lane[:k] = torch.arange(4 * lanes, device=dev)[:k] // 4
    idx[:k] = torch.as_tensor(corners * lanes, device=dev)[:k]
    _, _, oy, ox, _, _ = patch_geometry(idx, H, W, p // 2)
    return lane.contiguous(), oy.contiguous(), ox.contiguous(), idx


# the lane forms' shapes: (L, B); the first two are timed (two lanes at
# the full batch each: one pair's lockstep; eight: N = 4 pairs), the
# others held for bits only (ragged B, B 1)
LANE_SHAPES = ((2, 2 * BSZ), (8, 8 * BSZ), (2, 1), (8, 1), (8, 8191), (2, 1901))


def check_lanes(dev, rng):
    """K0's two forms and K4's patch form with a lane index (the pairs
    mode's and the lockstep's calls) at ``LANE_SHAPES``, bit for bit against
    their twins: the stack form on L padded (447, 1035, 1) source frames at
    p 11, the planes form on L lanes' five state planes (four flat with
    their dump slot, an int32 trust map), K4 on L (3, 436, 1024) stacks at
    the solver's points.  Each record is timed at its first shape (L 2,
    B 16384), with its bound, its twin and, for K0, one ``aten::index``
    with prebuilt indices; L 8 at B 65536 is a ``shapes`` row.  Returns the
    three records."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms, touched
    from faldoi_tpu_torch.ops.bicubic import (
        _patch_points, _sample_weights, bicubic_sample_patches,
        bicubic_sample_patches_plain,
    )
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_patches, gather_patches_plain, gather_plane_patches,
        gather_plane_patches_plain, pad_for_crops,
    )

    n, p = H * W, 11
    hp, wp = H + p, W + p
    most = max(lanes for lanes, _ in LANE_SHAPES)
    flat = torch.as_tensor(rng.standard_normal((4, most, n + 1)).astype(np.float32),
                           device=dev)
    flat[torch.as_tensor(rng.random((4, most, n + 1)) < 0.05, device=dev)] = float("nan")
    trust = torch.as_tensor((rng.random((most, H, W)) > 0.02).astype(np.int32),
                            device=dev)
    src = torch.stack([pad_for_crops(flat[0, k, :n].view(H, W), p)
                       for k in range(most)])[..., None].contiguous()
    frames = torch.as_tensor(rng.uniform(0, 1, (most, 3, H, W)).astype(np.float32),
                             device=dev)
    recs = {}
    for lanes, b in LANE_SHAPES:
        lane, oy, ox, _ = lane_origins(dev, rng, lanes, b, p)
        lane32, oy32, ox32 = (t.to(torch.int32).contiguous() for t in (lane, oy, ox))
        stack = src[:lanes]
        planes = tuple(f[:lanes] for f in flat) + (trust[:lanes],)
        fr = frames[:lanes].contiguous()
        geo = solver_patches(dev, rng, b)
        oyp, oxp, ph, pw, u1, u2 = geo
        got = (gather_patches(stack, oy32, ox32, p, lane=lane32),
               gather_plane_patches(planes, oy, ox, p, H, W, lane=lane),
               bicubic_sample_patches(fr, *geo, 3, lane=lane32))
        want = (gather_patches_plain(stack, oy32, ox32, p, lane32),
                gather_plane_patches_plain(planes, oy, ox, p, H, W, lane),
                bicubic_sample_patches_plain(fr, *geo, 3, lane32))
        torch.cuda.synchronize()
        for name, g, w_ in zip(("gather_patches", "gather_plane_patches",
                                "bicubic_sample_patches"), got, want):
            if not same_bits(g, w_):
                raise AssertionError(f"{name} with a lane index, L {lanes} B {b}, "
                                     "differs from its twin")
        log(f"lane forms L {lanes} B {b} (every lane's corner boxes first): K0 "
            "stack, K0 planes, K4 patch bit-exact with their twins")
        if b < BSZ:
            continue
        rows, cols = padded_windows(oy, ox, p, hp, wp)
        cells = sum(touched((hp, wp), rows[lane == k], cols[lane == k])
                    for k in range(lanes))
        ri, ci, li = rows[:, :, None], cols[:, None, :], lane[:, None, None]
        shape = f"L {lanes} B {b}"
        k0 = dict(shape=f"{lanes} x ({hp},{wp},1) p 11 B {b}",
                  ms=cuda_ms(lambda: gather_patches(stack, oy32, ox32, p,
                                                    lane=lane32), graph=True),
                  plain_ms=cuda_ms(lambda: gather_patches_plain(
                      stack, oy32, ox32, p, lane32), reps=5),
                  library_ms=cuda_ms(lambda: stack[li, ri, ci, :], graph=True),
                  **bound(cells * 4 + b * p * p * 4 + 3 * b * 4))
        crows, ccols = rows.clamp(max=H - 1), cols.clamp(max=W - 1)
        pcells = sum(touched((H, W), crows[lane == k], ccols[lane == k])
                     for k in range(lanes))
        pstack = torch.stack([pad_for_crops(torch.stack(
            [pl[k].reshape(-1)[:n].view(H, W).to(torch.float32) for pl in planes],
            dim=-1), p) for k in range(lanes)])
        k0p = dict(shape=f"5 x {lanes} x ({H},{W}) p 11 B {b}",
                   ms=cuda_ms(lambda: gather_plane_patches(planes, oy, ox, p, H, W,
                                                           lane=lane), graph=True),
                   plain_ms=cuda_ms(lambda: gather_plane_patches_plain(
                       planes, oy, ox, p, H, W, lane), reps=5),
                   library_ms=cuda_ms(lambda: pstack[li, ri, ci, :], graph=True),
                   **bound(pcells * 5 * 4 + 5 * b * p * p * 4 + 3 * b * 8))
        del pstack
        wy, wx = _sample_weights(H, W, *(t.reshape(-1) for t in
                                         _patch_points(*geo)))[:2]
        ar = torch.arange(4, device=dev)
        lp = lane[:, None].expand(b, p * p).reshape(-1)
        wcells = sum(touched((H, W), wy[lp == k][:, None] + ar,
                             wx[lp == k][:, None] + ar) for k in range(lanes))
        npts = b * p * p
        k4 = dict(shape=f"3 x {lanes} x ({H},{W}), B {b} x 11 x 11",
                  ms=cuda_ms(lambda: bicubic_sample_patches(fr, *geo, 3,
                                                            lane=lane32), graph=True),
                  plain_ms=cuda_ms(lambda: bicubic_sample_patches_plain(
                      fr, *geo, 3, lane32), reps=3),
                  library_ms=None,
                  **bound(wcells * 3 * 4 + npts * (2 + 3) * 4 + b * 20,
                          npts * (2 + K4_OPS_POINT + 3 * K4_OPS_PLANE)))
        for name, row in (("gather_patches", k0), ("gather_plane_patches", k0p),
                          ("bicubic_sample_patches", k4)):
            recs.setdefault(name, []).append(row)
            log(f"{name} with a lane index {row['shape']}: kernel {row['ms']:.4f} "
                f"ms  twin {row['plain_ms']:.4f} ms  one call "
                f"{'-' if row['library_ms'] is None else format(row['library_ms'], '.4f')}"
                f" ms  bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{shape}]")
    common = dict(route="cuda", max_abs_err=0.0)
    return [dict(common, name="gather_patches_lanes",
                 source="faldoi_tpu_torch/csrc/patch_gather.cu",
                 replaces="faldoi_tpu/ops/pallas_sweep.py:49",
                 **recs["gather_patches"][0], shapes=recs["gather_patches"]),
            dict(common, name="gather_plane_patches_lanes",
                 source="faldoi_tpu_torch/csrc/patch_gather.cu",
                 replaces="faldoi_tpu/core/local_step.py:564",
                 **recs["gather_plane_patches"][0],
                 shapes=recs["gather_plane_patches"]),
            dict(common, name="bicubic_sample_patches_lanes",
                 source="faldoi_tpu_torch/csrc/bicubic.cu",
                 replaces="faldoi_tpu/core/functionals.py:180",
                 **recs["bicubic_sample_patches"][0],
                 shapes=recs["bicubic_sample_patches"])]


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


# K6's float operations a pixel an iteration: the threshold 16, 48 dual
# updates of 10, 48 divergence terms of 3, the two divisions by wt 2, the
# primal step and over-relaxation 14; K7's a canvas cell an iteration run:
# the same without the divisions by wt, plus the squared update and its
# share of the sums 7
K6_OPS = 656
K7_OPS = 661
K6_PLANES = 133    # 81 (h, w) planes read once and 52 written once a launch
# K6's streamed floor: every state plane through device memory once an
# iteration, with the 24 weight planes or with the 12 that K6 reads
K6_STREAMED = {24: 133, 12: 121}


def nltv_local_consts(a, b, i0, i1):
    """The m2 and m3 solver consts of the forward lane at 436x1024 (the
    local-scale weights of I0's colour planes, method 3's window)."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.models import method_local_params

    return {m: make_solver_consts(a, b, *method_local_params(m, 5), 0.01, 11, m,
                                  i0_planes=i0) for m in (2, 3)}


def check_k0_c24(dev, rng, sc, n_seeds):
    """K0's planes form on the 24 zero-padded weight planes of the NLTV
    solver at the paths' shapes (P 11 at B 8192 and 1900, P 3 at the seed
    count), bit for bit against its twin, with one ``aten::index`` of the
    same windows as its yardstick.  Returns the rows."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms, touched
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_plane_patches, gather_plane_patches_plain,
    )

    planes = sc.wp_pad.unbind(0)
    c, hp, wp = sc.wp_pad.shape
    rows_out = []
    for p, b in ((11, BSZ), (11, 1900), (3, n_seeds)):
        idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
        idx[:4] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W], device=dev)
        _, _, oy, ox, _, _ = patch_geometry(idx, H, W, p // 2)
        oy, ox = oy.contiguous(), ox.contiguous()
        got = gather_plane_patches(planes, oy, ox, p, hp, wp)
        want = gather_plane_patches_plain(planes, oy, ox, p, hp, wp)
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"K0 gather_plane_patches C 24 p {p} B {b} "
                                 "differs from its twin")
        rows, cols = padded_windows(oy, ox, p, hp + p, wp + p)
        rows, cols = rows.clamp(max=hp - 1), cols.clamp(max=wp - 1)
        ri, ci = rows[:, :, None], cols[:, None, :]
        row = dict(shape=f"24 x ({hp},{wp}) p {p} B {b}",
                   ms=cuda_ms(lambda: gather_plane_patches(planes, oy, ox, p, hp, wp),
                              graph=True),
                   plain_ms=cuda_ms(lambda: gather_plane_patches_plain(
                       planes, oy, ox, p, hp, wp)),
                   library_ms=cuda_ms(lambda: sc.wp_pad[:, ri, ci], graph=True),
                   **bound(touched((hp, wp), rows, cols) * c * 4
                           + b * p * p * c * 4 + 2 * b * 8))
        rows_out.append(row)
        log(f"K0 gather_plane_patches (planes form) {row['shape']}, the NLTV "
            f"weights: bit-exact  kernel {row['ms']:.4f} ms  twin "
            f"{row['plain_ms']:.4f} ms  one aten::index {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows_out


def check_k6(dev, rng, a, b, gf, i0):
    """K6 on one warp of 400 iterations at 436x1024 from the state
    ``nltvl1_global`` builds for its first warp (zero duals, the global
    weights of I0), bit for bit against its twin on the card; timed."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.global_step_nltv import (
        global_weights, nltv_global_loop, nltv_global_loop_plain,
    )

    wp, wt = global_weights(i0, dev)
    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                           device=dev)
    u1, u2, u1_, u2_, *_, gx, gy, grad, rho_c = warp_state(dev, a, b, flow)
    sc = [torch.zeros((24, H, W), device=dev) for _ in range(2)]
    ka = [u1, u2, u1_, u2_, *sc, wp, wt, gx, gy, grad, rho_c]
    kb_ = [x.clone() for x in ka]
    l_t, theta, tau = float(np.float32(2.0) * np.float32(0.3)), 0.3, 0.1
    t0 = time.perf_counter()
    nltv_global_loop(*ka, l_t, theta, tau, 400)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    nltv_global_loop_plain(*kb_, l_t, theta, tau, 400)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    worst = max((x - y).abs().max().item() for x, y in zip(ka[:6], kb_[:6]))
    if not all(same_bits(x, y) for x, y in zip(ka[:6], kb_[:6])):
        raise AssertionError(f"K6 differs from its twin: max abs {worst}")
    if not all(torch.isfinite(x).all() for x in ka[:6]):
        raise AssertionError("K6 state not finite after a warp")
    ms = cuda_ms(lambda: nltv_global_loop(*ka, l_t, theta, tau, 400), reps=3,
                 warmup=1)
    least = bound(K6_PLANES * H * W * 4, K6_OPS * H * W * 400)
    floor = {n: bound(planes * H * W * 4)["bound_ms"]
             for n, planes in K6_STREAMED.items()}
    log(f"K6 nltv_global_loop {H}x{W}, one warp of 400 iterations: bit-exact "
        f"(max_abs_err {worst}); kernels {ms:.3f} ms a call (two launches an "
        f"iteration) = {ms / 400 * 1e3:.2f} us an iteration (first call "
        f"{first * 1e3:.1f} ms host); twin {plain:.1f} ms (host clock); bound "
        f"{least['bound_ms']:.4f} ms "
        f"({least['bound_by']}; bytes alone "
        f"{bound(K6_PLANES * H * W * 4)['bound_ms']:.4f} ms); streamed floor "
        f"(the state through device memory once an iteration) "
        f"{floor[24]:.4f} ms an iteration with 24 weight planes, "
        f"{floor[12]:.4f} ms with 12")
    return dict(name="nltv_global_loop", route="cuda",
                source="faldoi_tpu_torch/csrc/nltv.cu",
                replaces="faldoi_tpu/core/global_step_nltv.py:48",
                shape=f"{H}x{W}, 400 iterations a call", max_abs_err=worst,
                ms=ms, plain_ms=plain, library_ms=None,
                per_iter_us=ms / 400 * 1e3, **least)


def k7_nbytes(b, p, lt_cells):
    """K7's bytes a call: the canvases read once (u, v, the four warp
    constants, the 24 weights, wt, l_t where per cell), u, v written once,
    the boxes and iteration counts."""
    return b * p * p * 4 * (8 + 24 + 1 + (1 if lt_cells else 0) + 4) + b * 12


def check_k7(dev, rng, scs, n_seeds):
    """K7 at the solver's shapes: P 11 at B 8192 (methods 2 and 3) and 1900,
    P 3 at the seed count (methods 2 and 3), from the solver's own stages
    (K0's source and weight crops, K4's patch form), bit for bit against its
    twin on the card (canvases, iteration counts); timed.  The record is the
    first row's."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.functionals import (
        _weight2d, nltv_crop_weights, nltv_patch_loop, nltv_patch_loop_plain,
    )
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    rows_out = []
    for p, b, m in ((11, BSZ, 2), (11, BSZ, 3), (11, 1900, 2), (3, n_seeds, 2),
                    (3, n_seeds, 3)):
        sc = scs[m]
        oy, ox, ph, pw, u1, u2, ci, cj = solver_patches(dev, rng, b, p, centres=True)
        i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, oy, ox, ph, pw, u1, u2, 3)
        i0p = gather_patches(sc.i0pad[:, :, None], oy, ox, p)[:, :, 0, :].permute(2, 0, 1)
        wp, wt = nltv_crop_weights(sc.wp_pad, oy, ox, ph, pw, p)
        l_t = sc.lambda_ * sc.theta
        if m == 3:
            rows, cols = canvas_ids(p, dev)
            l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy.long(), ox.long(), cj,
                                   ci, p // 2)).contiguous()
        args = [u1, u2, u1, u2, None, gx, gy, (gx * gx + gy * gy).contiguous(),
                (i1w - gx * u1 - gy * u2 - i0p).contiguous(), wp, wt, l_t, ph, pw,
                sc.theta, sc.tau, sc.tol * sc.tol, 4]
        got = nltv_patch_loop(*args)
        want = nltv_patch_loop_plain(*args)
        torch.cuda.synchronize()
        worst = max((x.float() - y.float()).abs().max().item()
                    for x, y in zip(got[:5], want[:5]))
        if not all(same_bits(x, y) for x, y in zip(got[:5], want[:5])):
            raise AssertionError(f"K7 P {p} B {b} m{m} differs from its twin: max "
                                 f"abs {worst}")
        iters = got[4]
        run = int(iters.sum())
        nb = k7_nbytes(b, p, m == 3)
        row = dict(shape=f"m{m} P {p} B {b}", max_abs_err=worst,
                   ms=cuda_ms(lambda: nltv_patch_loop(*args), graph=True),
                   plain_ms=cuda_ms(lambda: nltv_patch_loop_plain(*args), reps=3,
                                    warmup=1),
                   iterations={str(k): int((iters == k).sum()) for k in range(5)},
                   **bound(nb, run * p * p * K7_OPS))
        rows_out.append(row)
        log(f"K7 nltv_patch_loop {row['shape']}: bit-exact (canvases, iteration "
            f"counts {row['iterations']}); kernel {row['ms']:.4f} ms  twin "
            f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    return dict(name="nltv_patch_loop", route="cuda",
                source="faldoi_tpu_torch/csrc/nltv.cu",
                replaces="faldoi_tpu/core/functionals.py:448", library_ms=None,
                **{k: v for k, v in rows_out[0].items() if k != "iterations"},
                shapes=rows_out)


# K8's float operations a cell: dot 4, the n entries 2 each, the n + 1
# products 2 each, the merge walk's n + 2 comparisons, the v-step 6
def k8_ops(ncount):
    return int((5 * ncount + 14).sum())


def k8_bytes(cells, lt_cells=False, boxes=0):
    """K8's bytes a call: 48 b planes and u1, u2, i1wx, i1wy, denom read
    once (and l_t where it is one a cell), v1, v2 written once, the boxes."""
    return cells * 4 * (48 + 5 + (1 if lt_cells else 0) + 2) + boxes * 8


def k8_patch_args(dev, rng, sc, b, weighted=False, p=11):
    """K8's patch-form call as the m4 solver makes it: B canvases of P (11)
    from ``solver_patches`` (boxes clipped at the image edge: out-of-box
    cells, with no neighbour), the source crop (K0), the warp (K4), grad at
    the TV-CSAD floor, the breakpoints; l_t one value, or one a cell."""
    from faldoi_tpu_torch.core.functionals import _weight2d
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    oy, ox, ph, pw, u1, u2, ci, cj = solver_patches(dev, rng, b, p, centres=True)
    i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, oy, ox, ph, pw, u1, u2, 3)
    i0p = gather_patches(sc.i0pad[:, :, None], oy, ox, p)[:, :, 0, :].permute(2, 0, 1)
    grad = hypot(gx * gx + gy * gy, 0.01).contiguous()
    m, n = canvas_masks(ph, pw, p)
    bb = csad_b(i0p, i1w, gx, gy, u1, u2, grad, m)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        rows, cols = canvas_ids(p, dev)
        l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy.long(), ox.long(), cj, ci,
                               p // 2)).contiguous()
    return (u1, u2, bb, gx.contiguous(), gy.contiguous(), grad, l_t, m, n, ph, pw)


def k8_row(shape, args, patch):
    """K8 on one call's arguments: bit for bit against its twin (NaN and
    +-inf of out-of-box cells included), timed (a CUDA graph of 20 calls)
    beside the twin and beside ``torch.sort`` + ``gather`` of the stacked
    entries (the twin's core; no single PyTorch call selects a per-cell
    rank).  Returns the row."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.ops.csad import csad_vstep, csad_vstep_plain

    u1, u2, bb, gx, gy, grad, l_t, m, n = args[:9]
    got = csad_vstep(*args)
    want = csad_vstep_plain(*args[:9])
    torch.cuda.synchronize()
    if not all(same_bits(x, y) for x, y in zip(got, want)):
        d = max(torch.nan_to_num((x - y).abs(), nan=9.0).max().item()
                for x, y in zip(got, want))
        raise AssertionError(f"K8 {shape} differs from its twin (max abs {d})")
    dot = (gx * u1 + gy * u2) / grad
    inf = torch.full((), float("inf"), device=u1.device)
    jidx = torch.arange(49, dtype=torch.float32, device=u1.device).view(
        (-1,) + (1,) * u1.dim())
    ent = torch.cat([torch.where(m, -(bb - dot), inf),
                     torch.where(jidx <= n, (n - 2.0 * jidx) * (l_t * grad), inf)])
    sel = (n + 1.0).to(torch.int64)[None]
    lt_cells = isinstance(l_t, torch.Tensor) and l_t.dim() != 0
    row = dict(shape=shape, max_abs_err=0.0,
               ms=cuda_ms(lambda: csad_vstep(*args), graph=True),
               plain_ms=cuda_ms(lambda: csad_vstep_plain(*args[:9]), reps=5),
               sort_ms=cuda_ms(lambda: torch.sort(ent, dim=0).values.gather(0, sel),
                               reps=5),
               nonfinite=int((~torch.isfinite(got[0])).sum()),
               **bound(k8_bytes(u1.numel(), lt_cells, u1.shape[0] if patch else 0),
                       k8_ops(n)))
    log(f"K8 csad_vstep {shape}: bit-exact (non-finite cells "
        f"{row['nonfinite']}); kernel {row['ms']:.4f} ms (former kernel: "
        f"{FORMER_K8_MS.get(shape, 'not measured')} ms)  twin {row['plain_ms']:.4f} "
        f"ms  torch.sort + gather of the 97 entries {row['sort_ms']:.4f} ms  bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def check_k8(dev, rng, a, b, gf, scs):
    """K8 in both forms against its twin, bit for bit: the whole-image form
    at 436x1024 from a warp of the synthetic pair (TV-CSAD's grad and
    breakpoints; a corner pixel has n = 15) and at a ragged 5x7; the patch
    form at P 11 from the m4 and m5 solvers' stages (``scs``: their consts
    by method) at B 8192, 297 (the m4 path's median batch), 1 and a
    ragged 1900 (the last m5's, with its per-cell l_t, the window), on boxes
    clipped at the image edge.  The record is 436x1024's."""
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.csad import csad_b, image_masks
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                           device=dev)
    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, gx, gy = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    gx, gy = gx.contiguous(), gy.contiguous()
    grad = hypot(gx * gx + gy * gy, 0.01).contiguous()
    m, n = image_masks(H, W, dev)
    l_t = float(np.float32(0.85) * np.float32(0.3))
    args = (u1, u2, csad_b(a, i1w, gx, gy, u1, u2, grad, m), gx, gy, grad, l_t,
            m, n)
    rows = [k8_row(f"{H}x{W}", args, False)]
    corner = int(n[0, 0])
    if corner != 15:
        raise AssertionError(f"K8: the corner pixel has n {corner}, expected 15")
    small = [torch.as_tensor(rng.normal(0, s, (5, 7)).astype(np.float32), device=dev)
             for s in (0.3, 0.3, 0.05, 0.05, 2.0, 2.0)]
    i0s, i1ws, gxs, gys, u1s, u2s = small
    gs = hypot(gxs * gxs + gys * gys, 0.01)
    ms, ns = image_masks(5, 7, dev)
    rows.append(k8_row("5x7", (u1s, u2s, csad_b(i0s, i1ws, gxs, gys, u1s, u2s, gs,
                                                 ms), gxs, gys, gs, l_t, ms, ns),
                       False))
    for bsz, weighted in ((BSZ, False), (297, False), (1, False), (1900, True)):
        rows.append(k8_row(f"P 11 B {bsz}" + (" m5, per-cell l_t" if weighted else ""),
                           k8_patch_args(dev, rng, scs[5 if weighted else 4], bsz,
                                         weighted), True))
    return dict(name="csad_vstep", route="cuda",
                source="faldoi_tpu_torch/csrc/csad.cu",
                replaces="faldoi_tpu/core/global_step_csad.py:68",
                library_ms=None, corner_n=corner, shapes=rows,
                **{k: v for k, v in rows[0].items() if k != "nonfinite"})


def k8_per_iteration_loop(u1, u2, v1, v2, b, i1wx, i1wy, grad, l_t, m, n, ph,
                          pw, theta, tau, tol2, max_iters):
    """The inert-TV patch PD loop as the m4 / m5 solver ran it before the K8
    loop: K8's patch form a PD iteration, the primal step, err and the
    masked updates as plain ops, ``max_iters`` iterations, no host sync.
    Returns (u1, u2, v1, v2, iterations)."""
    from faldoi_tpu_torch.ops.csad import csad_vstep
    from faldoi_tpu_torch.ops.stencils import canvas_ids, canvas_sum

    rows, cols = canvas_ids(u1.shape[-1], u1.device)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=u1.device)
    npx = (ph * pw).to(u1.dtype)
    st = (u1, u2, u1, u2, v1, v2,
          torch.full(u1.shape[:1], float("inf"), dtype=u1.dtype, device=u1.device),
          torch.zeros(u1.shape[:1], dtype=torch.int32, device=u1.device))
    for _ in range(max_iters):
        c1, c2, _, _, _, _, err, it = st
        nv1, nv2 = csad_vstep(c1, c2, b, i1wx, i1wy, grad, l_t, m, n, ph, pw)
        nu1 = c1 - tau * ((c1 - nv1) / theta)
        nu2 = c2 - tau * ((c2 - nv2) / theta)
        e1, e2 = nu1 - c1, nu2 - c2
        nerr = canvas_sum(torch.where(inbox, e1 * e1 + e2 * e2, zero)) / npx
        run = (err > tol2) & (it < max_iters)
        lane = run.view(-1, 1, 1)
        new = (nu1, nu2, 2 * nu1 - c1, 2 * nu2 - c2, nv1, nv2)
        st = tuple(torch.where(lane, nw, a) for a, nw in zip(st[:6], new)) + (
            torch.where(run, nerr, err), torch.where(run, it + 1, it))
    return st[0], st[1], st[4], st[5], st[7]


def k8_loop_bound(args, iters):
    """The K8 loop's bound for one call: its inputs read once (u, v, the 48
    b planes, i1wx, i1wy, grad, l_t where one a cell, the boxes), u, v and
    the iteration counts written once; K8's operations a cell (``k8_ops``)
    and 12 for the primal step and err, for every step a canvas takes."""
    from faldoi_tpu_torch.cli.kernel_probe import bound

    u1, l_t, n = args[0], args[8], args[10]
    nb, cells = u1.shape[0], u1.numel()
    lt_cells = l_t.dim() != 0
    nbytes = cells * 4 * (4 + 48 + 3 + (1 if lt_cells else 0) + 4) + nb * 12
    ops = int(((5 * n + 26).sum(dim=(1, 2)) * iters.to(n.dtype)).sum())
    return bound(nbytes, ops)


def k8_loop_args(dev, rng, sc, b, weighted=False, p=11, tol2=None):
    """The K8 loop's call for one warp of the m4 (m5) solve: K8's patch
    inputs (``k8_patch_args``), v = u, the consts' theta, tau and tol^2."""
    args = list(k8_patch_args(dev, rng, sc, b, weighted, p))
    return args[:2] + args[:2] + args[2:] + [
        sc.theta, sc.tau, sc.tol * sc.tol if tol2 is None else
        torch.tensor(tol2, dtype=torch.float32, device=dev)]


def k8_loop_row(shape, args):
    """The K8 loop on one call's arguments: bit for bit against its twin and
    against the per-iteration form (K8's patch form in the loop it
    replaced), canvases and iteration counts; timed as a graph of 20 calls
    (the card's time), eagerly (with the wrapper's host work), beside the
    per-iteration form (eager) and the twin.  Returns the row."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.ops.csad import csad_patch_loop, csad_patch_loop_plain

    got = csad_patch_loop(*args, 4)
    want = csad_patch_loop_plain(*args, 4)
    per = k8_per_iteration_loop(*args, 4)
    torch.cuda.synchronize()
    for other, name in ((want, "its twin"), (per, "the per-iteration form")):
        if not all(same_bits(x, y) for x, y in zip(got, other)):
            raise AssertionError(f"K8 loop {shape} differs from {name}")
    iters = got[4]
    row = dict(shape=shape, max_abs_err=0.0,
               ms=cuda_ms(lambda: csad_patch_loop(*args, 4), graph=True),
               eager_ms=cuda_ms(lambda: csad_patch_loop(*args, 4)),
               per_iteration_ms=cuda_ms(lambda: k8_per_iteration_loop(*args, 4),
                                        reps=5),
               plain_ms=cuda_ms(lambda: csad_patch_loop_plain(*args, 4), reps=3,
                                warmup=1),
               iterations={str(k): int((iters == k).sum()) for k in range(5)},
               **k8_loop_bound(args, iters))
    log(f"K8 loop csad_patch_loop {shape}: bit-exact (canvases, iteration "
        f"counts {row['iterations']}); kernel {row['ms']:.4f} ms (eager "
        f"{row['eager_ms']:.4f})  per-iteration form {row['per_iteration_ms']:.4f} "
        f"ms  twin {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def check_k8_loop(dev, rng, scs, n_seeds):
    """The K8 loop at the solver's shapes, bit for bit against its twin and
    the per-iteration form: P 11 at B 8192, 297 and 1 (m4), 1900 (m5's
    per-cell l_t), P 3 at the seed count, and B 297 with a tol^2 of 1e10
    (every canvas stops after one step); boxes clipped at the image edge.
    The record is the first row's."""
    rows = [k8_loop_row(f"P {p} B {b}" + (" m5, per-cell l_t" if m == 5 else "")
                        + (" tol^2 1e10" if big else ""),
                        k8_loop_args(dev, rng, scs[m], b, m == 5, p,
                                     1e10 if big else None))
            for p, b, m, big in ((11, BSZ, 4, False), (11, 297, 4, False),
                                 (11, 1, 4, False), (11, 1900, 5, False),
                                 (3, n_seeds, 4, False), (11, 297, 4, True))]
    if any(r["iterations"]["1"] != int(r["shape"].split()[3]) for r in rows
           if "tol" in r["shape"]):
        raise AssertionError("K8 loop: a canvas ran past one step under tol^2 1e10")
    return dict(name="csad_patch_loop", route="cuda",
                source="faldoi_tpu_torch/csrc/csad.cu",
                replaces="faldoi_tpu/core/functionals.py:579", library_ms=None,
                **{k: v for k, v in rows[0].items() if k != "iterations"},
                shapes=rows)


# K9's planes each way: the state (11) and the warp constants (8) and g in,
# the state out
K9_PLANES = 11 + 8 + 1 + 11


def k9_patch_row(shape, args):
    """K9's patch form on one call's arguments (three PD iterations at most,
    the local step's cap): bit for bit against its twin, state and
    iteration counts; timed as a graph of 20 calls beside its twin (eager).
    The bound counts the in-box cells of every PD iteration a canvas runs.
    Returns the row."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.occlusion import (
        PD_OPS, occ_patch_loop, occ_patch_loop_plain,
    )

    st, ph, pw = args[0], args[3], args[4]
    got = occ_patch_loop(*args, 3)
    want = occ_patch_loop_plain(*args, 3)
    torch.cuda.synchronize()
    if not (same_bits(got[0], want[0]) and torch.equal(got[1], want[1])):
        d = torch.nan_to_num((got[0] - want[0]).abs(), nan=9.0).max().item()
        raise AssertionError(f"K9 patch form {shape} differs from its twin "
                             f"(max abs {d})")
    iters = got[1]
    cells = int((iters.to(torch.int64) * (ph * pw).to(torch.int64)).sum())
    nb = st.shape[1]
    row = dict(shape=shape, max_abs_err=0.0,
               ms=cuda_ms(lambda: occ_patch_loop(*args, 3), graph=True),
               plain_ms=cuda_ms(lambda: occ_patch_loop_plain(*args, 3), reps=3,
                                warmup=1),
               iterations={str(k): int((iters == k).sum()) for k in range(4)},
               occluded=float(got[0][2].mean()),
               **bound(st[0].numel() * 4 * K9_PLANES + nb * 12, cells * PD_OPS))
    log(f"K9 occ_patch_loop {shape}: bit-exact (iteration counts "
        f"{row['iterations']}, chi 1 at {100 * row['occluded']:.2f}% of the "
        f"cells); kernel {row['ms']:.4f} ms [former design "
        f"{FORMER_K9_MS.get(shape, 'not timed at this shape')}]  twin "
        f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def k9_global_row(shape, args, iters=GLOBAL_TIMED_ITERS):
    """K9's whole-image form, one warp's loop: bit for bit against its twin
    (state and count) over three PD iterations; one call is one kernel node
    of a captured graph; timed eagerly (a cooperative launch, as K5) at
    ``iters`` PD iterations (the tol never met) beside its twin, and at the
    path's 400.  Returns the row."""
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.occlusion import (
        PD_OPS, SCALARS, global_plan, occ_global_loop, occ_global_loop_kernels,
        occ_global_loop_plain,
    )

    st, wc, g, scal = args
    h, w = g.shape
    got, gn = occ_global_loop(st, wc, g, scal, 3)
    want, wn = occ_global_loop_plain(st, wc, g, scal, 3)
    torch.cuda.synchronize()
    if not (same_bits(got, want) and int(gn) == int(wn)):
        d = torch.nan_to_num((got - want).abs(), nan=9.0).max().item()
        raise AssertionError(f"K9 whole-image form {shape} differs from its twin "
                             f"(max abs {d}; iterations {int(gn)} vs {int(wn)})")
    per_call = occ_global_loop_kernels(st, wc, g, scal)
    if per_call != 1:
        raise AssertionError(f"K9 whole-image form {shape}: one call enqueued "
                             f"{per_call} kernels, not 1")
    never = scal.clone()
    never[SCALARS.index("tol2")] = -1.0
    ms = cuda_ms(lambda: occ_global_loop(st, wc, g, never, iters), reps=3,
                 warmup=1)
    row = dict(shape=f"{shape}, {iters} PD iterations", max_abs_err=0.0, ms=ms,
               plain_ms=cuda_ms(lambda: occ_global_loop_plain(st, wc, g, never,
                                                              iters),
                                reps=1, warmup=1),
               per_iter_us=1e3 * ms / iters, launches_per_call=per_call,
               plan=global_plan(h, w),
               **bound(h * w * 4 * K9_PLANES, h * w * iters * PD_OPS))
    if (h, w) == (H, W):
        row["path_call_ms"] = cuda_ms(lambda: occ_global_loop(st, wc, g, never,
                                                              400),
                                      reps=2, warmup=1)
    log(f"K9 occ_global_loop {shape}: bit-exact over 3 PD iterations; one call, "
        f"{per_call} kernel node (a captured call); tiles {row['plan']}; "
        f"{iters} PD iterations {ms:.4f} ms, {row['per_iter_us']:.2f} us an "
        f"iteration [former design: {FORMER_K9_MS.get(shape, 'not timed')} ms an "
        f"iteration, 99 launches]" + (f", 400 iterations (the path's call) "
                                      f"{row['path_call_ms']:.3f} ms"
                                      if "path_call_ms" in row else "")
        + f"  twin {row['plain_ms']:.3f} ms  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def check_k9(dev, n_seeds):
    """K9 at every shape the m8 path launches, bit for bit against its
    twins: the patch form at P 11 with B 8192, 1900, 297 (chi given all 0
    and all 1 too) and 1, at P 3 with the seed count, and under a tol^2
    that stops every canvas after one PD iteration; the whole-image form at
    436x1024 (chi 0, and the known occlusions given), 5x7 and 1088x1920
    (more pixels than the SMs' shared memory holds).  The inputs
    are ``synthetic.occ_patch_inputs`` / ``occ_global_inputs``.  Returns
    the two records (their first rows')."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.occlusion import SCALARS

    rows = []
    for p, b, chi, tol2 in ((11, BSZ, "random", None), (11, 1900, "random", None),
                            (11, 297, "random", None), (11, 297, "zeros", None),
                            (11, 297, "ones", None), (11, 1, "random", None),
                            (3, n_seeds, "random", None),
                            (11, 297, "random", 1e10)):
        args = list(syn.occ_patch_inputs(b, p, SEED + b + p, dev, chi))
        if tol2 is not None:
            args[5][SCALARS.index("tol2")] = tol2
        rows.append(k9_patch_row(f"P {p} B {b}" + ("" if chi == "random" else
                                                    f" chi all {chi}")
                                 + ("" if tol2 is None else " tol^2 1e10"), args))
    if rows[-1]["iterations"]["1"] != 297:
        raise AssertionError("K9: a canvas ran past one step under tol^2 1e10")
    grows = [k9_global_row(f"{h}x{w}" + (" occ_init" if occ else ""),
                           syn.occ_global_inputs(h, w, SEED + h, dev, occ))
             for h, w, occ in ((H, W, False), (H, W, True), (5, 7, True),
                               (1088, 1920, True))]
    src = "faldoi_tpu_torch/csrc/occlusion.cu"
    return [dict(name="occ_patch_loop", route="cuda", source=src,
                 replaces="faldoi_tpu/core/occlusion.py:173", library_ms=None,
                 **{k: v for k, v in rows[0].items() if k != "iterations"},
                 shapes=rows),
            dict(name="occ_global_loop", route="cuda", source=src,
                 replaces="faldoi_tpu/core/occlusion.py:276", library_ms=None,
                 **grows[0], shapes=grows)]


# K10's float operations: a flood step 6 a cell (two differences, two
# squares, a sum, the compare), a relaxation update 7 a hole and plane (the
# Laplacian's multiply and four additions, the step's multiply and add)
K10_OPS_STEP = 6
K10_OPS_RELAX = 7
# K11's a kept-out cell an iteration: 25 taps of two multiply-adds and the
# denominator's add, the clamp and two divisions
K11_OPS_CELL = 25 * 5 + 3


def golden_field(shape, lanes):
    """(L, 2, h, w) planes finite at the golden DeepMatching seed positions
    (clipped to the shape), NaN elsewhere: a sweep's fixed flow at the
    start of a growing."""
    from faldoi_tpu_torch.io.flo import read_flo

    h, w = shape
    gold = os.path.join(HERE, "tests", "golden")
    x = np.full((lanes, 2, h, w), np.nan, np.float32)
    for lane, name in zip(range(lanes), ("deep_mt_1.flo", "deep_mt_2.flo")):
        f = read_flo(os.path.join(gold, name))[:h, :w]
        fin = np.isfinite(f).all(-1)
        x[lane][:, fin] = np.moveaxis(f[fin], -1, 0)
    return x


def k10_bound(x):
    """K10's bound from its input (L, C, h, w): the planes read and written
    once; the flood's steps on every cell, the relaxation on the holes."""
    from faldoi_tpu_torch.cli.kernel_probe import bound
    from faldoi_tpu_torch.ops.poisson import flood_strides

    nl, c, h, w = x.shape
    holes = int((~torch.isfinite(x[:, 0])).sum())
    ops = (8 * len(flood_strides(h, w)) * nl * h * w * K10_OPS_STEP
           + 6 * holes * c * K10_OPS_RELAX)
    return bound(2 * x.numel() * 4, ops)


def check_k10(dev, rng, variants):
    """K10 (the dense fill, one cooperative launch) against its twin on the
    card, bit for bit, at 436x1024, 97x131 and 5x7, L 1 and 2, with no
    finite cell, one, and the golden seed positions; timed at the path's
    shapes, L 2 (the lockstep drains) and L 1 (the final drain) at
    436x1024, golden positions, twice in turns with its former form (one
    launch a flood direction, ``cli/fill_variants.py``), a CUDA graph of 20
    calls each, the finite-set check off."""
    from faldoi_tpu_torch.cli.fill_variants import time_k10
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image, nearest_fill_image_plain

    shapes = []
    rec = None
    for (h, w) in ((H, W), (97, 131), (5, 7)):
        for lanes in (2, 1):
            for kind in ("golden", "one", "none"):
                if kind == "golden":
                    x = golden_field((h, w), lanes)
                else:
                    x = np.full((lanes, 2, h, w), np.nan, np.float32)
                    if kind == "one":
                        x[:, :, h // 2, w // 3] = rng.normal(size=(lanes, 2))
                xg = torch.as_tensor(x, device=dev)
                got = nearest_fill_image(xg)
                want = nearest_fill_image_plain(xg)
                torch.cuda.synchronize()
                if not same_bits(got, want) or not bool(torch.isfinite(got).all()):
                    d = (got - want).abs().max().item()
                    raise AssertionError(f"K10 {kind} L {lanes} {h}x{w} differs "
                                         f"from its twin (max abs {d})")
                if kind != "golden" or h != H:
                    continue
                both = time_k10(variants, xg)
                ms = float(np.mean(both["library"]))
                least = k10_bound(xg)
                row = dict(shape=f"L {lanes} x 2 x {h}x{w}, golden positions",
                           ms=ms, ms_spread=both["library"],
                           former_ms=float(np.mean(both["former"])),
                           former_spread=both["former"], **least)
                shapes.append(row)
                log(f"K10 nearest_fill_image {row['shape']}: bit-exact; "
                    f"{both['library']} ms (graph of 20 calls; former form, one "
                    f"launch a direction: {both['former']} ms)  bound "
                    f"{least['bound_ms']:.4f} ms ({least['bound_by']})")
                if rec is None:
                    plain = cuda_ms(lambda: nearest_fill_image_plain(xg), reps=5)
                    eager = cuda_ms(lambda: nearest_fill_image(xg), reps=10)
                    rec = dict(name="nearest_fill_image", route="cuda",
                               source="faldoi_tpu_torch/csrc/dense_fill.cu",
                               replaces="faldoi_tpu/ops/poisson.py:307",
                               shape=row["shape"], max_abs_err=0.0, ms=ms,
                               ms_spread=row["ms_spread"],
                               former_ms=row["former_ms"], plain_ms=plain,
                               library_ms=None, eager_ms=eager, **least)
    log("K10: bit-exact against its twin at 436x1024, 97x131, 5x7, L 1 and 2, "
        "no finite cell, one, the golden positions")
    rec["shapes"] = shapes
    return rec


def check_k11(dev, rng, i0n, variants):
    """K11 (the bilateral filter, one launch on the 5 colour planes) against
    its twin on the 25 weight planes on the card, bit for bit, at 436x1024
    (the path's frame), 97x131 and 5x7, L 1 and 2, trust at the golden
    positions and half the cells, a few fixed; timed at L 2, 436x1024 (one
    pair's fwd and bwd lanes, as the path calls it), twice in turns with its
    former form (a launch a Jacobi iteration on the 25 planes,
    ``cli/fill_variants.py``), a CUDA graph of 20 calls each, and the host
    set-up once a pair (the 5 colour planes against the former 25 planes)."""
    from faldoi_tpu_torch.cli.fill_variants import time_k11
    from faldoi_tpu_torch.cli.kernel_probe import bound, cuda_ms
    from faldoi_tpu_torch.core.bilateral import (
        bilateral_colour_planes, bilateral_filter_flow,
        bilateral_filter_flow_plain, bilateral_weights,
    )

    rec = None
    for (h, w) in ((H, W), (97, 131), (5, 7)):
        frame = (i0n if h == H else torch.as_tensor(
            rng.random((h, w)).astype(np.float32), device=dev))
        colour = bilateral_colour_planes(frame)
        wts = bilateral_weights(frame, colour)
        for lanes in (2, 1):
            u = torch.as_tensor(rng.normal(size=(2, lanes, h, w)).astype(np.float32)
                                * 3, device=dev)
            trust = np.isfinite(golden_field((h, w), 2)[:lanes, 0])
            trust |= rng.random((lanes, h, w)) < 0.5
            tr = torch.as_tensor(trust.astype(np.int32), device=dev)
            fx = torch.as_tensor((rng.random((lanes, h, w)) < 0.02).astype(np.int32),
                                 device=dev)
            got = bilateral_filter_flow(frame, u[0], u[1], tr, fx, colour=colour)
            want = bilateral_filter_flow_plain(wts, u[0], u[1], tr, fx)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                d = max((a - b).abs().max().item() for a, b in zip(got, want))
                raise AssertionError(f"K11 L {lanes} {h}x{w} differs from its "
                                     f"twin (max abs {d})")
            if rec is not None or h != H:
                continue
            both = time_k11(variants, frame, u[0], u[1], tr, fx)
            ms = float(np.mean(both["library"]))
            plain = cuda_ms(lambda: bilateral_filter_flow_plain(wts, u[0], u[1], tr,
                                                                fx), reps=5)
            open_cells = int(((tr == 0) & (fx == 0)).sum())
            cells = lanes * h * w
            ops = open_cells * K11_OPS_CELL * 10
            # the kernel's inputs (5 colour planes, the flow, the uint8 keep
            # mask) and outputs once; the former count took the 25 weight planes and
            # the int32 trust and fixed masks
            least = bound(colour.numel() * 4 + cells * (2 * 4 + 1) + cells * 2 * 4,
                          ops)
            former = bound(wts.numel() * 4 + cells * (2 * 4 + 4 + 4) + cells * 2 * 4,
                           ops)
            rec = dict(name="bilateral_filter_flow", route="cuda",
                       source="faldoi_tpu_torch/csrc/bilateral.cu",
                       replaces="faldoi_tpu/core/bilateral.py:60",
                       shape=f"L {lanes} x {h}x{w}, 10 iterations",
                       max_abs_err=0.0, ms=ms, ms_spread=both["library"],
                       former_ms=float(np.mean(both["former"])),
                       former_bound_ms=former["bound_ms"],
                       setup_ms=float(np.mean(both["setup"])),
                       former_setup_ms=float(np.mean(both["former_setup"])),
                       plain_ms=plain, library_ms=None, **least)
            log(f"K11 bilateral_filter_flow {rec['shape']}: bit-exact; "
                f"{both['library']} ms (graph of 20 calls; former form, a launch "
                f"an iteration: {both['former']} ms)  twin {plain:.4f} ms  bound "
                f"{least['bound_ms']:.4f} ms ({least['bound_by']}; the former count "
                f"on 25 planes {former['bound_ms']:.4f} ms); host set-up once a "
                f"pair: 5 colour planes {both['setup']} ms, the former 25 weight "
                f"planes {both['former_setup']} ms")
    log("K11: bit-exact against its twin at 436x1024, 97x131, 5x7, L 1 and 2")
    return rec


def replay_k8_path(dev, rng, sc, calls):
    """K8's patch-form work of the m4 path, measured: the loop calls the
    path made (``calls``: (B, P) each) replayed on synthetic canvases of the
    same B and P, through the per-iteration form and through the K8 loop,
    each call timed between CUDA events; returns the two sums in seconds.
    The per-iteration form runs every iteration of every call, the loop
    stops each canvas at its tol as the path's does."""
    from collections import Counter

    from faldoi_tpu_torch.ops.csad import csad_patch_loop

    sums = {"per_iteration": 0.0, "loop": 0.0}
    for p in sorted({cp for _, cp in calls}):
        counts = Counter(b for b, cp in calls if cp == p)
        pool = k8_loop_args(dev, rng, sc, max(counts), p=p)
        for b, k in sorted(counts.items()):
            args = [x[:, :b].contiguous() if x.dim() == 4 else
                    (x[:b].contiguous() if x.dim() else x) for x in pool]
            for name, fn in (("per_iteration", k8_per_iteration_loop),
                             ("loop", csad_patch_loop)):
                fn(*args, 4)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(k):
                    fn(*args, 4)
                end.record()
                torch.cuda.synchronize()
                sums[name] += start.elapsed_time(end) / 1e3
    return sums


def run_slice(i0, i1, go, ba, device, stats, method=0, warm_band=10,
              later=None, iterations=None, **modes):
    """The port's main path: prepare_pair -> match_growing -> the method's
    global step (``models.global_refine``), five warps.  Method 8 takes the
    frames I-1 and I2 as ``later`` and runs as its CLIs do: the growing on
    ``prepare_quad``'s frames, the global step on ``prepare_triple``'s from
    the growing's occlusion mask; both masks go to ``stats["masks"]``.
    ``modes``: the growing's ordering modes and fills (``match_growing``'s
    keywords); ``iterations``: the growing's outer iterations (None: the
    default 3)."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import (
        prepare_pair, prepare_quad, prepare_triple,
    )
    from faldoi_tpu_torch.models import global_refine

    dev = torch.device(device)
    t0 = time.perf_counter()
    quad = {}
    if method == 8:
        a, b, a_1, b2 = prepare_quad(i0, i1, *later, device=device)
        quad = dict(i_1n=a_1, i2n=b2)
    else:
        a, b = prepare_pair(i0, i1, device=device)
    prm = P.Parameters()
    prm.val_method = method
    if iterations is not None:
        prm.iterations_of = iterations
    flow, _, occ = match_growing(go, ba, a, b, prm, bsz=BSZ, stats=stats,
                                 warm_band=warm_band, i0_planes=i0,
                                 i1_planes=i1, **quad, **modes)
    t1 = time.perf_counter()
    prm = P.Parameters()
    prm.warps = P.PAR_DEFAULT_NWARPS_GLOBAL
    if method == 8:
        # global_faldoi's parameters: its PD cap a warp is -glb_iters
        prm = P.init_params(None, P.GLOBAL_STEP)
        prm.iterations_of = P.MAX_ITERATIONS_GLOBAL
        a, b, a_1 = prepare_triple(i0, i1, later[0], device=device)
        quad = dict(i_1n=a_1, occ_init=occ.cpu().numpy())
    u1, u2, chi = global_refine(method, a, b, flow[..., 0].contiguous(),
                                flow[..., 1].contiguous(), prm, stats=stats,
                                i0_planes=i0, **quad)
    if chi is not None:
        stats["masks"] = (occ.cpu().numpy(), chi.cpu().numpy())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stats["seconds"]["global"] = time.perf_counter() - t1
    stats["seconds"]["total"] = time.perf_counter() - t0
    return flow.cpu().numpy(), torch.stack([u1, u2], -1).cpu().numpy()


def write_frames(tmp, *frames):
    """The frames (a pair, or method 8's four) as ``.npy`` frames and their
    list file; returns its path."""
    names = []
    for k, im in enumerate(frames):
        names.append(os.path.join(tmp, f"frame_{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    ims = os.path.join(tmp, "ims.txt")
    with open(ims, "w") as fh:
        fh.write("\n".join(names) + "\n")
    return ims


class k8_loop_calls:
    """While active, keeps (B, P) of every K8 loop call the CSAD solvers
    make (``functionals.csad_patch_loop``), so that the path's patch-form
    work can be replayed and timed afterwards.  Launches are counted as
    ever (by the wrapper it calls)."""

    def __enter__(self):
        from faldoi_tpu_torch.core import functionals

        self.calls, self.inner = [], functionals.csad_patch_loop

        def keep(*args, **kw):
            self.calls.append(tuple(args[0].shape[:2]))
            return self.inner(*args, **kw)

        functionals.csad_patch_loop = keep
        return self.calls

    def __exit__(self, *exc):
        from faldoi_tpu_torch.core import functionals

        functionals.csad_patch_loop = self.inner


class k9_loop_times:
    """While active, keeps (B, P) of every call of K9's patch form that the
    m8 patch solver makes (``occlusion.occ_patch_loop``), with a CUDA event
    recorded on the stream before and after each, so that the path's own
    patch-form time can be summed afterwards (``seconds``; where the card
    waits on the host, the wrapper's host time between the events counts).
    Launches are counted as ever, by the wrapper it calls: the wrapper
    raises the count of its module's name, which is ``keep`` while this is
    active, so ``keep`` hands each launch on to the wrapper's own count."""

    def __enter__(self):
        from faldoi_tpu_torch.core import occlusion

        self.calls, self.events, self.inner = [], [], occlusion.occ_patch_loop

        def keep(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.inner(*args, **kw)
            ev[1].record()
            self.inner.launches += keep.launches
            keep.launches = 0
            self.calls.append(tuple(args[0].shape[1:3]))
            self.events.append(ev)
            return out

        keep.launches = 0
        occlusion.occ_patch_loop = keep
        return self

    def __exit__(self, *exc):
        from faldoi_tpu_torch.core import occlusion

        occlusion.occ_patch_loop = self.inner

    def seconds(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def run_stage_path(method, i0, i1, go, ba, gf, wrappers, later=None,
                   flags=(), tag=None):
    """``local_faldoi -m <method>`` then ``global_faldoi -m <method>`` on the
    card, from the golden-position seeds on the pair written as ``.npy``
    frames; checks the final flow and the method's kernels' launches and
    returns the launches of ``wrappers`` on this path (with K0's planes-form
    launches on the 24 weight planes under ``gather_plane_patches_c24``),
    the path's stats and its seconds.  Method 8 takes (I-1, I2, the known
    occlusions) as ``later``: four frames, and the local and global
    occlusion masks as ``.npy`` (the card's machine has no imaging
    library).  ``flags``: more ``local_faldoi`` flags (the growing's modes),
    ``tag`` the path's name in the log (default m<method>)."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.io.flo import read_flo, write_flo
    from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches

    tag = tag or f"m{method}"
    with tempfile.TemporaryDirectory() as tmp:
        ims = write_frames(tmp, i0, i1, *(later[:2] if later else ()))
        masks = ([os.path.join(tmp, f"occ_{k}.npy") for k in ("rg", "var")]
                 if method == 8 else [])
        seeds = [os.path.join(tmp, f"{k}.flo") for k in ("go", "ba")]
        write_flo(seeds[0], go)
        write_flo(seeds[1], ba)
        rg, var = os.path.join(tmp, "rg.flo"), os.path.join(tmp, "var.flo")
        reset_launches(wrappers)
        gather_plane_patches.launches_by_planes.clear()
        st = {}
        t0 = time.perf_counter()
        rc = local_faldoi.main([ims, *seeds, rg, os.path.join(tmp, "sim.tiff"),
                                *masks[:1], "-m", str(method), "-bsz", str(BSZ),
                                "-device", "cuda", *flags], stats=st)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc = rc or global_faldoi.main([ims, rg, var, *masks, "-m", str(method),
                                       "-device", "cuda"], stats=st)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_launches(wrappers)
        launches["gather_plane_patches_c24"] = gather_plane_patches.launches_by_planes[24]
        if rc != 0:
            raise AssertionError(f"the {tag} stage CLIs exited {rc}")
        rg, var = read_flo(rg), read_flo(var)
        masks = [np.load(m) for m in masks]
    fill = float(np.isfinite(rg).all(-1).mean())
    secs = dict(local=t1 - t0, global_=t2 - t1, total=t2 - t0)
    log(f"{tag} path (local_faldoi -m {method} {' '.join(flags)}, "
        f"global_faldoi -m {method}) "
        f"{H}x{W} SYNTHETIC .npy frames, bsz {BSZ}: local {t1 - t0:.2f} s, "
        f"global {t2 - t1:.2f} s, total {t2 - t0:.2f} s")
    log(f"{tag} growing seconds: " + json.dumps(
        {k: round(v, 3) for k, v in st["seconds"].items()}))
    log(f"{tag} sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"{tag} global PD iterations per warp: {st['global_iters']}")
    log(f"{tag} global stage, host seconds: " + json.dumps(
        {k: round(v, 4) for k, v in st["global_seconds"].items()}))
    log(f"launches on the {tag} path: {json.dumps(launches)}")
    log(f"{tag} fill {100 * fill:.3f}%  rg EPE vs known flow {syn.epe(rg, gf):.4f} "
        f"px  var EPE vs known flow {syn.epe(var, gf):.4f} px (synthetic)")
    if fill < 1.0:
        raise AssertionError(f"{tag} growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError(f"non-finite values in the {tag} final flow")
    if method == 2:
        if st["global_iters"] != [400] * 5:
            raise AssertionError(f"m2 global iterations {st['global_iters']}")
        for name in ("gather_plane_patches_c24", "nltv_patch_loop",
                     "nltv_global_loop"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the m2 path")
        if launches["nltv_global_loop"] != 5:
            raise AssertionError(f"K6 launched {launches['nltv_global_loop']} "
                                 "times, expected 5 (one a warp)")
    if method == 8:
        known = later[2] > 0
        for name, m in zip(("local (rg_occ)", "global (var_occ)"), masks):
            hit = ((m > 0) & known).sum()
            log(f"m8 {name} occlusion mask against the known occlusions "
                f"({100 * known.mean():.3f}% of the pixels): "
                f"{100 * m.mean():.3f}% occluded, recall "
                f"{100 * hit / known.sum():.2f}%, precision "
                f"{100 * hit / max((m > 0).sum(), 1):.2f}%, IoU "
                f"{hit / ((m > 0) | known).sum():.4f}")
            if m.shape != (H, W) or not set(np.unique(m)) <= {0, 1}:
                raise AssertionError(f"m8 {name} mask is not a binary {H}x{W} image")
        iters = st["global_iters"]
        if len(iters) != 5 or not all(0 < k <= 400 for k in iters):
            raise AssertionError(f"m8 global iterations {iters}")
        for name in ("occ_patch_loop", "occ_global_loop", "gather_plane_patches",
                     "gather_patches", "bicubic_sample_patches",
                     "bicubic_warp_planes"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the m8 path")
        # K9's whole-image form: one launch a global warp
        if launches["occ_global_loop"] != len(iters):
            raise AssertionError(f"K9's whole-image form launched "
                                 f"{launches['occ_global_loop']} times, not once "
                                 f"for each of the {len(iters)} global warps")
    if method == 4:
        iters = st["global_iters"]
        if len(iters) != 5 or not all(0 < k <= 400 for k in iters):
            raise AssertionError(f"m4 global iterations {iters}")
        for name in ("csad_vstep", "csad_patch_loop", "gather_plane_patches",
                     "gather_patches", "bicubic_sample_patches",
                     "bicubic_warp_planes"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the m4 path")
        # K8: one launch a PD iteration of every global warp and no other
        # (the patch solves run the K8 loop)
        if launches["csad_vstep"] != sum(iters):
            raise AssertionError(f"K8 launched {launches['csad_vstep']} times, "
                                 f"not the {sum(iters)} global PD iterations")
    return launches, st, secs


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


def run_f2_path(i0, i1, go, ba, gf, wrappers):
    """F2: ``match_growing(fill="dense", bilateral=True)`` then
    ``tvl2_global`` on the card from the golden-position seeds; checks the
    final flow, K10's launches (one a sweep that accepts, all lanes in one)
    and K11's (one a prune: both lanes of the pair in one); returns the
    launches of ``wrappers``."""
    from faldoi_tpu_torch import synthetic as syn

    reset_launches(wrappers)
    st = {}
    rg, var = run_slice(i0, i1, go, ba, "cuda", st, **F2_MODES)
    launches = read_launches(wrappers)
    fill = float(np.isfinite(rg).all(-1).mean())
    log(f"F2 path (match_growing {F2_MODES}, tvl2_global) {H}x{W} SYNTHETIC, "
        f"bsz {BSZ}: seconds " + json.dumps(
            {k: round(v, 3) for k, v in st["seconds"].items()}))
    log(f"F2 sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"F2 global PD iterations per warp: {st['global_iters']}")
    log(f"launches on the F2 path: {json.dumps(launches)}")
    log(f"F2 fill {100 * fill:.3f}%  rg EPE vs known flow {syn.epe(rg, gf):.4f} "
        f"px  var EPE vs known flow {syn.epe(var, gf):.4f} px (synthetic); "
        f"sha256 rg {digest(rg)}, var {digest(var)}")
    if fill < 1.0:
        raise AssertionError(f"F2 growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in the F2 final flow")
    drains = {}
    for s in st["sweeps"]:
        drains[s["it"]] = max(drains.get(s["it"], 0), s["sweeps"])
    fills = sum(k - 1 for k in drains.values())
    if launches["nearest_fill_image"] != fills:
        raise AssertionError(f"K10 launched {launches['nearest_fill_image']} "
                             f"times on F2, not once for each of its {fills} "
                             "sweeps that accepted")
    if launches["bilateral_filter_flow"] != len(drains) - 1:
        raise AssertionError(f"K11 launched {launches['bilateral_filter_flow']} "
                             f"times on F2, not once a prune ({len(drains) - 1})")
    return launches


def run_sift_path(i0, i1, gf, wrappers):
    """``faldoi_sift -vm 1 -device cuda`` on the pair written as ``.npy``
    frames; checks the final flow and returns the launches of ``wrappers``
    on this path."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli import faldoi_sift
    from faldoi_tpu_torch.io.flo import read_flo

    with tempfile.TemporaryDirectory() as tmp:
        ims = write_frames(tmp, i0, i1)
        res = os.path.join(tmp, "out") + os.sep
        reset_launches(wrappers)
        st = {}
        t0 = time.perf_counter()
        rc = faldoi_sift.main([ims, "-vm", "1",
                               "-device", "cuda", "-bsz", str(BSZ),
                               "-res_path", res], stats=st)
        secs = time.perf_counter() - t0
        launches = read_launches(wrappers)
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


def pairs_data(data, npairs):
    """``npairs`` synthetic pairs: pair 0 is the m0 path's (frames and
    seeds); pair k > 0 is ``make_pair`` of seed SEED + k, seeded at the same
    golden positions from its own known flows, 5% moved 3-6 px, from
    ``default_rng(SEED + k)``.  Each: (i0, i1, go, ba, known forward flow)."""
    from faldoi_tpu_torch import synthetic as syn

    i0, i1, gf, _, pos_f, pos_b, go, ba, _ = data
    out = [(i0, i1, go, ba, gf)]
    for k in range(1, npairs):
        a0, a1, f, b = syn.make_pair(H, W, seed=SEED + k)
        rng = np.random.default_rng(SEED + k)
        out.append((a0, a1, syn.make_seeds(f, pos_f, rng),
                    syn.make_seeds(b, pos_b, rng), f))
    return out


def run_pairs(pairs, wrappers):
    """Pairs mode as a user runs it: ``prepare_pair`` of each pair,
    ``match_growing_pairs`` at bsz ``BSZ``, then the global step of each
    pair as ``run_slice`` runs it.  Returns (final flows, growings' flows,
    stats, seconds, launches)."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import global_refine

    reset_launches(wrappers)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [prepare_pair(p[0], p[1], device="cuda") for p in pairs]
    outs = match_growing_pairs([(p[2], p[3]) for p in pairs], frames,
                               P.Parameters(), bsz=BSZ, stats=st,
                               planes_pairs=[(p[0], p[1]) for p in pairs])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prm = P.Parameters()
    prm.warps = P.PAR_DEFAULT_NWARPS_GLOBAL
    finals = []
    for (a, b), (flow, _, _), p in zip(frames, outs, pairs):
        u1, u2, _ = global_refine(0, a, b, flow[..., 0].contiguous(),
                                  flow[..., 1].contiguous(), prm, stats={},
                                  i0_planes=p[0])
        finals.append(torch.stack([u1, u2], -1).cpu().numpy())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches(wrappers)
    return (finals, [o[0].cpu().numpy() for o in outs], st,
            dict(growing=t1 - t0, total=t2 - t0), launches)


def run_pairs_phase(data, var0, wrappers):
    """Pairs mode at N in ``PAIRS_N``: every pair's final flow must equal
    bit for bit its own single-pair ``run_slice`` (pair 0: ``var0``, the m0
    path's), and every growing must fill 100%.  Logs s/pair, sweeps per
    lane and launches per wrapper; returns the launches of the largest N."""
    from faldoi_tpu_torch import synthetic as syn

    pairs = pairs_data(data, max(PAIRS_N))
    singles = [var0]
    t0 = time.perf_counter()
    for p in pairs[1:]:
        singles.append(run_slice(*p[:4], "cuda", {})[1])
    log(f"pairs: single-pair runs of pairs 1-{len(pairs) - 1} (the m0 path's "
        f"calls) {time.perf_counter() - t0:.2f} s")
    launches = None
    for npairs in PAIRS_N:
        finals, rgs, st, secs, launches = run_pairs(pairs[:npairs], wrappers)
        same = [same_bits(torch.as_tensor(f), torch.as_tensor(s))
                for f, s in zip(finals, singles)]
        fills = [float(np.isfinite(r).all(-1).mean()) for r in rgs]
        log(f"pairs mode N {npairs} ({2 * npairs} lanes), {H}x{W} SYNTHETIC m0, "
            f"bsz {BSZ}: growing {secs['growing']:.3f} s, total (prepare, "
            f"growing, global) {secs['total']:.3f} s, {secs['total'] / npairs:.3f} "
            f"s/pair; growing seconds "
            + json.dumps({k: round(v, 3) for k, v in st["seconds"].items()}))
        log(f"pairs N {npairs} sweeps per lane: {json.dumps(st['sweeps'])}")
        log(f"pairs N {npairs} launches: {json.dumps(launches)}")
        log(f"pairs N {npairs}: each pair's final flow bit-equal to its single-pair "
            f"run: {same}; fill {[round(100 * f, 3) for f in fills]}%; var EPE vs "
            f"known flow {[round(syn.epe(f, p[4]), 4) for f, p in zip(finals, pairs)]} "
            "px (synthetic)")
        if not all(same):
            raise AssertionError(f"pairs mode N {npairs}: a pair's final flow "
                                 "differs from its single-pair run")
        if min(fills) < 1.0:
            raise AssertionError(f"pairs mode N {npairs} filled {fills}")
        for name in PAIRS_KERNELS:
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched in pairs mode")
    return launches


def quad_frames():
    """Method 8's frames I-1 and I2 of the synthetic sequence (``SEED``,
    I0 and I1 are the pair's) and the known occlusions of I0."""
    from faldoi_tpu_torch import synthetic as syn

    _, _, i_1, i2, _, _, occ = syn.make_quad(H, W, seed=SEED)
    return i_1, i2, occ


def make_data():
    """The synthetic pair, its known flows and the seeds at the golden
    positions, made from ``SEED``: (i0, i1, gf, gb, pos_f, pos_b, go, ba,
    rng), the rng where the seeds left it."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.io.flo import read_flo

    rng = np.random.default_rng(SEED)
    i0, i1, gf, gb = syn.make_pair(H, W, seed=SEED)
    gold = os.path.join(HERE, "tests", "golden")
    pos_f = syn.seed_positions_from_flo(read_flo(os.path.join(gold, "deep_mt_1.flo")), H, W)
    pos_b = syn.seed_positions_from_flo(read_flo(os.path.join(gold, "deep_mt_2.flo")), H, W)
    go = syn.make_seeds(gf, pos_f, rng)
    ba = syn.make_seeds(gb, pos_b, rng)
    return i0, i1, gf, gb, pos_f, pos_b, go, ba, rng


def crop_of(data, shape):
    i0, i1, _, _, _, _, go, ba, _ = data
    ch, cw = shape
    cut = (slice(0, ch), slice(0, cw))
    return i0[:, :ch, :cw], i1[:, :ch, :cw], go[cut], ba[cut]


def later_crop(later, shape):
    """Method 8's I-1 and I2 cut to the crop ``shape``."""
    ch, cw = shape
    return tuple(f[:, :ch, :cw] for f in later[:2])


def cpu_crop(method, band, ch, cw, out):
    """A child process's job: the ch x cw crop of ``method`` through the CPU
    twins, one thread; writes rg, var, the sweeps and method 8's masks to
    ``out`` (.npz)."""
    torch.set_num_threads(1)
    st = {"seconds": {}}
    t0 = time.perf_counter()
    later = later_crop(quad_frames(), (ch, cw)) if method == 8 else None
    rg, var = run_slice(*crop_of(make_data(), (ch, cw)), "cpu", st, method, band,
                        later)
    masks = st.get("masks", (np.zeros(0), np.zeros(0)))
    np.savez(out, rg=rg, var=var, sweeps=[s["sweeps"] for s in st["sweeps"]],
             seconds=time.perf_counter() - t0, occ_rg=masks[0], occ_var=masks[1])
    return 0


def cpu_mode_crop(name, out):
    """A child process's job: the m0 crop of the growing's mode ``name``
    (``MODE_CROPS``) through the CPU twins, one thread; writes rg, var and
    the sweeps to ``out`` (.npz)."""
    torch.set_num_threads(1)
    band, iters, shape, modes = MODE_CROPS[name]
    st = {"seconds": {}}
    t0 = time.perf_counter()
    rg, var = run_slice(*crop_of(make_data(), shape), "cpu", st, 0, band,
                        iterations=iters, **modes)
    np.savez(out, rg=rg, var=var, sweeps=[s["sweeps"] for s in st["sweeps"]],
             seconds=time.perf_counter() - t0)
    return 0


def start_cpu_mode_crops(tmp):
    """Start one child process a mode crop (``cpu_mode_crop``), with no card
    in sight; returns {name: (process, output path)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    jobs = {}
    for name in MODE_CROPS:
        out = os.path.join(tmp, f"mode_{name}.npz")
        jobs["mode_" + name] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-mode-crop", name,
             out], env=env, cwd=HERE), out)
    return jobs


def check_mode_crops(data, jobs):
    """Each mode crop on the card against its CPU twins' run (a child
    process), bit for bit, with the same sweeps."""
    from faldoi_tpu_torch import synthetic as syn

    for name, (band, iters, shape, modes) in MODE_CROPS.items():
        st = {}
        t0 = time.perf_counter()
        rg, var = run_slice(*crop_of(data, shape), "cuda", st, 0, band,
                            iterations=iters, **modes)
        card_s = time.perf_counter() - t0
        proc, out = jobs["mode_" + name]
        t0 = time.perf_counter()
        if proc.wait() != 0:
            raise AssertionError(f"the CPU mode crop {name} exited {proc.returncode}")
        cpu = np.load(out)
        sweeps = [s["sweeps"] for s in st["sweeps"]]
        same = (np.array_equal(rg.view(np.int32), cpu["rg"].view(np.int32))
                and np.array_equal(var.view(np.int32), cpu["var"].view(np.int32)))
        log(f"mode crop {shape[0]}x{shape[1]} m0 {name} warm_band {band}, "
            f"{iters} outer iteration(s): card "
            f"{card_s:.2f} s, sweeps {sweeps}; CPU twins {float(cpu['seconds']):.2f} "
            f"s, waited {time.perf_counter() - t0:.2f} s; card vs CPU bit for bit: "
            f"{same}; fill {100 * float(np.isfinite(rg).all(-1).mean()):.1f}%")
        if not same or sweeps != cpu["sweeps"].tolist():
            raise AssertionError(f"mode crop {name}: the card's flow or sweeps "
                                 f"differ from the CPU twins' (rg EPE "
                                 f"{syn.epe(rg, cpu['rg'])}, var EPE "
                                 f"{syn.epe(var, cpu['var'])})")


def start_cpu_crops(tmp):
    """Start one child process a crop (``cpu_crop``), with no card in sight;
    returns {method: (process, output path)}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    jobs = {}
    for method, band, (ch, cw) in CROPS:
        out = os.path.join(tmp, f"crop_m{method}.npz")
        jobs[method] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-crop", str(method),
             str(band), str(ch), str(cw), out], env=env, cwd=HERE), out)
    return jobs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        try:
            return run_all(jobs, tmp)
        finally:
            for proc, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def run_all(jobs, tmp):
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.functionals import make_solver_consts, nltv_patch_loop
    from faldoi_tpu_torch.core.global_step import global_pd_loop
    from faldoi_tpu_torch.core.global_step_nltv import nltv_global_loop
    from faldoi_tpu_torch.core.occlusion import occ_global_loop, occ_patch_loop
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.kernels import build as kb
    from faldoi_tpu_torch.models import method_local_params
    from faldoi_tpu_torch.ops.csad import csad_patch_loop, csad_vstep
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_patches, bicubic_warp_planes,
    )
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_plane_patches
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image
    from faldoi_tpu_torch.core.bilateral import bilateral_filter_flow

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # phase 2: build the kernels from the checkout's sources (in parallel),
    # and beside them K10's and K11's former forms, which phase 3 times
    from concurrent.futures import ThreadPoolExecutor

    from faldoi_tpu_torch.cli.fill_variants import build_variants

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        former = pool.submit(build_variants)
        path = kb.build(verbose=True)
        kb.library()
        fill_lib = former.result()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(path, HERE)} "
        "(and csrc/variants/fill_variants.cu)")

    # the synthetic pair and the golden seed positions; the CSAD crops'
    # CPU twins start in child processes at once and run beside the card
    data = make_data()
    i0, i1, gf, gb, pos_f, pos_b, go, ba, rng = data
    log(f"data: SYNTHETIC textured pair {H}x{W} (seed {SEED}), known flow "
        f"bg {syn.BG_FLOW} / rect {syn.FG_FLOW}; seeds at the golden positions: "
        f"{len(pos_f)} fwd, {len(pos_b)} bwd, 5% perturbed 3-6 px")
    jobs.update(start_cpu_crops(tmp))

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
    # phase 3: each path kernel against its twin on the card
    a, b = prepare_pair(i0, i1, device="cuda")
    kernels = [*check_k0(dev, rng, len(pos_f)), *check_k4_warp(dev, rng),
               check_k4_patches(dev, rng), *check_lanes(dev, rng),
               check_k5(dev, rng, a, b, gf)]
    scs = nltv_local_consts(a, b, i0, i1)
    planes_rec = [k for k in kernels if k["name"] == "gather_plane_patches"][0]
    planes_rec["shapes"] = planes_rec["shapes"] + check_k0_c24(dev, rng, scs[2],
                                                               len(pos_f))
    kernels += [check_k6(dev, rng, a, b, gf, i0), check_k7(dev, rng, scs, len(pos_f))]
    del scs
    sc45 = {m: make_solver_consts(a, b, *method_local_params(m, 5), 0.01, 11, m)
            for m in (4, 5)}
    kernels += [check_k8(dev, rng, a, b, gf, sc45),
                check_k8_loop(dev, rng, sc45, len(pos_f)),
                *check_k9(dev, len(pos_f)), check_k10(dev, rng, fill_lib),
                check_k11(dev, rng, a, fill_lib)]
    later = quad_frames()

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 3b")
    # phase 3b: the probe kernels P1-P3 against their twins
    from faldoi_tpu_torch.cli import kernel_probe as kp

    probe_recs = kp.run_probes(dev, np.random.default_rng(SEED))
    for r in probe_recs:
        log(kp.describe(r))

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
    # phase 4: crops through the CPU twins (the child processes) and
    # through the card, m0, m2, m4, m6 and m8 with the warm requeue, m1, m3,
    # m5 and m7 with the cold one; the CSAD and m8 crops must agree exactly
    for method, band, shape in CROPS:
        st = {}
        t0 = time.perf_counter()
        rg, var = run_slice(*crop_of(data, shape), "cuda", st, method, band,
                            later_crop(later, shape) if method == 8 else None)
        card_s = time.perf_counter() - t0
        proc, out = jobs[method]
        t0 = time.perf_counter()
        if proc.wait() != 0:
            raise AssertionError(f"the CPU crop of m{method} exited {proc.returncode}")
        cpu = np.load(out)
        e_rg, e_var = syn.epe(rg, cpu["rg"]), syn.epe(var, cpu["var"])
        csad = method in EXACT_CROPS
        log(f"crop {shape[0]}x{shape[1]} m{method} warm_band {band}: card "
            f"{card_s:.2f} s, sweeps {[s['sweeps'] for s in st['sweeps']]}; CPU "
            f"twins (a child process, one thread) {float(cpu['seconds']):.2f} s, "
            f"sweeps {cpu['sweeps'].tolist()}, waited {time.perf_counter() - t0:.2f} "
            f"s; card vs CPU twins: rg EPE {e_rg:.3e} px, final (var) EPE "
            f"{e_var:.3e} px ({'must be 0' if csad else 'bound 0.01'})")
        if csad and not (e_rg == 0.0 and e_var == 0.0
                         and np.array_equal(np.isnan(rg), np.isnan(cpu["rg"]))):
            raise AssertionError(f"crop m{method} card vs CPU: rg EPE {e_rg}, "
                                 f"final EPE {e_var}, expected 0")
        if method == 8:
            same = [np.array_equal(m, cpu[k]) for m, k in
                    zip(st["masks"], ("occ_rg", "occ_var"))]
            log(f"crop m8 occlusion masks (rg, var) card vs CPU twins equal: "
                f"{same}; occluded {[float(m.mean()) for m in st['masks']]}")
            if not all(same):
                raise AssertionError("crop m8: the card's occlusion masks differ "
                                     "from the CPU twins'")
        if not e_var <= 0.01:
            raise AssertionError(f"crop m{method} card vs CPU: final EPE "
                                 f"{e_var} > 0.01")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
    # phase 5: the full m0 main path on the card, counting launches
    # K4's point form comes last: it is counted to show that no path
    # launches it any more (the whole-image warps take the flow form)
    wrappers = (gather_patches, gather_plane_patches, bicubic_warp_planes,
                bicubic_sample_patches, global_pd_loop, nltv_global_loop,
                nltv_patch_loop, csad_vstep, csad_patch_loop, occ_patch_loop,
                occ_global_loop, nearest_fill_image, bilateral_filter_flow,
                bicubic_sample)
    reset_launches(wrappers)
    st = {}
    with fb_warps() as fb_m0:
        rg, var = run_slice(i0, i1, go, ba, "cuda", st)
    launches_m0 = read_launches(wrappers)
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5a")
    # phase 5a: pairs mode, N = 1, 2 and 4 synthetic pairs grown together,
    # each pair's final flow bit for bit that of its own single-pair run
    # (pair 0's is the m0 path's), counting launches
    launches_pairs = run_pairs_phase(data, var, wrappers)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5b")
    # phase 5b: the m2 (NLTV-L1) and m4 (TV-CSAD) paths through the stage
    # CLIs at full width, counting launches; the K8 loop's (B, P) are kept
    # on the m4 path
    launches_m2, _, _ = run_stage_path(2, i0, i1, go, ba, gf, wrappers)
    with k8_loop_calls() as loop_calls:
        launches_m4, st_m4, _ = run_stage_path(4, i0, i1, go, ba, gf, wrappers)
    loop_calls = [c for c in loop_calls if c[0] > 0]
    if launches_m4["csad_patch_loop"] != len(loop_calls):
        raise AssertionError(f"the K8 loop launched {launches_m4['csad_patch_loop']} "
                             f"times on the m4 path, not once for each of its "
                             f"{len(loop_calls)} solve batches a warp")
    bs = sorted(b for b, _ in loop_calls)
    log(f"K8 on the m4 path: {len(loop_calls)} K8 loop calls, one a patch solve "
        f"batch a warp (B min {bs[0]}, median {bs[len(bs) // 2]}, max {bs[-1]}, "
        f"sum {sum(bs)}; {sum(p == 3 for _, p in loop_calls)} at P 3), and "
        f"{launches_m4['csad_vstep']} whole-image K8 calls (one a global PD "
        "iteration)")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5c")
    # phase 5c: the m8 (TV-L1 with occlusions) path through the stage CLIs
    # at full width on the four-frame sequence, counting launches; K9's
    # patch-form calls timed where they run
    with k9_loop_times() as k9_path:
        launches_m8, _, _ = run_stage_path(8, i0, i1, go, ba, gf, wrappers, later)
    k9_calls = [c for c in k9_path.calls if c[0] > 0]
    if launches_m8["occ_patch_loop"] != len(k9_calls):
        raise AssertionError(f"K9's patch form launched "
                             f"{launches_m8['occ_patch_loop']} times on the m8 "
                             f"path, not once for each of its {len(k9_calls)} "
                             f"solve batches a warp")
    k9_s = k9_path.seconds()
    bs9 = sorted(b for b, _ in k9_calls)
    log(f"K9 on the m8 path: {len(k9_calls)} patch-form calls, one a patch "
        f"solve batch a warp (B min {bs9[0]}, median {bs9[len(bs9) // 2]}, max "
        f"{bs9[-1]}, sum {sum(bs9)}; {sum(p == 3 for _, p in k9_calls)} at P 3), "
        f"{k9_s:.4f} s in all between CUDA events around each call; "
        f"{launches_m8['occ_global_loop']} whole-image launches (one a global "
        "warp)")
    with open(os.path.join(HERE, "faldoi_tpu_torch", "cli",
                           "k9_m8_calls.json")) as fh:
        listed = [tuple(c) for c in json.load(fh)]
    log("K9's m8 path calls " + ("match" if [tuple(c) for c in k9_calls] == listed
                                 else "DIFFER FROM")
        + f" cli/k9_m8_calls.json ({len(listed)} calls), the list that "
        "k9_variants replays")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 5d")
    # phase 5d: the growing's modes at full width.  F1, the parity frontier:
    # local_faldoi -m 0 -warm_band 0 -relax_late 1 -polish 1, then
    # global_faldoi; F2: match_growing(fill="dense", bilateral=True), then
    # tvl2_global, K10 once a non-empty sweep and K11 once a prune
    launches_f1, st_f1, _ = run_stage_path(0, i0, i1, go, ba, gf, wrappers,
                                           flags=F1_FLAGS, tag="F1")
    if not {"polish_it1", "polish_it2", "polish_final"} <= set(st_f1["seconds"]):
        raise AssertionError("F1: the polish passes did not run")
    launches_f2 = run_f2_path(i0, i1, go, ba, gf, wrappers)

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
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

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
    # phase 7: frames to flow, faldoi_sift -vm 1 at full width, counting
    # launches
    with fb_warps() as fb_sift:
        launches_sift = run_sift_path(i0, i1, gf, wrappers)

    # the growing's mode crops: their CPU twins start now, after the paths
    # (which are host-bound and would share the cores with them), and are
    # held against the card in phase 9
    jobs.update(start_cpu_mode_crops(tmp))
    log(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
    # phase 8: K4's flow form on the flows the two paths gave the FB check,
    # the K8 loop at the m4 path's median B, and the m4 path's loop calls
    # replayed through the per-iteration form and the loop (after the
    # paths, so these launches are in no path's count)
    flow_rec = [k for k in kernels if k["name"] == "bicubic_warp_planes"][0]
    flow_rec["shapes"] = (flow_rec["shapes"] + check_k4_path("m0", fb_m0)
                          + check_k4_path("faldoi_sift", fb_sift))
    loop_rec = [k for k in kernels if k["name"] == "csad_patch_loop"][0]
    loop_rec["shapes"].append(k8_loop_row(
        f"P 11 B {bs[len(bs) // 2]} (the m4 path's median)",
        k8_loop_args(dev, rng, sc45[4], bs[len(bs) // 2])))
    t0 = time.perf_counter()
    sums = replay_k8_path(dev, rng, sc45[4], loop_calls)
    loop_rec.update(path_calls=len(loop_calls),
                    path_per_iteration_s=sums["per_iteration"],
                    path_loop_s=sums["loop"])
    k9_rec = [k for k in kernels if k["name"] == "occ_patch_loop"][0]
    k9_rec.update(path_calls=len(k9_calls), path_loop_s=k9_s)
    log(f"K8's patch-form work of the m4 path, its {len(loop_calls)} loop calls "
        f"replayed on synthetic canvases of their B and P, CUDA events around "
        f"each: per-iteration form (K8's patch form and ~20 plain ops an "
        f"iteration, 4 iterations) {sums['per_iteration']:.4f} s, the K8 loop "
        f"{sums['loop']:.4f} s ({time.perf_counter() - t0:.1f} s)")

    log(f"[{time.perf_counter() - t_start:.1f} s] phase 9")
    # phase 9: the mode crops on the card against their CPU twins' runs
    check_mode_crops(data, jobs)

    paths = dict(m0=launches_m0, m2=launches_m2, m4=launches_m4,
                 m8=launches_m8, sift=launches_sift, pairs=launches_pairs,
                 f1=launches_f1, f2=launches_f2)
    kernels = [dict(k, launches=(launches_m2 if k["name"] in M2_KERNELS else
                                 launches_m4 if k["name"] in M4_KERNELS else
                                 launches_m8 if k["name"] in M8_KERNELS else
                                 launches_pairs if k["name"] in PAIRS_KERNELS
                                 else launches_f2 if k["name"] in F2_KERNELS
                                 else launches_sift)[k["name"]],
                    **{f"launches_{p}": la[k["name"]] for p, la in paths.items()})
               for k in kernels]
    planes_rec = [k for k in kernels if k["name"] == "gather_plane_patches"][0]
    planes_rec["launches_c24_m2"] = launches_m2["gather_plane_patches_c24"]
    p3 = [r for r in probe_recs if r["name"] == "probe_window_fetch"][-1]
    for r in [r for r in probe_recs if r["name"] != "probe_window_fetch"] + [p3]:
        kernels.append(dict(r, launches=launches_probe[r["name"]]))
    if any(la["bicubic_sample"] for la in paths.values()):
        raise AssertionError("K4's point form was launched on a path: a "
                             "whole-image warp did not take the flow form")
    for k in kernels:
        if k["name"] == "bicubic_sample":
            continue
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on its path")
        if (k["name"] not in M2_KERNELS + M4_KERNELS + M8_KERNELS + F2_KERNELS
                and k.get("launches_m0", 1) <= 0):
            raise AssertionError(f"kernel {k['name']} never launched on the m0 path")

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {k: d[k] for k in KEYS + EXTRA if k in d} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-crop"]:
        sys.path.insert(0, HERE)
        sys.exit(cpu_crop(*map(int, sys.argv[2:6]), sys.argv[6]))
    if sys.argv[1:2] == ["--cpu-mode-crop"]:
        sys.path.insert(0, HERE)
        sys.exit(cpu_mode_crop(sys.argv[2], sys.argv[3]))
    sys.exit(main())

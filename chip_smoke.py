#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``faldoi_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from a checkout of the repo on a machine with one CUDA card and needs no
network.  It builds the hand-written kernels from ``faldoi_tpu_torch/csrc``,
holds each against its plain PyTorch twin at main-path shapes, runs a crop of
the synthetic pair through the port on the CPU (the twins, which the tests
hold against JAX) and on the card, and then drives the whole main path at
436x1024 — seeds -> local growing -> global refinement — on a SYNTHETIC
textured pair with a known two-layer flow, seeded at the positions of the
golden DeepMatching seeds (``tests/golden/deep_mt_{1,2}.flo``).

Every phase prints its own lines; any failure raises (non-zero exit, no
result line).  The line before the last is the kernels' JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024             # the Sintel frame size the golden seeds are on
BSZ = 8192
CROP = (96, 128)             # the CPU-vs-card crop
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check_k0(dev, rng):
    """K0 at the sweep's crop shape, including edge, dump and clamped lanes."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_patches_plain

    p, wr = 11, 5
    stack = torch.as_tensor(rng.standard_normal((H + p, W + p, 5)).astype(np.float32),
                            device=dev)
    stack[torch.as_tensor(rng.random((H + p, W + p, 5)) < 0.05, device=dev)] = float("nan")
    idx = torch.as_tensor(rng.integers(0, H * W, BSZ), device=dev)
    idx[:8] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W, H * W, H * W,
                               H * W - 2, 5 * W], device=dev)   # corners + dump
    _, _, oy, ox, _, _ = patch_geometry(idx, H, W, wr)
    oy, ox = oy.to(torch.int32), ox.to(torch.int32)
    oy[8:12] = torch.as_tensor([-3, H + 50, 0, 2 * H], dtype=torch.int32, device=dev)
    ox[8:12] = torch.as_tensor([W + 40, -7, -1, 0], dtype=torch.int32, device=dev)
    got = gather_patches(stack, oy, ox, p)
    want = gather_patches_plain(stack, oy, ox, p)
    torch.cuda.synchronize()
    same = torch.equal(got.nan_to_num(1234.5), want.nan_to_num(1234.5)) and \
        torch.equal(got.isnan(), want.isnan())
    if not same:
        raise AssertionError("K0 gather_patches differs from its twin")
    ms = cuda_ms(lambda: gather_patches(stack, oy, ox, p))
    plain = cuda_ms(lambda: gather_patches_plain(stack, oy, ox, p))
    log(f"K0 gather_patches (447,1035,5) p=11 B=8192: max_abs_err 0.0 (bit-exact) "
        f"kernel {ms:.4f} ms  twin {plain:.4f} ms")
    return dict(name="gather_patches", route="cuda",
                source="faldoi_tpu_torch/csrc/patch_gather.cu",
                replaces="faldoi_tpu/ops/pallas_sweep.py:49",
                max_abs_err=0.0, ms=ms, plain_ms=plain)


def check_k4(dev, rng):
    """K4 on 3 planes at 436x1024 with flows reaching out of the domain, both
    border modes; and at the patch solver's call shape."""
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_plain, warp_coords,
    )

    planes = torch.as_tensor(rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                             device=dev)
    yy, xx = np.mgrid[0:H, 0:W]
    u = 14 * np.sin(xx / 37.0) + 9 * np.cos(yy / 23.0) + rng.normal(0, 2, (H, W))
    v = 11 * np.cos(xx / 29.0) - 8 * np.sin(yy / 41.0) + rng.normal(0, 2, (H, W))
    uu, vv = warp_coords(torch.as_tensor(u.astype(np.float32), device=dev),
                         torch.as_tensor(v.astype(np.float32), device=dev))
    if not ((uu < 0).any() and (vv < 0).any() and (uu >= W).any() and (vv >= H).any()):
        raise AssertionError("K4 test flow does not leave the domain")
    bound = 1e-5 * float(planes.abs().max())
    worst = 0.0
    for border_out in (True, False):
        d = (bicubic_sample(planes, uu, vv, border_out)
             - bicubic_sample_plain(planes, uu, vv, border_out)).abs().max().item()
        worst = max(worst, d)
        if not d <= bound:
            raise AssertionError(f"K4 border_out={border_out}: {d} > {bound}")
    ms = cuda_ms(lambda: bicubic_sample(planes, uu, vv, True))
    plain = cuda_ms(lambda: bicubic_sample_plain(planes, uu, vv, True), reps=5)
    pu = (torch.rand((BSZ, 11, 11), device=dev) * (W - 1)).contiguous()
    pv = (torch.rand((BSZ, 11, 11), device=dev) * (H - 1)).contiguous()
    d = (bicubic_sample(planes, pu, pv, False)
         - bicubic_sample_plain(planes, pu, pv, False)).abs().max().item()
    if not d <= bound:
        raise AssertionError(f"K4 patch shape: {d} > {bound}")
    worst = max(worst, d)
    pms = cuda_ms(lambda: bicubic_sample(planes, pu, pv, False))
    pplain = cuda_ms(lambda: bicubic_sample_plain(planes, pu, pv, False), reps=5)
    log(f"K4 bicubic_sample 3x436x1024 image warp: max_abs_err {worst:.3e} "
        f"(bound {bound:.3e}) kernel {ms:.4f} ms  twin {plain:.4f} ms; "
        f"patch warp 3x(8192x11x11): kernel {pms:.4f} ms  twin {pplain:.4f} ms")
    return dict(name="bicubic_sample", route="cuda",
                source="faldoi_tpu_torch/csrc/bicubic.cu",
                replaces="faldoi_tpu/ops/bicubic.py:120",
                max_abs_err=worst, ms=ms, plain_ms=plain)


def check_k5(dev, rng, a, b, gf):
    """K5 for one iteration from one state, and a whole tvl2_global."""
    from faldoi_tpu_torch.core.global_step import (
        global_pd_iteration, global_pd_iteration_plain, tvl2_global,
    )
    from faldoi_tpu_torch.synthetic import epe

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).contiguous()

    st = [gf[..., 0], gf[..., 1], gf[..., 0] + rng.normal(0, 0.1, (H, W)),
          gf[..., 1] + rng.normal(0, 0.1, (H, W))]
    st += [rng.uniform(-0.9, 0.9, (H, W)) for _ in range(4)]
    gx, gy = rng.normal(0, 0.05, (H, W)), rng.normal(0, 0.05, (H, W))
    consts = [t(gx), t(gy), t(gx * gx + gy * gy), t(rng.normal(0, 0.1, (H, W)))]
    l_t, theta, tau = float(np.float32(40) * np.float32(0.3)), 0.3, 0.125
    ka = [t(x) for x in st]
    kb_ = [x.clone() for x in ka]
    ea = torch.empty(1, device=dev)
    eb = torch.empty(1, device=dev)
    global_pd_iteration(*ka, *consts, ea, l_t, theta, tau)
    global_pd_iteration_plain(*kb_, *consts, eb, l_t, theta, tau)
    worst = max((x - y).abs().max().item() for x, y in zip(ka + [ea], kb_ + [eb]))
    if not worst <= 1e-5:
        raise AssertionError(f"K5 one iteration: max abs diff {worst} > 1e-5")
    ms = cuda_ms(lambda: global_pd_iteration(*ka, *consts, ea, l_t, theta, tau), reps=50)
    plain = cuda_ms(lambda: global_pd_iteration_plain(*kb_, *consts, eb, l_t, theta,
                                                      tau), reps=20)

    def synced():      # what tvl2_global does: read err after every iteration
        global_pd_iteration(*ka, *consts, ea, l_t, theta, tau)
        ea.item()

    synced_ms = cuda_ms(synced, reps=50)
    # a whole tvl2_global: kernels vs the same run on the twins (CPU)
    f0 = t(gf + rng.normal(0, 0.3, gf.shape))
    t0 = time.perf_counter()
    u1, u2 = tvl2_global(a, b, f0[..., 0].contiguous(), f0[..., 1].contiguous())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c1, c2 = tvl2_global(a.cpu(), b.cpu(), f0[..., 0].cpu().contiguous(),
                         f0[..., 1].cpu().contiguous())
    e = epe(torch.stack([u1, u2], -1).cpu().numpy(), torch.stack([c1, c2], -1).numpy())
    if not e <= 1e-3:
        raise AssertionError(f"tvl2_global card vs CPU twins: EPE {e} > 1e-3")
    log(f"K5 global_pd_iteration 436x1024: max_abs_err {worst:.3e} kernel {ms:.4f} "
        f"ms  twin {plain:.4f} ms; with the host's read of err after each "
        f"iteration {synced_ms:.4f} ms; tvl2_global card vs CPU twins EPE "
        f"{e:.3e} px ({secs:.2f} s on the card)")
    return dict(name="global_pd_iteration", route="cuda",
                source="faldoi_tpu_torch/csrc/global_pd.cu",
                replaces="faldoi_tpu/core/global_step.py:74",
                max_abs_err=worst, ms=ms, plain_ms=plain)


def run_slice(i0, i1, go, ba, device, stats):
    """The port's main path: prepare_pair -> match_growing -> tvl2_global."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    dev = torch.device(device)
    t0 = time.perf_counter()
    a, b = prepare_pair(i0, i1, device=device)
    flow, _ = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ, stats=stats)
    t1 = time.perf_counter()
    u1, u2 = tvl2_global(a, b, flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                         stats=stats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stats["seconds"]["global"] = time.perf_counter() - t1
    stats["seconds"]["total"] = time.perf_counter() - t0
    return flow.cpu().numpy(), torch.stack([u1, u2], -1).cpu().numpy()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.global_step import global_pd_iteration
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.io.flo import read_flo
    from faldoi_tpu_torch.kernels import build as kb
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # phase 2: build the kernels from the checkout's sources
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

    # phase 3: each kernel against its twin on the card
    a, b = prepare_pair(i0, i1, device="cuda")
    kernels = [check_k0(dev, rng), check_k4(dev, rng), check_k5(dev, rng, a, b, gf)]

    # phase 4: one crop through the CPU twins and through the card
    ch, cw = CROP
    cut = (slice(0, ch), slice(0, cw))
    crop = (i0[:, :ch, :cw], i1[:, :ch, :cw], go[cut], ba[cut])
    res = {}
    for device in ("cpu", "cuda"):
        st = {}
        t0 = time.perf_counter()
        res[device] = run_slice(*crop, device, st)
        log(f"crop {ch}x{cw} on {device}: {time.perf_counter() - t0:.2f} s, "
            f"sweeps {[s['sweeps'] for s in st['sweeps']]}")
    e_rg = syn.epe(res["cuda"][0], res["cpu"][0])
    e_var = syn.epe(res["cuda"][1], res["cpu"][1])
    log(f"crop card vs CPU twins: rg EPE {e_rg:.3e} px, final (var) EPE "
        f"{e_var:.3e} px (bound 0.01)")
    if not e_var <= 0.01:
        raise AssertionError(f"crop card vs CPU: final EPE {e_var} > 0.01")

    # phase 5: the full main path on the card, counting launches
    wrappers = (gather_patches, bicubic_sample, global_pd_iteration)
    for fn in wrappers:
        fn.launches = 0
    st = {}
    rg, var = run_slice(i0, i1, go, ba, "cuda", st)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    fill = float(np.isfinite(rg).all(-1).mean())
    secs = {k: round(v, 3) for k, v in st["seconds"].items()}
    log(f"full {H}x{W} SYNTHETIC main path, bsz {BSZ}: seconds {json.dumps(secs)}")
    log(f"sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"global PD iterations per warp: {st['global_iters']}")
    log(f"launches on the main path: {json.dumps(launches)}")
    log(f"fill {100 * fill:.3f}%  rg EPE vs known flow {syn.epe(rg, gf):.4f} px  "
        f"var EPE vs known flow {syn.epe(var, gf):.4f} px (synthetic)")
    for k in kernels:
        k["launches"] = int(launches.get(k["name"], 0))
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the main path")
    if fill < 1.0:
        raise AssertionError(f"growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in the final flow")

    print(json.dumps({"kernels": [
        {k: d[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")} for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
EXTRA = ("launches_m0", "shape", "gbps", "wrapper_ms")


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check_k0(dev, rng):
    """K0 at the sweep's crop shape, including edge, dump and clamped lanes."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
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
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
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
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
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
    log(f"launches on the faldoi_sift path: {json.dumps(launches)}")
    log(f"faldoi_sift fill {100 * fill:.3f}%  rg EPE vs known flow "
        f"{syn.epe(rg, gf):.4f} px  var EPE vs known flow "
        f"{syn.epe(var, gf):.4f} px (synthetic)")
    if fill < 1.0:
        raise AssertionError(f"faldoi_sift growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in faldoi_sift's final flow")
    return launches


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
    kernels = [check_k0(dev, rng), check_k4(dev, rng), check_k5(dev, rng, a, b, gf)]

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
    wrappers = (gather_patches, bicubic_sample, global_pd_iteration)
    for fn in wrappers:
        fn.launches = 0
    st = {}
    rg, var = run_slice(i0, i1, go, ba, "cuda", st)
    launches_m0 = {fn.__name__: fn.launches for fn in wrappers}
    fill = float(np.isfinite(rg).all(-1).mean())
    secs = {k: round(v, 3) for k, v in st["seconds"].items()}
    log(f"full {H}x{W} SYNTHETIC main path (m0), bsz {BSZ}: seconds "
        f"{json.dumps(secs)}")
    log(f"sweeps per drain: {json.dumps(st['sweeps'])}")
    log(f"global PD iterations per warp: {st['global_iters']}")
    log(f"launches on the m0 main path: {json.dumps(launches_m0)}")
    log(f"fill {100 * fill:.3f}%  rg EPE vs known flow {syn.epe(rg, gf):.4f} px  "
        f"var EPE vs known flow {syn.epe(var, gf):.4f} px (synthetic)")
    if fill < 1.0:
        raise AssertionError(f"growing filled {100 * fill:.3f}% < 100%")
    if not np.isfinite(var).all():
        raise AssertionError("non-finite values in the final flow")

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
    launches_sift = run_sift_path(i0, i1, gf, wrappers)

    kernels = [dict(k, launches=launches_sift[k["name"]],
                    launches_m0=launches_m0[k["name"]]) for k in kernels]
    p3 = [r for r in probe_recs if r["name"] == "probe_window_fetch"][-1]
    for r in [r for r in probe_recs if r["name"] != "probe_window_fetch"] + [p3]:
        kernels.append(dict(r, launches=launches_probe[r["name"]]))
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on its path")
        if k.get("launches_m0", 1) <= 0:
            raise AssertionError(f"kernel {k['name']} never launched on the m0 path")

    print(json.dumps({"kernels": [
        {k: d[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms") + EXTRA if k in d}
        for d in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

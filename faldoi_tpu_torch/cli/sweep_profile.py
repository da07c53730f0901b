"""Milliseconds, host ops and kernel launches per sweep of the m0 path.

    python -m faldoi_tpu_torch.cli.sweep_profile [--out sweep_profile.json]

On one CUDA card: the m0 main path's growing (``match_growing`` of the
synthetic 436x1024 pair 0 at bsz 8192, its fwd and bwd lanes in lockstep,
seeded at the golden DeepMatching positions, as ``chip_smoke.py`` runs it)
is stopped after ``WARM`` + 2 ``WINDOW`` sweeps of its first drain.  After
the ``WARM`` sweeps, one window of sweeps is timed on the host clock with a
``torch.cuda.synchronize()`` after each sweep (ms a sweep), and the next
window runs under ``torch.profiler`` (CPU and CUDA activities): the host's
top-level ``aten::`` ops, the kernel launches it issued (``cudaLaunch*``
calls), the kernels the card ran and the card's busy share (the union of
the kernels' intervals over the window's wall time), a sweep each.

Prints the figures as one JSON line; ``--out`` gets them with the card's
name and power limit.  Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

H, W = 436, 1024
BSZ = 8192
WARM, WINDOW = 20, 10
REPO = Path(__file__).resolve().parents[2]
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch")


class _Stop(Exception):
    """Raised by the patched sweep once the windows are done."""


def _m0_pair():
    import numpy as np

    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.io.flo import read_flo

    gold = REPO / "tests" / "golden"
    pos_f = syn.seed_positions_from_flo(read_flo(str(gold / "deep_mt_1.flo")), H, W)
    pos_b = syn.seed_positions_from_flo(read_flo(str(gold / "deep_mt_2.flo")), H, W)
    i0, i1, gf, gb = syn.make_pair(H, W, seed=0)
    rng = np.random.default_rng(0)
    return i0, i1, syn.make_seeds(gf, pos_f, rng), syn.make_seeds(gb, pos_b, rng)


def _busy_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _count(prof, sweeps: int, wall_s: float) -> dict:
    """Per-sweep counts of a profiled window."""
    from torch.autograd import DeviceType

    evs = prof.events()
    host_ops = sum(1 for e in evs if e.device_type == DeviceType.CPU
                   and e.name.startswith("aten::")
                   and (e.cpu_parent is None
                        or not e.cpu_parent.name.startswith("aten::")))
    launches = sum(1 for e in evs if e.device_type == DeviceType.CPU
                   and e.name in LAUNCH_CALLS)
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    names = {}
    for e in kernels:
        short = e.name.split("(")[0][-60:]
        names[short] = names.get(short, 0) + 1
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return dict(host_ops_per_sweep=host_ops / sweeps,
                launches_per_sweep=launches / sweeps,
                kernels_per_sweep=len(kernels) / sweeps,
                copies_per_sweep=(len(dev) - len(kernels)) / sweeps,
                device_busy_share=busy / (wall_s * 1e6),
                profiled_ms_per_sweep=wall_s * 1e3 / sweeps,
                top_kernels={k: v / sweeps for k, v in top})


def profile_m0_sweeps() -> dict:
    """The m0 path's growing up to ``WARM`` + 2 ``WINDOW`` sweeps of its
    first drain: one window timed, the next profiled (the module's
    docstring).  Returns the figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core import local_step
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, go, ba = _m0_pair()
    a, b = prepare_pair(i0, i1, device="cuda")
    prm = P.Parameters()
    prm.val_method = 0
    sweep = local_step.sweep_lanes
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    warm, window = WARM, WINDOW
    rec = dict(n=0, timed=[], accepted=[], profiled_s=0.0)

    def patched(*args, **kw):
        n = rec["n"]
        rec["n"] = n + 1
        if n < warm:
            return sweep(*args, **kw)
        if n == warm + 2 * window:
            raise _Stop
        if n == warm + window:
            torch.cuda.synchronize()
            prof.start()
            rec["t_prof"] = time.perf_counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sweep(*args, **kw)
        torch.cuda.synchronize()
        if n < warm + window:
            rec["timed"].append((time.perf_counter() - t0) * 1e3)
        rec["accepted"].append(int(sum(out[1])))
        if n == warm + 2 * window - 1:
            rec["profiled_s"] = time.perf_counter() - rec["t_prof"]
            prof.stop()
        return out

    local_step.sweep_lanes = patched
    try:
        match_growing(go, ba, a, b, prm, bsz=BSZ, warm_band=10, i0_planes=i0,
                      i1_planes=i1)
        raise RuntimeError(f"the first drain ended before {warm + 2 * window} "
                           "sweeps")
    except _Stop:
        pass
    finally:
        local_step.sweep_lanes = sweep
    timed = rec["timed"]
    return dict(warm=warm, window=window, ms_per_sweep=sum(timed) / len(timed),
                ms_per_sweep_min=min(timed), ms_per_sweep_max=max(timed),
                accepted_per_sweep=sum(rec["accepted"]) / len(rec["accepted"]),
                **_count(prof, window, rec["profiled_s"]))


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep_profile: needs a CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    r = profile_m0_sweeps()
    print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(dict(card=_card_line(), **r), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Milliseconds, host ops and kernel launches per sweep of the m0 path.

    python -m faldoi_tpu_torch.cli.sweep_profile [--out sweep_profile.json]

On one CUDA card: the m0 main path's growing (``match_growing`` of the
synthetic 436x1024 pair 0 at bsz 8192, its fwd and bwd lanes in lockstep,
seeded at the golden DeepMatching positions, as ``chip_smoke.py`` runs it)
is stopped after ``WARM`` + 2 ``WINDOW`` sweeps of its first drain (the
fixed-shape sweeps, ``local_step.sweep_static``).  After the ``WARM``
sweeps, one window of sweeps is timed on the host clock with a
``torch.cuda.synchronize()`` after each sweep (ms a sweep), and the next
window runs under ``torch.profiler`` (CPU and CUDA activities): the host's
top-level ``aten::`` ops, the kernel launches it issued (``cudaLaunch*``
calls), the kernels the card ran and the card's busy share (the union of
the kernels' intervals over the window's wall time), a sweep each.  The
window is left without a synchronize between its sweeps, as the drain runs
them.

``time_sync_sweeps`` runs the whole m0 growing once for each of a list of
host-read intervals (``local_step.SYNC_SWEEPS``) and returns its drains'
seconds, the sweeps they ran and the growing's sha256.

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
    sweep = local_step.sweep_static
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
        if n < warm + window:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = sweep(*args, **kw)
        if n < warm + window:
            torch.cuda.synchronize()
            rec["timed"].append((time.perf_counter() - t0) * 1e3)
            rec["accepted"].append(int(out[1].sum()))
        if n == warm + 2 * window - 1:
            torch.cuda.synchronize()
            rec["profiled_s"] = time.perf_counter() - rec["t_prof"]
            prof.stop()
        return out

    local_step.sweep_static = patched
    try:
        match_growing(go, ba, a, b, prm, bsz=BSZ, warm_band=10, i0_planes=i0,
                      i1_planes=i1)
        raise RuntimeError(f"the first drain ended before {warm + 2 * window} "
                           "sweeps")
    except _Stop:
        pass
    finally:
        local_step.sweep_static = sweep
    timed = rec["timed"]
    return dict(warm=warm, window=window, ms_per_sweep=sum(timed) / len(timed),
                ms_per_sweep_min=min(timed), ms_per_sweep_max=max(timed),
                accepted_per_sweep=sum(rec["accepted"]) / len(rec["accepted"]),
                **_count(prof, window, rec["profiled_s"]))


def time_sync_sweeps(intervals, rounds: int = 1) -> list:
    """The m0 path's growing once for each host-read interval of
    ``intervals`` (``local_step.SYNC_SWEEPS``, each a divisor of ``CHUNK``),
    in turns for ``rounds`` rounds (the order reversed every other round):
    per run the seconds of each drain (``match_growing``'s stats), the sweeps
    each drain ran and its host reads (stats["drain_reads"]), and the sha256
    of the grown flow (the interval must not move it)."""
    import hashlib

    import torch

    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core import local_step
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, go, ba = _m0_pair()
    a, b = prepare_pair(i0, i1, device="cuda")
    prm = P.Parameters()
    prm.val_method = 0
    keep = local_step.SYNC_SWEEPS
    out = []
    order = [(rnd, s) for rnd in range(rounds)
             for s in (intervals if rnd % 2 == 0 else intervals[::-1])]
    try:
        for rnd, s in order:
            if local_step.CHUNK % s:
                raise ValueError(f"{s} does not divide CHUNK {local_step.CHUNK}")
            local_step.SYNC_SWEEPS = s
            st = {}
            flow, _, _ = match_growing(go, ba, a, b, prm, bsz=BSZ, warm_band=10,
                                       i0_planes=i0, i1_planes=i1, stats=st)
            torch.cuda.synchronize()
            drains = {k: round(v, 4) for k, v in st["seconds"].items()
                      if k.startswith("drain")}
            out.append(dict(
                sync_sweeps=s, round=rnd, drain_s=drains,
                drains_total_s=round(sum(drains.values()), 4),
                ran_reads=st["drain_reads"],
                sha256=hashlib.sha256(flow.cpu().numpy().tobytes()).hexdigest()[:16]))
    finally:
        local_step.SYNC_SWEEPS = keep
    return out


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

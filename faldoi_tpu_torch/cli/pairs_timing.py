"""Seconds per pair of pairs mode, and the m0 drains against another tree.

    python -m faldoi_tpu_torch.cli.pairs_timing [--rounds 10] \
        [--parent DIR] [--out pairs_timing.json]

On one CUDA card, in interleaved rounds: N = 1 and N = 4 synthetic 436x1024
m0 pairs (``match_growing_pairs`` at bsz 8192, then ``tvl2_global`` per
pair, as ``chip_smoke.py``'s pairs phase runs them; N = 2 in the first
round), and, with ``--parent``, the m0 path's growing and global step from
the checkout at DIR (``match_growing`` of that tree, run in a worker process
that imports DIR's ``faldoi_tpu_torch``), in the order parent, N 1, N 4 in
even rounds and N 4, N 1, parent in odd ones.  Each timed run follows a
warm-up run of the same work.  Pair 0 is the m0 path's pair (``make_pair``
seed 0, seeds at the golden DeepMatching positions of
``tests/golden/deep_mt_{1,2}.flo`` from the known flows, 5% moved 3-6 px);
pair k is seed k, seeded the same way.

Prints one JSON line per run (s/pair, growing s, the drains' seconds, the
sweeps per lane) and a summary; ``--out`` gets everything, with the card's
name and power limit, the host's CPU model and a device ``copy_`` rate.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

H, W = 436, 1024
BSZ = 8192
REPO = Path(__file__).resolve().parents[2]


def make_pairs(npairs: int, gold: Path):
    """The pairs of the module docstring: (i0, i1, go, ba) each."""
    import numpy as np

    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.io.flo import read_flo

    pos_f = syn.seed_positions_from_flo(read_flo(str(gold / "deep_mt_1.flo")), H, W)
    pos_b = syn.seed_positions_from_flo(read_flo(str(gold / "deep_mt_2.flo")), H, W)
    out = []
    for k in range(npairs):
        i0, i1, gf, gb = syn.make_pair(H, W, seed=k)
        rng = np.random.default_rng(k)
        out.append((i0, i1, syn.make_seeds(gf, pos_f, rng),
                    syn.make_seeds(gb, pos_b, rng)))
    return out


def _global(a, b, flow, i0):
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.models import global_refine

    prm = P.Parameters()
    prm.warps = P.PAR_DEFAULT_NWARPS_GLOBAL
    return global_refine(0, a, b, flow[..., 0].contiguous(),
                         flow[..., 1].contiguous(), prm, stats={}, i0_planes=i0)


def drains(seconds: dict) -> float:
    return sum(v for k, v in seconds.items() if k.startswith("drain"))


def run_pairs(pairs) -> dict:
    """One pairs-mode run over ``pairs``, prepare to final flows."""
    import torch

    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [prepare_pair(p[0], p[1], device="cuda") for p in pairs]
    outs = match_growing_pairs([(p[2], p[3]) for p in pairs], frames,
                               P.Parameters(), bsz=BSZ, stats=st,
                               planes_pairs=[(p[0], p[1]) for p in pairs])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for (a, b), o, p in zip(frames, outs, pairs):
        _global(a, b, o[0], p[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = len(pairs)
    return dict(n=n, s_per_pair=(t2 - t0) / n, total=t2 - t0,
                growing=t1 - t0, drains=drains(st["seconds"]),
                sweeps=[s["sweeps"] for s in st["sweeps"]])


def run_single(pair) -> dict:
    """The m0 path's calls on one pair: ``match_growing`` (a signature every
    tree of the port shares) and the global step."""
    import torch

    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, b = prepare_pair(pair[0], pair[1], device="cuda")
    flow, _, _ = match_growing(pair[2], pair[3], a, b, P.Parameters(), bsz=BSZ,
                               stats=st, i0_planes=pair[0], i1_planes=pair[1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _global(a, b, flow, pair[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(n=1, s_per_pair=t2 - t0, total=t2 - t0, growing=t1 - t0,
                drains=drains(st["seconds"]),
                sweeps=[s["sweeps"] for s in st["sweeps"]])


def worker(root: str, gold: str) -> int:
    """Serve ``run_single`` of pair 0 from the tree at ``root``: one line of
    JSON for each "run" line read."""
    sys.path.insert(0, root)
    import faldoi_tpu_torch

    if not str(Path(faldoi_tpu_torch.__file__).resolve()).startswith(
            str(Path(root).resolve())):
        raise RuntimeError(f"imported {faldoi_tpu_torch.__file__}, not {root}")
    pair = make_pairs(1, Path(gold))[0]
    for line in sys.stdin:
        if line.strip() != "run":
            break
        print(json.dumps(run_single(pair)), flush=True)
    return 0


def host_facts(dev) -> dict:
    """The card's name and power limit, the host's CPU model and a device
    copy_ rate (GB/s, read + write, 1 GiB, mean of 20)."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    cpu = "unknown"
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            cpu = line.split(":", 1)[1].strip()
            break
    a = torch.empty(1 << 28, dtype=torch.float32, device=dev)
    b = torch.empty_like(a)
    for _ in range(3):
        b.copy_(a)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(20):
        b.copy_(a)
    ev[1].record()
    torch.cuda.synchronize()
    gbs = 2 * a.numel() * 4 * 20 / (ev[0].elapsed_time(ev[1]) / 1e3) / 1e9
    return dict(card=smi, cpu=cpu, cpus=os.cpu_count(), copy_gb_s=gbs,
                torch=torch.__version__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--parent", help="a checkout whose m0 growing to time beside")
    ap.add_argument("--gold", default=str(REPO / "tests" / "golden"))
    ap.add_argument("--out")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.gold)
    import torch

    if not torch.cuda.is_available():
        print("pairs_timing: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    facts = host_facts(dev)
    print(json.dumps(facts), flush=True)
    from faldoi_tpu_torch.kernels import build as kb

    kb.library()
    pairs = make_pairs(4, Path(args.gold))
    proc = None
    if args.parent:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(args.parent), "--gold", args.gold],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=args.parent)

    def parent():
        proc.stdin.write("run\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("the parent worker died")
        return json.loads(line)

    jobs = {"parent": parent if proc else None,
            "n1": lambda: run_pairs(pairs[:1]), "n2": lambda: run_pairs(pairs[:2]),
            "n4": lambda: run_pairs(pairs[:4])}
    runs = []
    try:
        for name, fn in jobs.items():            # warm-up, not recorded
            if fn is not None:
                fn()
        for r in range(args.rounds):
            order = ["parent", "n1", "n4"] if r % 2 == 0 else ["n4", "n1", "parent"]
            if r == 0:
                order.append("n2")
            for name in order:
                if jobs[name] is None:
                    continue
                res = dict(jobs[name](), run=name, round=r)
                runs.append(res)
                print(json.dumps(res), flush=True)
    finally:
        if proc is not None:
            proc.stdin.close()
            proc.wait(timeout=60)
    summary = {}
    for name in jobs:
        rs = [x for x in runs if x["run"] == name]
        if rs:
            summary[name] = {k: dict(median=statistics.median(x[k] for x in rs),
                                     min=min(x[k] for x in rs),
                                     max=max(x[k] for x in rs), runs=len(rs))
                             for k in ("s_per_pair", "growing", "drains")}
    print(json.dumps(dict(summary=summary, **facts)), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(facts=facts, runs=runs,
                                                  summary=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K12's and K13's former forms and design variants against the library's
forms on one CUDA card.

    python -m faldoi_tpu_torch.cli.patch_variants [--out FILE.json]

Builds ``csrc/variants/patch_variants.cu`` (the former forms of the TV-L1
patch solve K12 and the canvas Poisson fill K13, and the redesign's
variants; it includes the library's two sources) with the library's nvcc
flags and ``-Xptxas=-v`` into ``faldoi_tpu_torch/_build/``, then, on the
synthetic 436x1024 pair and its patches:

(a) K13, u and v at P 11 with B 16384 (the lockstep sweep's), 8192, 1900,
    577 (the m4 path's median) and 1, red-black and exact, and P 3 at B 1703
    (the seed insertion's), exact: every variant of ``faldoi_k13v_fill``
    held bit for bit to the plain twin (NaN by mask), then timed, a CUDA
    graph of 20 calls each, twice in turns (a, b, .., b, a);
(b) K12 at P 11 with L 2 B 16384 (the lockstep sweep's), B 8192 (m0 and
    m1), L 2 B 1900, L 2 B 297 (m1), B 1 and two warps at B 1900, and P 3 at
    B 1703, one warp of at most 4 PD steps: every variant of
    ``faldoi_k12v_solve`` held bit for bit to the twin but the approximate ones,
    then timed the same way;
(c) the ptxas report of every kernel (registers, stack, spills) and the
    warps an SM then holds;
(d) the SASS (``cuobjdump -sass``) of each form: instructions a lane a step
    (a K13 front or colour, a K12 PD step), a cell a step, and the issue
    floor, warp instructions over 132 SMs x 4 schedulers x the card's
    highest SM clock.  The instructions a warp runs are estimated from the
    static SASS: the whole kernel once, the loops of the steps as many more
    times as they run (K12: the PD loop 4 times a warp; K13: each level's
    relaxation loop niter times, the canvas copies ceil(P^2 / 32) times, the
    former form's front or colour step as many times as a level has them).

Prints the card's name and power limit, the ptxas report and one line a
row; ``--out`` also writes the rows as JSON.  Needs a CUDA card.
``chip_smoke.py`` calls ``build_variants``, ``time_k13`` and ``time_k12``
on its own inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb

H, W = 436, 1024
SRC = kb.CSRC / "variants" / "patch_variants.cu"

# faldoi_k13v_fill's variants (csrc/variants/patch_variants.cu)
K13_VARIANTS = {0: "former", 1: "library", 2: "registers", 3: "no_bound",
                4: "registers_skew"}
# faldoi_k12v_solve's: (name, threads a canvas, cells a thread, canvases a
# block, least blocks an SM, division mode: 0 IEEE, 1 approximate (timing
# only), 2 IEEE without the divisions and root whose results are known
# exactly); variant 0 is the former form, 12 the library's (at every side)
K12_VARIANTS = {
    0: ("former", 128, 1, 2, 4, 0),
    1: ("a_block_1", 128, 1, 1, 8, 0),
    2: ("a_named_2", 128, 1, 2, 4, 0),
    3: ("b_named_2_min5", 128, 1, 2, 5, 0),
    4: ("b_named_2_min6", 128, 1, 2, 6, 0),
    5: ("b_named_2_min8", 128, 1, 2, 8, 0),
    6: ("b_block_1_min12", 128, 1, 1, 12, 0),
    7: ("c_warp", 32, 4, 8, 1, 0),
    8: ("c_warp_min2", 32, 4, 8, 2, 0),
    9: ("c_warp_min3", 32, 4, 8, 3, 0),
    10: ("d_named_2_fast", 128, 1, 2, 4, 1),
    11: ("d_warp_fast", 32, 4, 8, 1, 1),
    12: ("library", 128, 1, 2, 4, 2),
    13: ("c_warp_min2_skip", 32, 4, 8, 2, 2),
}
K12_LIBRARY = 12   # the library's form at every side (launch_library)
FAST = 1
SCHEDULERS = 4


def build_variants():
    """nvcc the variants with ``-Xptxas=-v`` (once for these sources: the
    library and its ptxas report are kept in the build directory under a
    hash of the sources); returns (library, the report's lines)."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(" ".join(kb.NVCC_FLAGS).encode())
    for src in [SRC] + kb.sources() + kb.headers():
        h.update(src.read_bytes())
    out = kb.BUILD_DIR / f"libpatch_variants_{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".ptxas.txt")
    if not (out.is_file() and log.is_file()):
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
               str(kb.CSRC), "-o", str(tmp), str(SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.faldoi_k13v_fill.argtypes = [i] + [p] * 6 + [i] * 3 + [p, i, f, i, i, p]
    lib.faldoi_k12v_solve.argtypes = [i] + [p] * 19 + [i] * 9 + [p]
    for fn in (lib.faldoi_k13v_fill, lib.faldoi_k12v_solve):
        fn.restype = ctypes.c_int
    report = [ln for ln in log.read_text().splitlines()
              if "ptxas" in ln or "bytes stack" in ln]
    return lib, report


def k13_variant(lib, variant: int, planes, ph, pw, exact: bool,
                timestep: float = 0.4, niter: int = 3, scale: int = 7):
    """K13's variant on one or two (B, P, P) planes on the card."""
    from faldoi_tpu_torch.ops.poisson import poisson_fill_args

    args, outs, _keep = poisson_fill_args(tuple(planes), ph, pw, timestep,
                                          niter, scale, exact)
    if args is not None:
        kb.check(lib.faldoi_k13v_fill(variant, *args,
                                      kb.stream_ptr(planes[0].device)),
                 f"k13v_fill {variant}")
    return outs


def k12_variant(lib, variant: int, args):
    """K12's variant on ``tvl1_patch_solve``'s arguments (sc, ci, cj, oy,
    ox, ph, pw, u1, u2, p, warps, max_iters, weighted, lane)."""
    from faldoi_tpu_torch.core.functionals import tvl1_patch_args

    c_args, outs, _keep = tvl1_patch_args(*args)
    if c_args is not None:
        kb.check(lib.faldoi_k12v_solve(variant, *c_args,
                                       kb.stream_ptr(args[7].device)),
                 f"k12v_solve {variant}")
    return outs


def same_nan(a, b):
    """Bit for bit, NaN compared by mask (a NaN's payload may differ)."""
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def turns(runs):
    """Time every run twice in turns (a, b, .., b, a); ms lists by key."""
    out = {}
    for key, fn in list(runs.items()) + list(runs.items())[::-1]:
        out.setdefault(key, []).append(fn())
    return out


def time_k13(lib, planes, ph, pw, exact: bool, variants=(0, 1)) -> dict:
    """K13's variants (names of ``K13_VARIANTS``) on these planes, each held
    bit for bit to the twin first (the library's through
    ``poisson_fill_planes``, its launch count restored), then timed in
    turns, a CUDA graph of 20 calls each; ms lists by name."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.ops.poisson import (
        poisson_fill_canvas_plain, poisson_fill_planes,
    )

    n = len(planes)
    want = poisson_fill_canvas_plain(torch.cat(planes), ph.repeat(n),
                                     pw.repeat(n), exact=exact)
    launches = poisson_fill_planes.launches
    shape = f"{n} x {tuple(planes[0].shape)} exact={exact}"
    got = torch.cat(poisson_fill_planes(planes, ph, pw, exact=exact))
    if not same_nan(got, want):
        raise AssertionError(f"K13 library form differs from its twin at {shape}")
    runs = {}
    for v in variants:
        got = torch.cat(k13_variant(lib, v, planes, ph, pw, exact))
        torch.cuda.synchronize()
        if not same_nan(got, want):
            raise AssertionError(f"K13 variant {K13_VARIANTS[v]} differs from "
                                 f"its twin at {shape}")
        runs[K13_VARIANTS[v]] = (lambda v=v: cuda_ms(
            lambda: k13_variant(lib, v, planes, ph, pw, exact), graph=True))
    ms = turns(runs)
    poisson_fill_planes.launches = launches
    return ms


def time_k12(lib, args, variants=(0, K12_LIBRARY)) -> dict:
    """K12's variants (names of ``K12_VARIANTS``) on ``tvl1_patch_solve``'s
    arguments, each but the approximate ones held bit for bit to the twin first
    (the library's through ``tvl1_patch_solve``, its launch count
    restored), then timed in turns, a CUDA graph of 20 calls each; ms lists
    by name."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, tvl1_patch_solve,
    )

    want = _solve_tvl1_family_plain(*args)
    launches = tvl1_patch_solve.launches
    b, p = args[7].shape[:2]
    shape = f"P {p} B {b}"
    if not all(same_nan(x, y) for x, y in zip(tvl1_patch_solve(*args), want)):
        raise AssertionError(f"K12 library form differs from its twin at {shape}")
    runs = {}
    for v in variants:
        got = k12_variant(lib, v, args)
        torch.cuda.synchronize()
        if K12_VARIANTS[v][5] != FAST and not all(
                same_nan(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K12 variant {K12_VARIANTS[v][0]} differs "
                                 f"from its twin at {shape}")
        runs[K12_VARIANTS[v][0]] = (lambda v=v: cuda_ms(
            lambda: k12_variant(lib, v, args), graph=True))
    ms = turns(runs)
    tvl1_patch_solve.launches = launches
    return ms


def fill_planes(dev, rng, b, p, holes=0.6):
    """u and v at B canvases of side p with ``holes`` of the cells NaN (the
    first canvas centre-only, as the seed insertion's), boxes from
    ``patch_geometry`` of random pixels, the image's corners first."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    idx[:4] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W], device=dev)[:b]
    _, _, _, _, ph, pw = patch_geometry(idx, H, W, p // 2)
    nan = torch.as_tensor(rng.random((b, p, p)) < holes, device=dev)
    nan[0] = True
    nan[0, min(p // 2, int(ph[0]) - 1), min(p // 2, int(pw[0]) - 1)] = False
    u, v = (torch.where(nan, float("nan"), torch.as_tensor(
        rng.uniform(-8, 8, (b, p, p)).astype(np.float32), device=dev))
        for _ in range(2))
    return (u.contiguous(), v.contiguous()), ph, pw


def solve_consts(dev):
    """The synthetic pair's solver consts of methods 0 and 1 at P 11 and 3,
    both directions: {(method, p): [fwd, bwd]}, and the known flow."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    i0, i1, gf, _ = syn.make_pair(H, W, seed=0)
    a, b = prepare_pair(i0, i1, device=dev)
    scs = {(m, p): [make_solver_consts(x, y, *method_local_params(m, 5), 0.01,
                                       p, m) for x, y in ((a, b), (b, a))]
           for m in (0, 1) for p in (11, 3)}
    return scs, gf


def solve_args(dev, rng, scs, gf, b, p, method, lanes, warps=1, max_iters=4):
    """``tvl1_patch_solve``'s arguments at B patches of side p: boxes from
    ``patch_geometry`` of random pixels (corners first), inits of the known
    flow at the cells plus noise, zero outside the box; two lanes stack the
    fwd and bwd consts with a random lane index."""
    from faldoi_tpu_torch.core.functionals import stack_solver_consts
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = torch.as_tensor(rng.integers(0, H * W, b), device=dev)
    idx[:4] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W], device=dev)[:b]
    ci, cj, oy, ox, ph, pw = patch_geometry(idx, H, W, p // 2)
    ar = torch.arange(p, device=dev)
    rows = (oy[:, None, None] + ar[None, :, None]).clamp(0, H - 1)
    cols = (ox[:, None, None] + ar[None, None, :]).clamp(0, W - 1)
    inbox = ((ar[None, :, None] < ph[:, None, None])
             & (ar[None, None, :] < pw[:, None, None]))
    flow = torch.as_tensor(gf, device=dev)
    noise = torch.as_tensor(rng.normal(0, 0.3, (2, b, p, p)).astype(np.float32),
                            device=dev)
    u1, u2 = (torch.where(inbox, flow[rows, cols, k] + noise[k], 0.0).contiguous()
              for k in range(2))
    idx6 = [t.to(torch.int64).contiguous() for t in (ci, cj, oy, ox, ph, pw)]
    sc = scs[(method, p)]
    lane = None
    if lanes == 2:
        sc = stack_solver_consts(sc)
        lane = torch.as_tensor(rng.integers(0, 2, b), device=dev)
    else:
        sc = sc[0]
    return (sc, *idx6, u1, u2, p, warps, max_iters, method == 1, lane)


# (d): the SASS and the issue floors
INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
TARGET = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")
GLOBAL = re.compile(r"(@!?U?P\w+\s+)?(LDG|STG)\b")   # a global load or store


def sass_functions(lib_path):
    """{mangled name: [(address, instruction)]} of a library's SASS."""
    from pathlib import Path

    text = subprocess.run([str(Path(kb._nvcc()).parent / "cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            cur = funcs.setdefault(ln.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = INST.search(ln)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def loop_spans(insts):
    """The loops of a function: its back edges' spans [target, branch] as
    (start, end, instructions inside, whether a global load or store is
    inside), outermost first."""
    spans = set()
    for addr, ins in insts:
        m = TARGET.search(ins)
        if m and int(m.group(1), 16) < addr:
            spans.add((int(m.group(1), 16), addr))
    out = []
    for s, e in spans:
        body = [ins for a, ins in insts if s <= a <= e]
        out.append((s, e, len(body), any(GLOBAL.match(i) for i in body)))
    return sorted(out, key=lambda x: -x[2])


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner != outer


def k12_counts(insts, steps=4):
    """(instructions a thread a PD step, instructions a warp at ``steps``
    steps): the PD loop is the largest loop inside another loop (the warp
    loop)."""
    spans = loop_spans(insts)
    nested = [s for s in spans if any(inside(s, o) for o in spans)]
    pd = (nested or spans)[0][2]
    return pd, len(insts) + (steps - 1) * pd


def k13_counts(insts, sides, exact, niter=3, former=False, p=11):
    """(instructions a lane a step, instructions a warp): the new forms'
    relaxation loops are the loops without a global load or store (one a
    level, its steps unrolled), the canvas copies the loops with one; the
    former form's step is its innermost loop (exact: a front) or half its
    relaxation loop (red-black: two colours unrolled)."""
    spans = loop_spans(insts)
    if former:
        depth = {s: sum(inside(s, o) for o in spans) for s in spans}
        if exact:
            step = min((s for s in spans if depth[s] >= 2), key=lambda s: s[2])[2]
            steps = [2 * s - 1 for s in sides]
        else:
            step = min((s for s in spans if depth[s] >= 1), key=lambda s: s[2])[2] / 2
            steps = [2 for _ in sides]
        return step, len(insts) + sum(niter * n - 1 for n in steps) * step
    relax = [s for s in spans if not s[3] and not any(inside(s, o) for o in spans)]
    copy = [s for s in spans if s[3]]
    fronts = 2 * sides[0] - 1 if exact else 2
    per_step = relax[0][2] / fronts if relax else float("nan")
    copies = math.ceil(p * p / 32) - 1
    return per_step, (len(insts) + (niter - 1) * sum(s[2] for s in relax)
                      + copies * sum(s[2] for s in copy))


def ptxas_kernels(report):
    """{mangled name: dict(registers, stack, spill_stores, spill_loads)}."""
    out, cur = {}, None
    for ln in report:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def warps_an_sm(regs, threads, smem):
    """Warps an H100 SM holds of a kernel: registers (allocated 256 a warp
    at a time), shared memory (228 KB, 1 KB a block reserved), 2048
    threads, 32 blocks."""
    per_warp = math.ceil(regs * 32 / 256) * 256
    wpb = threads // 32
    by_regs = (65536 // per_warp) // wpb
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32) * wpb


def find(funcs, *parts, without=()):
    names = [f for f in funcs if all(x in f for x in parts)
             and not any(x in f for x in without)]
    if len(names) != 1:
        raise KeyError(f"{parts}: {len(names)} kernels")
    return names[0]


def k13_name(variant, p, exact):
    nl = {11: 5, 3: 3}[p]
    e = int(exact)
    if variant == 0:
        return ("former13", f"poisson_fill_kernelILb{e}E"), ()
    if variant in (2, 4):
        return (f"fill_regs_kernelILi{p}ELi{nl}ELb{e}ELb{int(variant == 4)}E",), ()
    m = 1 if variant == 3 else 8
    return (f"poisson_fill_kernelILi{p}ELi{nl}ELb{e}ELi{m}E",), ("former13",)


def k12_name(variant, p=11):
    _, g, cells, cpb, minb, mode = K12_VARIANTS[variant]
    if variant == 0:
        return ("former12", f"tvl1_patch_kernelILi{p}E"), ()
    if p == 3:
        return ("tvl1_patch_kernelILi3ELi32ELi1ELi8ELi2ELi4E",), ("former12",)
    return (f"tvl1_patch_kernelILi11ELi{g}ELi{cells}ELi{cpb}ELi{mode}"
            f"ELi{minb}E",), ("former12",)


def sass_rows(lib_path, report, card, clock_mhz):
    """(c) and (d) for every form at P 11 (and P 3 for the former and the
    library's)."""
    funcs = sass_functions(lib_path)
    regs = ptxas_kernels(report)
    hz = clock_mhz * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = sms * SCHEDULERS * hz / 1e3          # warp instructions a ms
    rows = []
    for p, b, sides in ((11, 8192, [11, 6, 3, 2, 1]), (3, 1703, [3, 2, 1])):
        for exact in (False, True):
            if p == 3 and not exact:
                continue
            for v, name in K13_VARIANTS.items():
                parts, without = k13_name(v, p, exact)
                fn = find(funcs, *parts, without=without)
                step, per_warp = k13_counts(funcs[fn], sides, exact,
                                            former=v == 0, p=p)
                if v == 0:   # a thread a cell, canvases packed in 256 threads
                    cpb = max(256 // (p * p), 1)
                    warps = math.ceil(2 * b / cpb) * math.ceil(cpb * p * p / 32)
                    smem = cpb * sum(s * s for s in sides) * 4
                    threads = math.ceil(cpb * p * p / 32) * 32
                else:        # a warp a patch, 8 a block
                    warps, threads = b, 256
                    smem = 8 * 2 * sum(s * s for s in sides) * 4
                k = regs.get(fn, {})
                row = dict(row="sass", kernel="K13", form=name, p=p, b=b,
                           exact=exact, card=card, clock_mhz=clock_mhz,
                           instructions=len(funcs[fn]), per_lane_step=step,
                           per_warp=per_warp, warps=warps,
                           floor_ms=warps * per_warp / issue, **k,
                           warps_an_sm=(warps_an_sm(k["registers"], threads, smem)
                                        if "registers" in k else None))
                rows.append(row)
    for p, b in ((11, 8192), (3, 1703)):
        # P 11: each layout (the library's is one of them); P 3: the former
        # form and the library's
        forms = (0, K12_LIBRARY) if p == 3 else tuple(K12_VARIANTS)
        for v in forms:
            name, g, cells, cpb, minb, mode = K12_VARIANTS[v]
            parts, without = k12_name(v, p)
            fn = find(funcs, *parts, without=without)
            pd, per_warp = k12_counts(funcs[fn])
            if p == 3:
                g, cells, cpb = 32, 1, 8
            wpc = g // 32                      # warps a canvas
            warps = b * wpc
            smem = cpb * (6 * p * p + 2) * 4
            k = regs.get(fn, {})
            rows.append(dict(row="sass", kernel="K12", form=name, p=p, b=b,
                             card=card, clock_mhz=clock_mhz,
                             instructions=len(funcs[fn]), per_thread_step=pd,
                             per_cell_step=pd * g / (p * p) if cells == 1
                             else pd / cells,
                             per_warp=per_warp, warps=warps,
                             floor_ms=warps * per_warp / issue, **k,
                             warps_an_sm=(warps_an_sm(k["registers"], g * cpb, smem)
                                          if "registers" in k else None)))
    for r in rows:
        print("SASS " + json.dumps(r), flush=True)
    return rows


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


K13_SHAPES = [(11, 16384, False), (11, 16384, True), (11, 8192, False),
              (11, 8192, True), (11, 1900, False), (11, 1900, True),
              (11, 577, False), (11, 577, True), (11, 1, False), (11, 1, True),
              (3, 1703, True)]
# (p, b, method, lanes, warps)
K12_SHAPES = [(11, 16384, 0, 2, 1), (11, 8192, 0, 1, 1), (11, 8192, 1, 1, 1),
              (11, 1900, 0, 2, 1), (11, 297, 1, 2, 1), (11, 1, 0, 1, 1),
              (11, 1900, 0, 1, 2), (3, 1703, 0, 1, 1)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("patch_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0])
    print(card, f"(highest SM clock {clock} MHz, now {smi('clocks.sm')})",
          flush=True)
    lib, report = build_variants()
    print("\n".join(report), flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for p, b, exact in K13_SHAPES:
        planes, ph, pw = fill_planes(dev, rng, b, p)
        ms = time_k13(lib, planes, ph, pw, exact, variants=tuple(K13_VARIANTS))
        row = dict(kernel="K13", shape=f"2 x P {p} B {b} "
                   + ("exact" if exact else "red-black"), card=card, ms=ms)
        print(json.dumps(row), flush=True)
        rows.append(row)
    scs, gf = solve_consts(dev)
    for p, b, method, lanes, warps in K12_SHAPES:
        args = solve_args(dev, rng, scs, gf, b, p, method, lanes, warps)
        variants = tuple(K12_VARIANTS) if p == 11 else (0, K12_LIBRARY)
        ms = time_k12(lib, args, variants=variants)
        row = dict(kernel="K12", shape=f"P {p} B {b} m{method} L {lanes}, "
                   f"{warps} warp(s) x <= 4", card=card, ms=ms)
        print(json.dumps(row), flush=True)
        rows.append(row)
    try:
        rows += sass_rows(lib._name, report, card, clock)
    except Exception as exc:   # the listing's format is the toolkit's
        print(f"SASS analysis failed: {exc!r}", flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(dict(ptxas=report, rows=rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K9's design variants and former forms against each other on one CUDA card.

    python -m faldoi_tpu_torch.cli.k9_variants [--out FILE.json]

Builds ``csrc/variants/k9_variants.cu`` (it includes ``csrc/occlusion.cu``,
so its ``-Xptxas -v`` report covers the library's kernels too) with the
library's nvcc flags into ``faldoi_tpu_torch/_build/`` and measures, each
row twice in turns within this process:

(a) the grid barrier alone: one cooperative launch of 1000 ``grid.sync()``
    at 132 and 264 blocks of 1024 threads, at the blocks K5
    (``global_pd_loop``) launches at 436x1024 (256 threads) and at the
    blocks K9's whole-image form launches there (1024 threads); us a
    barrier;
(b) the patch form at P 11 with B 8192, 1900, 297 and 1 and at P 3 with B
    1703: the library's (a thread a cell, two block barriers an inner step)
    and the variants of ``k9_variants.cu``: 0 (the former library form),
    1 (without the inner barriers) and 2 (square roots and divisions as
    multiplies), both WRONG and timing only, 3 (one barrier an inner step),
    4 (a canvas a warp), 5 (held to 8 blocks an SM); every right one bit for
    bit against its twin; a CUDA graph of 20 calls, three PD iterations at
    most;
(c) the whole-image form at 436x1024: the former (one PD iteration as 99
    plain launches, a graph of 20 calls) against the library's loop (depth
    3: three steps between two exchanges, 1024 threads a block) and the
    same loop at depths 1, 2 and 3 and with 512 threads a block at depths 2
    and 3 (50 PD iterations in one launch, the tol never met; eager), ms a
    PD iteration;
    each held to its twin bit for bit first; and the sum of the m8 path's
    patch-form calls (``k9_m8_calls.json`` beside this file, [B, P] each:
    the 694 calls of the full-width m8 path that ``chip_smoke.py`` drives,
    which are the same every run and which it holds to this list) replayed
    on synthetic canvases of the same B and P through the library's form
    and variants 0 and 3-5, CUDA events around each;
(d) the SASS (``cuobjdump -sass``) of the library's patch form at P 11 and
    P 3 and of variant 4: instructions a thread a PD iteration, read off the
    loops (the two 24-step loops 24 times, the rest once), and from them the
    issue-rate floor, warp instructions over 132 SMs x 4 schedulers x the
    card's highest SM clock, beside the float-operation bound.

Prints the card's name and power limit, the ptxas report (registers,
stack, spills) and one line a row; ``--out`` also writes the rows as JSON.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from faldoi_tpu_torch.kernels import build as kb

H, W = 436, 1024
SRC = kb.CSRC / "variants" / "k9_variants.cu"
# the m8 path's K9 patch-form calls at full width, [B, P] each, in order
M8_CALLS = Path(__file__).with_name("k9_m8_calls.json")
PATCH = {"library": "library: a thread a cell, two barriers a step, 12 blocks an SM at P 11",
         0: "variant 0, the former library form (6 blocks an SM at P 11)",
         1: "variant 0 without the inner barriers (WRONG, timing only)",
         2: "variant 0, square roots and divisions as multiplies (WRONG, timing only)",
         3: "a thread a cell, one barrier a step",
         4: "a canvas a warp",
         5: "variant 0 at 8 blocks an SM"}
# the forms the m8 path's calls are replayed through
REPLAY = ("library", 0, 3, 4, 5)
WRONG = (1, 2)
SCHEDULERS = 4


def build_variants():
    """nvcc the variants into a shared library; returns (library, ptxas
    report lines)."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kb.BUILD_DIR / "libk9_variants.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
           str(kb.CSRC), "-o", str(out), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.faldoi_k9v_patch.argtypes = [i] + [p] * 8 + [i, i, i, p]
    lib.faldoi_k9v_grid_sync.argtypes = [i, i, i, p]
    lib.faldoi_k9v_grid_sync_capacity.argtypes = [i, p]
    lib.faldoi_k9v_k5_blocks.argtypes = [i, i, p]
    lib.faldoi_k9v_global_step.argtypes = [p] * 6 + [i, i, p]
    lib.faldoi_k9v_global_plan.argtypes = [i] * 4 + [p]
    lib.faldoi_k9v_global_loop.argtypes = ([i, i] + [p] * 5 + [ctypes.c_longlong]
                                           + [i] * 3 + [p])
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return lib, report


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def turns(runs):
    """Time every run twice in turns (a, b, .., b, a); ms lists by key."""
    out = {}
    for key, fn in list(runs.items()) + list(runs.items())[::-1]:
        out.setdefault(key, []).append(fn())
    return out


def grid_barrier_rows(lib, card):
    """(a): us a grid barrier at each block count."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.occlusion import global_plan

    k5 = ctypes.c_int(0)
    kb.check(lib.faldoi_k9v_k5_blocks(H, W, ctypes.addressof(k5)), "k5 blocks")
    plan = global_plan(H, W)
    shapes = {"132 x 1024": (132, 1024), "264 x 1024": (264, 1024),
              f"K5's {k5.value} x 256": (k5.value, 256),
              f"K9 loop's {plan['blocks']} x 1024": (plan["blocks"], 1024)}
    syncs = 1000
    stream = kb.stream_ptr(torch.device("cuda"))

    def launch(b, t):
        kb.check(lib.faldoi_k9v_grid_sync(b, t, syncs, stream), "grid_sync")

    runs = {k: (lambda b=b, t=t: cuda_ms(lambda: launch(b, t), reps=3, warmup=1))
            for k, (b, t) in shapes.items()}
    times = turns(runs)
    rows = []
    for k, ms in times.items():
        us = [1e3 * m / syncs for m in ms]
        rows.append(dict(row="grid barrier", shape=k, us_per_barrier=us, card=card))
        print(f"grid barrier, {k} blocks x threads: {min(us):.3f}-{max(us):.3f} "
              "us a barrier (1000 in one cooperative launch, eager)", flush=True)
    return rows


def patch_call(lib, variant, args, iters=3):
    """One launch of patch ``variant`` (or the library's form); returns
    (st, iterations)."""
    from faldoi_tpu_torch.core.occlusion import occ_patch_loop

    if variant == "library":
        return occ_patch_loop(*args, iters)
    st, wc, g, ph, pw, scal = args
    out = torch.empty_like(st)
    n = torch.empty((st.shape[1],), dtype=torch.int32, device=st.device)
    code = lib.faldoi_k9v_patch(variant, *(t.data_ptr() for t in
                                           (st, wc, g, ph, pw, scal, out, n)),
                                st.shape[1], st.shape[2], iters,
                                kb.stream_ptr(st.device))
    kb.check(code, f"k9 patch variant {variant}")
    return out, n


def patch_rows(lib, dev, card):
    """(b): the patch variants at the path's shapes."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.occlusion import occ_patch_loop_plain

    rows = []
    for p, b in ((11, 8192), (11, 1900), (11, 297), (11, 1), (3, 1703)):
        args = syn.occ_patch_inputs(b, p, 400 + b + p, dev)
        want = occ_patch_loop_plain(*args, 3)
        for v in PATCH:
            got = patch_call(lib, v, args)
            torch.cuda.synchronize()
            exact = same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
            if v not in WRONG and not exact:
                raise AssertionError(f"K9 patch {PATCH[v]} at P {p} B {b} differs "
                                     "from its twin")
        times = turns({v: (lambda v=v: cuda_ms(lambda: patch_call(lib, v, args),
                                               graph=True)) for v in PATCH})
        rows.append(dict(row="patch", shape=f"P {p} B {b}", card=card,
                         ms={str(k): t for k, t in times.items()}))
        print(f"K9 patch P {p} B {b}: " + "; ".join(
            f"{PATCH[k]} {min(t):.4f}-{max(t):.4f} ms" for k, t in times.items()),
            flush=True)
    return rows


# the whole-image loops timed: (depth, threads a block); the library's is
# (3, 1024)
LOOPS = ((1, 1024), (2, 1024), (3, 1024), (2, 512), (3, 512))


def global_plan_of(lib, depth, nt):
    """The variants library's plan of the loop at (depth, threads)."""
    out = (ctypes.c_longlong * 8)()
    kb.check(lib.faldoi_k9v_global_plan(depth, nt, H, W, out), "k9v plan")
    return dict(zip(("scratch", "th", "tw", "ty", "tx", "blocks", "resident",
                     "smem"), out))


def global_rows(lib, dev, card, iters=50):
    """(c): the former whole-image form against the loop at each depth and
    block size, ms a PD iteration."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.occlusion import (
        SCALARS, occ_global_loop, occ_global_loop_plain, occ_pd_step,
    )

    st, wc, g, scal = syn.occ_global_inputs(H, W, 500, dev, True)
    box = (torch.tensor([H], device=dev), torch.tensor([W], device=dev))
    scratch = torch.empty((7, H, W), device=dev)
    err = torch.empty((), device=dev)

    def former(x):
        out = x.clone()
        kb.check(lib.faldoi_k9v_global_step(
            *(t.data_ptr() for t in (out, wc, g, scal, scratch, err)), H, W,
            kb.stream_ptr(dev)), "former whole-image step")
        return out, err

    def loop(s, n, depth, nt):
        out = st.clone()
        m = global_plan_of(lib, depth, nt)["scratch"]
        work = torch.empty((m,), device=dev)
        kb.check(lib.faldoi_k9v_global_loop(
            depth, nt, *(t.data_ptr() for t in (out, wc, g, s, work)), m, H, W,
            n, kb.stream_ptr(dev)), f"whole-image loop {depth} {nt}")
        return out, work[3:4].view(torch.int32)[0]

    want, werr = occ_pd_step(st[:, None], wc[:, None], g[None], *box, scal)
    got, gerr = former(st)
    torch.cuda.synchronize()
    if not (same_bits(got, want[:, 0]) and float(gerr) == float(werr[0])):
        raise AssertionError("the former whole-image form differs from its twin")
    want3, n3 = occ_global_loop_plain(st, wc, g, scal, 3)
    for depth, nt in LOOPS:
        got3, g3 = loop(scal, 3, depth, nt)
        if not (same_bits(got3, want3) and int(g3) == int(n3)):
            raise AssertionError(f"the whole-image loop at depth {depth}, {nt} "
                                 "threads differs from its twin")
    got3, g3 = occ_global_loop(st, wc, g, scal, 3)
    if not (same_bits(got3, want3) and int(g3) == int(n3)):
        raise AssertionError("the library's whole-image loop differs from its twin")
    never = scal.clone()
    never[SCALARS.index("tol2")] = -1.0
    runs = {"former": lambda: cuda_ms(lambda: former(st), graph=True),
            "library": lambda: cuda_ms(lambda: occ_global_loop(
                st, wc, g, never, iters), reps=3, warmup=1) / iters}
    for depth, nt in LOOPS:
        runs[(depth, nt)] = (lambda d=depth, t=nt: cuda_ms(
            lambda: loop(never, iters, d, t), reps=3, warmup=1) / iters)
    times = turns(runs)
    rows = []
    for k, ms in times.items():
        plan = global_plan_of(lib, *k) if isinstance(k, tuple) else None
        name = (f"loop depth {k[0]}, {k[1]} threads" if plan else
                "library loop (depth 3, 1024 threads)" if k == "library" else k)
        rows.append(dict(row="whole image", shape=f"{H}x{W}", form=name,
                         card=card, ms_per_iteration=ms, plan=plan))
        print(f"K9 whole image {H}x{W}, {name}: {min(ms):.4f}-{max(ms):.4f} ms "
              "a PD iteration" + (f" (plan {plan})" if plan else
                                  " (99 launches, a graph of 20 calls)"
                                  if k == "former" else ""), flush=True)
    return rows


def replay_rows(lib, dev, card, calls):
    """(c): the m8 path's patch-form calls replayed, each form's sum."""
    from faldoi_tpu_torch import synthetic as syn

    forms = REPLAY
    sums = {f: [0.0, 0.0] for f in forms}
    for p in sorted({cp for _, cp in calls}):
        counts = Counter(b for b, cp in calls if cp == p)
        st, wc, g, ph, pw, scal = syn.occ_patch_inputs(max(counts), p, 600 + p,
                                                       dev)
        for b, k in sorted(counts.items()):
            args = [st[:, :b].contiguous(), wc[:, :b].contiguous(),
                    g[:b].contiguous(), ph[:b].contiguous(), pw[:b].contiguous(),
                    scal]
            for turn, order in enumerate((forms, forms[::-1])):
                for f in order:
                    patch_call(lib, f, args)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(k):
                        patch_call(lib, f, args)
                    end.record()
                    torch.cuda.synchronize()
                    sums[f][turn] += start.elapsed_time(end) / 1e3
    row = dict(row="path replay", calls=len(calls), card=card,
               seconds={str(f): s for f, s in sums.items()})
    print(f"K9 patch form, the m8 path's {len(calls)} calls replayed: " + "; ".join(
        f"{PATCH[f]} {min(s):.4f}-{max(s):.4f} s" for f, s in sums.items()),
        flush=True)
    return [row]


INST = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")
TARGET = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def sass_functions(lib_path):
    """{mangled name: [(address, instruction)]} of a library's SASS."""
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


def loops(insts):
    """The back edges' spans [target, branch], by address."""
    out = []
    for addr, ins in insts:
        m = TARGET.search(ins)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def per_iteration(insts, steps=24):
    """Instructions a thread a PD iteration of a patch-form kernel: its
    outermost loop once, its two largest inner loops (the 24-step loops)
    ``steps`` times.  Returns (count, outer size, inner sizes)."""
    addrs = [a for a, _ in insts]

    def size(span):
        return sum(span[0] <= a <= span[1] for a in addrs)

    spans = loops(insts)
    outer = max(spans, key=size)
    inner = sorted((s for s in spans if s != outer and outer[0] <= s[0]
                    and s[1] <= outer[1]), key=size)[-2:]
    n_outer, n_inner = size(outer), [size(s) for s in inner]
    return n_outer + (steps - 1) * sum(n_inner), n_outer, n_inner


def sass_rows(card, clock_mhz):
    """(d): instructions a cell a PD iteration of the library's patch form
    (a thread a cell) at P 11 and P 3 and of the warp form (variant 4, four
    cells a lane), and the issue-rate floors."""
    from faldoi_tpu_torch.cli.kernel_probe import bound
    from faldoi_tpu_torch.core.occlusion import PD_OPS

    funcs = sass_functions(kb.build())
    funcs.update(sass_functions(kb.BUILD_DIR / "libk9_variants.so"))
    counts = {}
    # (key, kernel, cells a thread, the source the kernel was built from)
    for key, pat, lanes_per_cell, source in (
            ("P 11", "occ_patch_kernelILi11E", 1, "occlusion_cu"),
            ("P 3", "occ_patch_kernelILi3E", 1, "occlusion_cu"),
            ("warp form, 4 cells a lane", "occ_patch_warp_kernelILi4E", 0.25,
             "k9_variants_cu")):
        name = [f for f in funcs if pat in f and source in f][0]
        n, n_outer, n_inner = per_iteration(funcs[name])
        counts[key] = n
        print(f"SASS {pat}: {len(funcs[name])} instructions, the PD loop "
              f"{n_outer} with the 24-step loops {n_inner}: {n} a thread a PD "
              f"iteration, {n * lanes_per_cell:.0f} a cell", flush=True)
    for name, insts in funcs.items():
        if "occ_global_loop_kernel" in name and "occlusion_cu" in name:
            print(f"SASS {name}: {len(insts)} instructions, "
                  f"{len(loops(insts))} loops", flush=True)
    hz = clock_mhz * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = sms * SCHEDULERS * hz            # warp instructions a second
    rows = []
    # (shape, warps, cells, the count a thread, PD iterations): the library
    # runs a canvas of P 11 in a 128-thread block (four warps), 14 canvases
    # of P 3 in one; the whole image at a thread a pixel
    for shape, warps, cells, key, iters in (
            ("P 11 B 8192", 4 * 8192, 8192 * 121, "P 11", 3),
            ("P 11 B 297", 4 * 297, 297 * 121, "P 11", 3),
            ("P 3 B 1703", 4 * -(-1703 // 14), 1703 * 9, "P 3", 3),
            (f"whole image {H}x{W}, a PD iteration", -(-H * W // 32), H * W,
             "P 11", 1)):
        floor_ms = warps * counts[key] * iters / issue * 1e3
        ops = bound(0.0, cells * iters * PD_OPS)
        rows.append(dict(row="issue floor", shape=shape, card=card,
                         clock_mhz=clock_mhz, per_thread=counts[key],
                         warps=warps, iterations=iters, floor_ms=floor_ms,
                         op_bound_ms=ops["bound_ms"]))
        print(f"issue floor {shape}: {warps} warps x {counts[key]} x {iters} "
              f"instructions at {sms} SMs x {SCHEDULERS} x {clock_mhz} MHz: "
              f"{floor_ms:.4f} ms (float-operation bound {ops['bound_ms']:.4f} ms)",
              flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k9_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0])
    print(card, f"(highest SM clock {clock} MHz, now {smi('clocks.sm')})",
          flush=True)
    lib, report = build_variants()
    print("\n".join(report), flush=True)
    rows = (grid_barrier_rows(lib, card) + patch_rows(lib, dev, card)
            + global_rows(lib, dev, card))
    with open(M8_CALLS) as fh:
        rows += replay_rows(lib, dev, card, [tuple(c) for c in json.load(fh)])
    try:
        rows += sass_rows(card, clock)
    except Exception as exc:   # the listing's format is the toolkit's
        print(f"SASS analysis failed: {exc!r}", flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(dict(ptxas=report, rows=rows), fh, indent=1)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

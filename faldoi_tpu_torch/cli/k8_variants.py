"""K8's and the K8 loop's design variants against each other on one CUDA card.

    python -m faldoi_tpu_torch.cli.k8_variants [--out FILE.json]

Builds ``csrc/variants/k8_variants.cu`` (the former thread-a-cell insertion
sort; one thread a cell counting in registers; 8 and 16 lanes a cell; the
loop with one thread, 2, 4 (two canvases a block) or 8 lanes a cell; it
includes ``csrc/csad.cu``, so its
``-Xptxas -v`` report covers the library's kernels too) with the library's
nvcc flags into ``faldoi_tpu_torch/_build/``.  Then, at the shapes the m4
path gives K8 (the whole image at 436x1024 from a warp of the synthetic
pair; the patch form at P 11 with B 8192, 297 and 1 from the m4 solver's own
stages), it holds every v-step variant and the library's ``csad_vstep`` (4
lanes a cell) bit for bit to ``csad_vstep_plain``, and every loop variant
and the library's ``csad_patch_loop`` to ``csad_patch_loop_plain`` at P 11,
B 8192, 297 and 1, and times each (a CUDA graph of 20 calls), every one
twice in turns within this process.  Prints the card's name and power
limit, the ptxas report (registers, stack, spills) and one line a shape;
``--out`` also writes the rows as JSON.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb

H, W = 436, 1024
VARIANTS = {0: "former: thread a cell, insertion sort",
            1: "thread a cell, counting", 8: "8 lanes a cell",
            16: "16 lanes a cell", "library": "library, 4 lanes a cell"}
LOOP_VARIANTS = {1: "loop, thread a cell", 2: "loop, 2 lanes a cell",
                 4: "loop, 4 lanes, 1024-thread blocks",
                 8: "loop, 8 lanes a cell",
                 "library": "library loop, 4 lanes, 512-thread blocks"}
SRC = kb.CSRC / "variants" / "k8_variants.cu"


def build_variants():
    """nvcc the variants into a shared library; returns (library, ptxas
    report lines)."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kb.BUILD_DIR / "libk8_variants.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
           str(kb.CSRC), "-o", str(out), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.faldoi_k8v_global.argtypes = [i] + [p] * 7 + [f, i, p, p, i, i, p]
    lib.faldoi_k8v_patch.argtypes = [i] + [p] * 7 + [f, i] + [p] * 4 + [i, i, p]
    lib.faldoi_k8v_loop.argtypes = [i] + [p] * 17 + [i] * 4 + [p]
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return lib, report


def global_args(dev, rng):
    """The whole-image call of a TV-CSAD warp of the synthetic pair at its
    known flow plus 0.5 px of noise."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.csad import csad_b, image_masks
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    i0, i1, gf, _ = syn.make_pair(H, W, seed=0)
    a, b = prepare_pair(i0, i1, device=dev)
    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                           device=dev)
    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, gx, gy = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    gx, gy = gx.contiguous(), gy.contiguous()
    grad = hypot(gx * gx + gy * gy, 0.01).contiguous()
    m, n = image_masks(H, W, dev)
    l_t = float(np.float32(0.85) * np.float32(0.3))
    return (u1, u2, csad_b(a, i1w, gx, gy, u1, u2, grad, m), gx, gy, grad, l_t,
            m, n), (a, b)


def patch_args(dev, rng, pair, nb):
    """The m4 solver's v-step call on ``nb`` canvases of P 11: boxes of
    random centres (the image corners first, clipped at the edge), a
    constant flow plus 0.3 px, the source crop (K0), the warp (K4), grad at
    the TV-CSAD floor, the breakpoints."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.models import method_local_params
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    p = 11
    sc = make_solver_consts(*pair, *method_local_params(4, 5), 0.01, p, 4)
    idx = torch.as_tensor(rng.integers(0, H * W, nb), device=dev)
    idx[:4] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W], device=dev)[:nb]
    _, _, oy, ox, ph, pw = (x.to(torch.int32).contiguous()
                            for x in patch_geometry(idx, H, W, p // 2))
    ar = torch.arange(p, device=dev)
    inbox = (ar[None, :, None] < ph[:, None, None]) & (ar[None, None, :] < pw[:, None, None])
    zero = torch.zeros((), device=dev)
    u1, u2 = (torch.where(inbox, torch.as_tensor(
        rng.normal(mu, 0.3, (nb, p, p)).astype(np.float32), device=dev), zero)
        for mu in (2.6, -1.4))
    i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, oy, ox, ph, pw, u1, u2, 3)
    i0p = gather_patches(sc.i0pad[:, :, None], oy, ox, p)[:, :, 0, :].permute(2, 0, 1)
    grad = hypot(gx * gx + gy * gy, 0.01).contiguous()
    m, n = canvas_masks(ph, pw, p)
    b = csad_b(i0p, i1w, gx, gy, u1, u2, grad, m)
    return (u1, u2, b, gx.contiguous(), gy.contiguous(), grad,
            sc.lambda_ * sc.theta, m, n, ph, pw), sc


def call_variant(lib, variant, args):
    """One launch of ``variant`` on K8's arguments; returns (v1, v2)."""
    u1 = args[0]
    v1, v2 = torch.empty_like(u1), torch.empty_like(u1)
    l_t = args[6]
    lt_ptr, lt_val = ((l_t.data_ptr(), 0.0) if isinstance(l_t, torch.Tensor)
                      else (None, float(np.float32(l_t))))
    ptrs = [t.data_ptr() for t in args[:6]]
    stream = kb.stream_ptr(u1.device)
    if len(args) > 9:
        code = lib.faldoi_k8v_patch(variant, *ptrs, lt_ptr, lt_val, 0,
                                    args[9].data_ptr(), args[10].data_ptr(),
                                    v1.data_ptr(), v2.data_ptr(), u1.shape[0],
                                    u1.shape[1], stream)
    else:
        code = lib.faldoi_k8v_global(variant, *ptrs, lt_ptr, lt_val, 0,
                                     v1.data_ptr(), v2.data_ptr(), u1.shape[0],
                                     u1.shape[1], stream)
    kb.check(code, f"k8 variant {variant}")
    return v1, v2


def call_loop(lib, variant, args):
    """One launch of loop ``variant`` on the K8 loop's arguments (four
    iterations); returns (u1, u2, v1, v2, iterations)."""
    u1 = args[0]
    outs = [torch.empty_like(u1) for _ in range(4)]
    iters = torch.empty(u1.shape[:1], dtype=torch.int32, device=u1.device)
    scal = torch.stack(args[13:16]).contiguous()
    l_t = args[8]
    code = lib.faldoi_k8v_loop(
        variant, *(t.data_ptr() for t in args[:9]), scal.data_ptr(),
        args[11].data_ptr(), args[12].data_ptr(), *(t.data_ptr() for t in outs),
        iters.data_ptr(), u1.shape[0], u1.shape[1], int(l_t.dim() != 0), 4,
        kb.stream_ptr(u1.device))
    kb.check(code, f"k8 loop variant {variant}")
    return (*outs, iters)


def time_row(name, runs, want, card, names):
    """Every run bit for bit against ``want``, then timed twice in turns."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms

    row = dict(shape=name, card=card)
    for key, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        if not all(same_bits(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"K8 variant {key} at {name} differs from its twin")
    for key in list(runs) + list(runs)[::-1]:
        row.setdefault(str(key), []).append(cuda_ms(runs[key], graph=True))
    print(f"{name}: bit-exact, ms " + "  ".join(
        f"{names[k]}: {min(row[str(k)]):.4f}-{max(row[str(k)]):.4f}" for k in runs),
        flush=True)
    return row


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def main(argv=None) -> int:
    from faldoi_tpu_torch.ops.csad import (
        csad_patch_loop, csad_patch_loop_plain, csad_vstep, csad_vstep_plain,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    lib, report = build_variants()
    print("\n".join(report), flush=True)
    rng = np.random.default_rng(0)
    gargs, pair = global_args(dev, rng)
    shapes = [(f"{H}x{W}", gargs, None)] + [
        (f"P 11 B {nb}", *patch_args(dev, rng, pair, nb)) for nb in (8192, 297, 1)]
    rows = []
    for name, args, sc in shapes:
        runs = {v: (lambda v=v: call_variant(lib, v, args)) for v in VARIANTS
                if v != "library"}
        runs["library"] = lambda: csad_vstep(*args)
        rows.append(time_row(f"K8 {name}", runs, csad_vstep_plain(*args[:9]),
                             card, VARIANTS))
        if sc is None:
            continue
        largs = list(args[:2]) + list(args) + [sc.theta, sc.tau, sc.tol * sc.tol]
        runs = {v: (lambda v=v: call_loop(lib, v, largs)) for v in LOOP_VARIANTS
                if v != "library"}
        runs["library"] = lambda: csad_patch_loop(*largs, 4)
        rows.append(time_row(f"K8 loop {name}", runs,
                             csad_patch_loop_plain(*largs, 4), card, LOOP_VARIANTS))
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(dict(ptxas=report, rows=rows), fh, indent=1)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

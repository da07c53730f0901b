"""K8's, the K8 loop's, K16's, K14's and K15's design variants against each
other on one CUDA card.

    python -m faldoi_tpu_torch.cli.k8_variants [--out FILE.json] [--quick]
                                               [--global-only]

Builds ``csrc/variants/k8_variants.cu`` with the library's nvcc flags and
``-Xptxas=-v`` into ``faldoi_tpu_torch/_build/``; it includes
``csrc/csad.cu`` and ``csrc/csad_loops.cu``, so its report covers the
library's kernels too.  It holds:

(a) K8's v-step variants (the former thread-a-cell insertion sort; one
    thread a cell counting in registers; 8 and 16 lanes a cell) and the
    library's ``csad_vstep`` (4 lanes a cell) at the m4 path's shapes: the
    whole image at 436x1024 from a warp of the synthetic pair, the patch
    form at P 11 with B 8192, 297 and 1 from the m4 solver's own stages;
(b) the K8 loop's forms: the former (the kernel before the ranking, the
    full counting selection every PD iteration), one thread a cell
    counting, and the ranked selection (``csad_select.cuh``: b ranked once
    a call, a merge search every iteration) with the ranks in registers or
    the ranked b in shared memory, at other lanes a cell, block sizes and
    launch bounds, with the fallback out of line and with the zero rule,
    beside the library's ``csad_patch_loop``, at P 11 with B 8192, 676, 297 and 1, m5's
    per-cell l_t at B 1900, and P 3 at B 1703 (the former and the
    library's);
(c) K16's forms the same way (the former: the kernel before the ranking) beside the
    library's ``nltvcsad_patch_loop``, with m7 at B 1900 with duals given;
(d) the ptxas report of every kernel (registers, spills) and the warps an
    SM then holds, and the SASS (``cuobjdump -sass``) of the P 11 loop
    forms: the instructions of one PD iteration's loop body, split into the
    selection (the body less that of the form whose selection is a stub;
    for the ranked forms the body of the form without its fallback) and the
    rest, and the issue floor of a call's PD iterations (warps x 4
    iterations over 132 SMs x 4 schedulers x the card's highest SM clock;
    the set-up outside the loop is left out).

(e) K14's and K15's forms (``csrc/variants/csad_global_variants.cu``,
    built with ``-Xptxas=-v`` beside the first; it includes
    ``csrc/csad_global.cu``): the former (counting every PD iteration; K15:
    K8's whole-image form and the former step an iteration, as the former
    wrapper ran it), the ranked b pixel-major or plane-major, a thread a
    pixel or four lanes a pixel (K14), the counting path in line or out of
    line, K15's v-step as a launch of its own, beside the library's
    ``tvcsad_global_loop`` and ``nltvcsad_global_loop``, on one warp of the
    synthetic pair at 436x1024, 10 and 400 PD iterations; their registers,
    spills and warps an SM, and the static SASS count of an iteration's
    kernels (the ranked path without the counting path, a form built for
    the count) as an issue floor.

Every form is held bit for bit to its twin (``csad_vstep_plain``,
``csad_patch_loop_plain``, ``nltvcsad_patch_loop_plain``,
``tvcsad_global_loop_plain``, ``nltvcsad_global_loop_plain``) and then
timed, a CUDA graph of 20 calls each (of 2 for the 400-iteration calls of
(e)), twice in turns in this process (a, b, .., b, a).
``--quick`` skips (a), ``--global-only`` runs (e) alone.  Prints the card's
name and power limit, the ptxas report and one line a shape; ``--out`` also
writes the rows as JSON.  Needs a CUDA card.  ``chip_smoke.py`` calls
``build_variants``, ``time_loop``, ``time_nl``, ``build_global_variants``
and ``time_global`` for the former forms' times.
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
# faldoi_k8v_loop's (the K8 loop) and faldoi_k8v_nl's (K16) forms at P 11,
# csrc/variants/k8_variants.cu; "library" is the library's wrapper
RANKED = {2: "ranked with the zero rule, 2 lanes a cell, 256 threads",
          10: "ranked with the zero rule, 512 threads",
          11: "ranked with the zero rule, 512 threads, 2 blocks an SM",
          12: "ranked in shared memory with the zero rule, 512 threads",
          13: "ranked in shared memory with the zero rule, 2 blocks an SM",
          14: "ranked with the zero rule, a thread a cell, 128 threads",
          15: "ranked with the zero rule, a thread a cell, 512 threads",
          16: "ranked, 512 threads",
          17: "ranked, 512 threads, 2 blocks an SM",
          18: "ranked, a thread a cell, 128 threads",
          19: "ranked, the fallback out of line, 512 threads, 2 blocks an SM",
          20: "ranked, the fallback out of line, 512 threads",
          21: "ranked in shared memory, 512 threads, 2 blocks an SM (the library's)",
          22: "ranked, the fallback out of line, 512 threads, 3 blocks an SM"}
LOOP_VARIANTS = {0: "former: counting every iteration",
                 1: "thread a cell, counting every iteration",
                 4: "ranked with the zero rule, 4 lanes, 1024 threads",
                 8: "ranked with the zero rule, 8 lanes a cell",
                 **RANKED, "library": "library"}
NL_VARIANTS = {0: "former: counting every iteration", **RANKED,
               "library": "library"}
# for the SASS counts only: the ranked forms without their fallback (in
# registers, in shared memory), and the selection stubbed (med = dot)
NO_FALLBACK, STUB, NO_FALLBACK_SMEM = 30, 31, 32
SRC = kb.CSRC / "variants" / "k8_variants.cu"
LIB = kb.BUILD_DIR / "libk8_variants.so"
# faldoi_k14v's and faldoi_k15v's forms (csrc/variants/
# csad_global_variants.cu); "library" is the library's wrapper
K14_VARIANTS = {0: "former: four lanes a pixel counting every PD iteration",
                1: "ranked pixel-major, a thread a pixel, 256 threads, "
                   "counting out of line, no register cap",
                2: "ranked plane-major, a thread a pixel, 256 threads, "
                   "counting out of line, no register cap",
                3: "ranked pixel-major, four lanes a pixel (lane 0 searches), "
                   "counting in line",
                4: "ranked plane-major, four lanes a pixel, counting in line",
                5: "ranked pixel-major, a thread a pixel, counting in line",
                6: "ranked pixel-major, a thread a pixel, 128 threads, "
                   "counting out of line, no register cap",
                7: "ranked pixel-major, a thread a pixel, 4 blocks an SM "
                   "(64 registers), counting out of line",
                8: "ranked plane-major, a thread a pixel, 4 blocks an SM, "
                   "counting out of line",
                9: "ranked pixel-major, a thread a pixel, 8 blocks an SM "
                   "(32 registers), counting out of line",
                10: "ranked plane-major, a thread a pixel, 8 blocks an SM, "
                    "counting out of line",
                11: "ranked pixel-major, a thread a pixel, 4 blocks an SM, "
                    "counting in line",
                12: "ranked plane-major, a thread a pixel, 4 blocks an SM, "
                    "counting in line",
                "library": "library"}
K15_VARIANTS = {0: "former: K8's whole-image form and the former step an "
                   "iteration",
                1: "ranked pixel-major, v in the primal phase, counting out "
                   "of line",
                2: "ranked plane-major, v in the primal phase, counting out "
                   "of line",
                3: "ranked pixel-major, v in the primal phase, counting in "
                   "line",
                4: "ranked pixel-major, a v-step launch of its own (three "
                   "launches an iteration)",
                "library": "library"}
GLOBAL_SRC = kb.CSRC / "variants" / "csad_global_variants.cu"
GLOBAL_LIB = kb.BUILD_DIR / "libcsad_global_variants.so"


def build_variants(former_only=False):
    """nvcc the variants into a shared library; returns (library, ptxas
    report lines).  ``former_only``: the former K8 loop and K16 alone
    (loop and K16 variant 0; ``-DK8V_FORMER_ONLY``, a quicker build)."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = LIB.with_name("libk8_variants_former.so") if former_only else LIB
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
           str(kb.CSRC), *(["-DK8V_FORMER_ONLY"] if former_only else []), "-o",
           str(out), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if not former_only:
        lib.faldoi_k8v_global.argtypes = [i] + [p] * 7 + [f, i, p, p, i, i, p]
        lib.faldoi_k8v_patch.argtypes = [i] + [p] * 7 + [f, i] + [p] * 4 + [i, i, p]
    lib.faldoi_k8v_loop.argtypes = [i] + [p] * 17 + [i] * 4 + [p]
    lib.faldoi_k8v_nl.argtypes = [i] + [p] * 21 + [i] * 4 + [p]
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return lib, report


def build_global_variants():
    """nvcc K14's and K15's forms into a shared library; returns (library,
    ptxas report lines)."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-Xptxas=-v", "-shared", "-I",
           str(kb.CSRC), "-o", str(GLOBAL_LIB), str(GLOBAL_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(GLOBAL_LIB))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.faldoi_k14v.argtypes = [i] + [p] * 16 + [i, i, f, f, f, f, i, p]
    lib.faldoi_k15v.argtypes = [i] + [p] * 15 + [i, i, f, f, f, i, p, p, p]
    lib.faldoi_k15v_former_step.argtypes = [p] * 11 + [i, i, f, f, p]
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "Compiling entry" in ln or "registers" in ln or "spill" in ln
              or "Function properties" in ln]
    return lib, report


def csad_global_args(a, b, flow, method, i0=None, iters=10, tol2=0.0):
    """One warp's arguments of the CSAD global loops as ``tvcsad_global``
    (method 4: K14) or ``nltvcsad_global`` (method 6: K15, with the global
    weights of I0's colour planes ``i0``) builds them for its first warp
    from the prepared frames ``a``, ``b`` (h, w) and ``flow`` (h, w, 2): the
    warp of (I1, I1x, I1y) at the flow (K4's flow form), grad, the
    breakpoints, zero duals, the method's global lambda, theta and tau.
    K14's take ``tol2`` and ``iters``; K15's ``iters``."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.global_step_nltv import global_weights
    from faldoi_tpu_torch.core.pd_common import hypot, sqrt_rn
    from faldoi_tpu_torch.models import method_global_params
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.csad import csad_b, image_masks
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    h, w = a.shape
    lam, theta, tau = method_global_params(method, P.Parameters())
    l_t = float(np.float32(lam) * np.float32(theta))
    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, gx, gy = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    gx, gy = gx.contiguous(), gy.contiguous()
    m, n = image_masks(h, w, a.device)
    if method == 4:
        grad = hypot(gx * gx + gy * gy, 0.01).contiguous()
        xi = [torch.zeros_like(u1) for _ in range(4)]
        return [u1, u2, u1.clone(), u2.clone(), *xi,
                csad_b(a, i1w, gx, gy, u1, u2, grad, m), gx, gy, grad, l_t, m, n,
                theta, tau, tol2, iters]
    grad = (gx * gx + gy * gy).contiguous()
    sq = sqrt_rn(torch.where(grad > P.GRAD_IS_ZERO, grad,
                             torch.ones((), device=a.device))).contiguous()
    wp, wt = global_weights(i0, a.device)
    sc = [torch.zeros((24, h, w), device=a.device) for _ in range(2)]
    return [u1, u2, u1.clone(), u2.clone(), *sc, wp, wt,
            csad_b(a, i1w, gx, gy, u1, u2, sq, m), gx, gy, sq, grad, l_t, m, n,
            theta, tau, iters]


def call_k14(lib, variant, args):
    """One call of K14 form ``variant`` on ``tvcsad_global_loop``'s
    arguments, in place; returns the iteration count, a (1,) tensor."""
    from faldoi_tpu_torch.core.global_step_csad import (
        ERR_BLOCK_CELLS, ranked_scratch, tvcsad_global_loop,
    )

    if variant == "library":
        return tvcsad_global_loop(*args)
    u1 = args[0]
    (h, w), dev = u1.shape, u1.device
    part = torch.empty(-(-h * w // ERR_BLOCK_CELLS), dtype=torch.float64, device=dev)
    state = torch.empty(3, dtype=torch.int32, device=dev)
    rb, ok = ranked_scratch(h, w, dev)
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    code = lib.faldoi_k14v(
        variant, *(t.data_ptr() for t in args[:12]), part.data_ptr(),
        state.data_ptr(), rb.data_ptr(), ok.data_ptr(), h, w, f32(args[12]),
        f32(args[15]), f32(args[16]), f32(args[17]), int(args[18]),
        kb.stream_ptr(dev))
    kb.check(code, f"k14 variant {variant}")
    return state[:1]


def call_k15(lib, variant, args):
    """One call of K15 form ``variant`` on ``nltvcsad_global_loop``'s
    arguments, in place (form 0: K8's whole-image form and the former step
    an iteration)."""
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global_loop, ranked_scratch,
    )
    from faldoi_tpu_torch.ops.csad import csad_vstep

    if variant == "library":
        return nltvcsad_global_loop(*args)
    (u1, u2, u1_, u2_, sp, sq, wp, wt, b, gx, gy, den, grad, l_t, m, n, theta,
     tau, iters) = args
    (h, w), dev = u1.shape, u1.device
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    stream = kb.stream_ptr(dev)
    if variant == 0:
        for _ in range(iters):
            v1, v2 = csad_vstep(u1, u2, b, gx, gy, den, l_t, m, n)
            code = lib.faldoi_k15v_former_step(
                *(t.data_ptr() for t in (u1, u2, u1_, u2_, wt, v1, v2, grad, sp,
                                         sq, wp)), h, w, f32(theta), f32(tau), stream)
            kb.check(code, "k15 variant 0")
        return None
    rb, ok = ranked_scratch(h, w, dev)
    v1, v2 = torch.empty_like(u1), torch.empty_like(u1)
    code = lib.faldoi_k15v(
        variant, *(t.data_ptr() for t in (u1, u2, u1_, u2_, wt, gx, gy, den, grad,
                                          sp, sq, wp, b, rb, ok)),
        h, w, f32(l_t), f32(theta), f32(tau), int(iters), v1.data_ptr(),
        v2.data_ptr(), stream)
    kb.check(code, f"k15 variant {variant}")
    return None


def copies(args):
    return [x.clone() if isinstance(x, torch.Tensor) else x for x in args]


def time_global(lib, kernel, args, variants, reps=20):
    """K14's (``kernel`` "K14") or K15's forms on one warp's ``args``: each
    held bit for bit to its twin on copies (u, u_bar, the duals; K14's
    count too), then timed twice in turns on a copy of its own (a CUDA
    graph of ``reps`` calls); returns {variant: [ms, ms]}."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global_loop_plain, tvcsad_global_loop_plain,
    )

    k14 = kernel == "K14"
    call, keep = (call_k14, 8) if k14 else (call_k15, 6)
    want = copies(args)
    wn = (tvcsad_global_loop_plain if k14 else nltvcsad_global_loop_plain)(*want)
    for v in variants:
        got = copies(args)
        gn = call(lib, v, got)
        torch.cuda.synchronize()
        if (k14 and int(gn) != int(wn)) or not all(
                same_bits(x, y) for x, y in zip(got[:keep], want[:keep])):
            raise AssertionError(f"{kernel} form {v} differs from its twin")
    work = {v: copies(args) for v in variants}
    out = {}
    for v in list(variants) + list(variants)[::-1]:
        fn = lambda v=v: call(lib, v, work[v])   # noqa: E731
        out.setdefault(str(v), []).append(cuda_ms(fn, reps=reps, warmup=1,
                                                  graph=True))
    return out


def global_rows(lib, report, card, clock_mhz, frames, dev):
    """(e): K14's and K15's forms at 436x1024 on the first warp of the
    synthetic pair (its known flow plus 0.5 px of noise), 10 and 400 PD
    iterations; the ptxas rows of their kernels and the library's static
    SASS issue floor of one PD iteration."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli.patch_variants import (
        SCHEDULERS, ptxas_kernels, sass_functions, warps_an_sm,
    )

    a, b, i0 = frames
    _, _, gf, _ = syn.make_pair(H, W, seed=0)
    rng = np.random.default_rng(1)
    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                           device=dev)
    rows = []
    for kernel, method, forms in (("K14", 4, K14_VARIANTS), ("K15", 6, K15_VARIANTS)):
        for iters in (10, 400):
            args = csad_global_args(a, b, flow, method, i0, iters)
            row = dict(shape=f"{kernel} {H}x{W}, {iters} PD iterations", card=card,
                       **time_global(lib, kernel, args, list(forms),
                                     20 if iters < 100 else 2))
            print(f"{row['shape']}: bit-exact, ms " + "  ".join(
                f"{forms[k]}: {min(row[str(k)]):.4f}-{max(row[str(k)]):.4f}"
                for k in forms), flush=True)
            rows.append(row)
    regs = ptxas_kernels(report)
    for name, k in regs.items():
        if not any(x in name for x in ("tvcsad", "nltvcsad", "rank_image",
                                       "image_counting", "nltv_dual")):
            continue
        threads = (1024 if "finish" in name else
                   128 if ("primal4" in name or "rank_image" in name
                           or ("former" in name and "20tvcsad_primal" in name))
                   else 256)
        row = dict(row="ptxas", name=name, card=card, **k,
                   warps_an_sm=(warps_an_sm(k["registers"], threads, 0)
                                if "registers" in k else None))
        print("PTXAS " + json.dumps(row), flush=True)
        rows.append(row)
    # the issue floor of one PD iteration of the ranked forms: the static
    # SASS count a warp of each kernel of an iteration (the primal phase of
    # form 30, the ranked path without the counting path, SASS only),
    # times the warps
    funcs = sass_functions(GLOBAL_LIB)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = sms * SCHEDULERS * clock_mhz * 1e6 / 1e3   # warp instructions a ms
    hw = H * W
    tiles = -(-W // 32) * -(-H // 8) * 8
    for kernel, parts in (
            ("K14", (("tvcsad_dual_kernel", -(-hw // 256) * 8),
                     ("tvcsad_primal_kernelILi256ELi4ENS_10PlaneMajorELi2E",
                      -(-hw // 32)),
                     ("tvcsad_finish_kernel", 32))),
            ("K15", (("nltv_dual_kernel", tiles),
                     ("nltvcsad_primal_kernelINS_10PlaneMajorELi2E", tiles)))):
        count = {}
        for part, warps in parts:
            # the kernel itself, not its "$" internal subroutines
            names = sorted(f for f in funcs if part in f and "$" not in f)
            count[part] = (len(funcs[names[0]]) if names else None, warps)
        ok = all(c is not None for c, _ in count.values())
        row = dict(row="sass", kernel=kernel, card=card, clock_mhz=clock_mhz,
                   instructions={k: c for k, (c, _) in count.items()},
                   floor_ms_an_iteration=(sum(c * wp for c, wp in count.values())
                                          / issue if ok else None))
        print("SASS " + json.dumps(row), flush=True)
        rows.append(row)
    return rows


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
            m, n), (a, b, i0)


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
    sc = make_solver_consts(*pair[:2], *method_local_params(4, 5), 0.01, p, 4)
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


def solve_args(dev, rng, frames, nb, p=11, method=4, duals=False):
    """One warp's call of the m4-m7 patch solve on ``nb`` canvases of P:
    boxes of random centres (the image corners first, clipped at the edge),
    a constant flow plus 0.3 px, the source crop (K0), the warp (K4), grad
    at the CSAD floor, the breakpoints, v = u, the consts' theta, tau and
    tol^2; l_t one a cell for methods 5 and 7.  Methods 4 and 5:
    ``csad_patch_loop``'s arguments; 6 and 7: ``nltvcsad_patch_loop``'s
    (the box-masked weights cropped by K0, random duals where ``duals``)."""
    from faldoi_tpu_torch.core.functionals import (
        _weight2d, make_solver_consts, nltv_crop_weights,
    )
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.models import method_local_params
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    a, b, i0 = frames
    nltv = method in (6, 7)
    sc = make_solver_consts(a, b, *method_local_params(method, 5), 0.01, p,
                            method, **(dict(i0_planes=i0) if nltv else {}))
    idx = torch.as_tensor(rng.integers(0, H * W, nb), device=dev)
    idx[:4] = torch.as_tensor([0, W - 1, H * W - 1, (H - 1) * W], device=dev)[:nb]
    ci, cj, oy, ox, ph, pw = patch_geometry(idx, H, W, p // 2)
    oy, ox, ph, pw = (x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw))
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
    bb = csad_b(i0p, i1w, gx, gy, u1, u2, grad, m)
    l_t = sc.lambda_ * sc.theta
    if method in (5, 7):
        rows, cols = canvas_ids(p, dev)
        l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy.long(), ox.long(), cj, ci,
                               p // 2)).contiguous()
    tail = [m, n, ph, pw, sc.theta, sc.tau, sc.tol * sc.tol]
    if not nltv:
        return [u1, u2, u1, u2, bb, gx.contiguous(), gy.contiguous(), grad, l_t] + tail
    wp, wt = nltv_crop_weights(sc.wp_pad, oy, ox, ph, pw, p)
    d = None
    if duals:
        d = torch.as_tensor(rng.normal(0, 0.3, (2, 24, nb, p, p)).astype(np.float32),
                            device=dev)
    return [u1, u2, u1, u2, d, bb, gx.contiguous(), gy.contiguous(), grad,
            wp.contiguous(), wt.contiguous(), l_t] + tail


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


def call_loop(lib, variant, args, max_iters=4):
    """One launch of loop ``variant`` on the K8 loop's arguments
    (``csad_patch_loop``'s); returns (u1, u2, v1, v2, iterations)."""
    if variant == "library":
        from faldoi_tpu_torch.ops.csad import csad_patch_loop

        return csad_patch_loop(*args, max_iters)
    u1 = args[0]
    outs = [torch.empty_like(u1) for _ in range(4)]
    iters = torch.empty(u1.shape[:1], dtype=torch.int32, device=u1.device)
    scal = torch.stack(args[13:16]).contiguous()
    l_t = args[8]
    code = lib.faldoi_k8v_loop(
        variant, *(t.data_ptr() for t in args[:9]), scal.data_ptr(),
        args[11].data_ptr(), args[12].data_ptr(), *(t.data_ptr() for t in outs),
        iters.data_ptr(), u1.shape[0], u1.shape[1], int(l_t.dim() != 0),
        max_iters, kb.stream_ptr(u1.device))
    kb.check(code, f"k8 loop variant {variant}")
    return (*outs, iters)


def call_nl(lib, variant, args, max_iters=4):
    """One launch of K16 form ``variant`` on ``nltvcsad_patch_loop``'s
    arguments, the duals kept; returns (u1, u2, v1, v2, iterations,
    duals)."""
    if variant == "library":
        from faldoi_tpu_torch.core.functionals import nltvcsad_patch_loop

        return nltvcsad_patch_loop(*args, max_iters, keep_duals=True)
    u1, duals, l_t = args[0], args[4], args[11]
    outs = [torch.empty_like(u1) for _ in range(4)]
    iters = torch.empty(u1.shape[:1], dtype=torch.int32, device=u1.device)
    dout = torch.empty((2, 24) + tuple(u1.shape), dtype=torch.float32,
                       device=u1.device)
    scal = torch.stack(args[16:19]).contiguous()
    code = lib.faldoi_k8v_nl(
        variant, *(t.data_ptr() for t in args[:4]),
        *(t.data_ptr() for t in args[5:12]), scal.data_ptr(),
        args[14].data_ptr(), args[15].data_ptr(),
        None if duals is None else duals.data_ptr(),
        *(t.data_ptr() for t in outs), iters.data_ptr(), dout.data_ptr(),
        u1.shape[0], u1.shape[1], int(l_t.dim() != 0), max_iters,
        kb.stream_ptr(u1.device))
    kb.check(code, f"k16 variant {variant}")
    return (*outs, iters, dout)


def turns(runs, want, name):
    """Every run bit for bit against ``want``, then timed twice in turns (a
    CUDA graph of 20 calls each); returns {key: [ms, ms]}."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms

    for key, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        if not all(same_bits(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"form {key} at {name} differs from its twin")
    out = {}
    for key in list(runs) + list(runs)[::-1]:
        out.setdefault(str(key), []).append(cuda_ms(runs[key], graph=True))
    return out


def time_loop(lib, args, variants=(0, "library"), max_iters=4):
    """The K8 loop's forms on ``args``, each held to the twin, timed in
    turns; returns {variant: [ms, ms]}."""
    from faldoi_tpu_torch.ops.csad import csad_patch_loop_plain

    want = csad_patch_loop_plain(*args, max_iters)
    return turns({v: (lambda v=v: call_loop(lib, v, args, max_iters))
                  for v in variants}, want, "K8 loop")


def time_nl(lib, args, variants=(0, "library"), max_iters=4):
    """K16's forms on ``args``, each held to the twin (the duals too),
    timed in turns; returns {variant: [ms, ms]}."""
    from faldoi_tpu_torch.core.functionals import nltvcsad_patch_loop_plain

    want = nltvcsad_patch_loop_plain(*args, max_iters, keep_duals=True)
    return turns({v: (lambda v=v: call_nl(lib, v, args, max_iters))
                  for v in variants}, want, "K16")


def time_row(name, runs, want, card, names):
    """Every run bit for bit against ``want``, then timed twice in turns."""
    row = dict(shape=name, card=card, **turns(runs, want, name))
    print(f"{name}: bit-exact, ms " + "  ".join(
        f"{names[k]}: {min(row[str(k)]):.4f}-{max(row[str(k)]):.4f}" for k in runs),
        flush=True)
    return row


def same_bits(a, b):
    if a is None or b is None:
        return a is b
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


# (d) the SASS of the P 11 loop forms: id -> the parts of its kernel's
# mangled name (and what it must not hold)
def _loop_name(v, nl=False):
    k = "nltvcsad_patch_kernelILi11E" if nl else "csad_loop_kernelILi11E"
    if v == 0:
        return (("former19" if nl else "former9"), k), ()
    zero = ("ZeroRule",)
    g, t, minb, sel = {2: (2, 256, 1, zero + ("RankedRegsILi2E",)),
                       4: (4, 1024, 1, zero + ("RankedRegsILi4E",)),
                       8: (8, 1024, 1, zero + ("RankedRegsILi8E",)),
                       10: (4, 512, 1, zero + ("RankedRegsILi4E",)),
                       11: (4, 512, 2, zero + ("RankedRegsILi4E",)),
                       12: (4, 512, 1, zero + ("RankedSmemILi4E",)),
                       13: (4, 512, 2, zero + ("RankedSmemILi4E",)),
                       14: (1, 128, 1, zero + ("RankedRegsILi1E",)),
                       15: (1, 512, 1, zero + ("RankedRegsILi1E",)),
                       16: (4, 512, 1, ("RankedRegsILi4E",)),
                       17: (4, 512, 2, ("RankedRegsILi4E",)),
                       18: (1, 128, 1, ("RankedRegsILi1E",)),
                       19: (4, 512, 2, ("RankedOutOfLineILi4E",)),
                       20: (4, 512, 1, ("RankedOutOfLineILi4E",)),
                       21: (4, 512, 2, ("RankedSmemILi4E",)),
                       22: (4, 512, 3, ("RankedOutOfLineILi4E",)),
                       NO_FALLBACK: (4, 512, 1, ("NoFallbackILi4E",)),
                       NO_FALLBACK_SMEM: (4, 512, 2, ("NoFallbackSmemILi4E",)),
                       STUB: (4, 512, 1, ("StubILi4E",))}[v]
    mid = f"Li{g}ELi{t}ELb1ELi{minb}E" if nl else f"Li{g}ELi{t}ELi{minb}E"
    return (k + mid, *sel), ("former",) + (() if sel[0] == "ZeroRule" else zero)


def _pd_loop(insts):
    """(instructions of the PD loop's body, of the loops inside it, and
    outside the PD loop): the PD loop is the smallest loop that holds the
    iteration's __syncthreads_or (BAR.RED); the compiler's loops around
    shuffles that may run diverged (WARPSYNC.COLLECTIVE, placed out of
    line) hold no barrier."""
    from faldoi_tpu_torch.cli.patch_variants import TARGET

    spans = {(int(m.group(1), 16), a) for a, i in insts
             for m in [TARGET.search(i)] if m and int(m.group(1), 16) < a}
    bars = [a for a, i in insts if "BAR.RED" in i]
    s, e = min((x for x in spans if any(x[0] <= b <= x[1] for b in bars)),
               key=lambda x: x[1] - x[0])
    inner = [x for x in spans if s <= x[0] and x[1] <= e and x != (s, e)]
    body = sum(s <= a <= e for a, _ in insts)
    return (body, sum(sum(x[0] <= a <= x[1] for a, _ in insts) for x in inner),
            len(insts) - body)


def sass_rows(lib_path, report, card, clock_mhz, iters=4):
    """(d): registers, spills and warps an SM of every P 11 loop form; the
    PD loop's body (inner loops counted once), split into the selection and
    the rest; the issue floor of the PD iterations of a call at B 8192."""
    from faldoi_tpu_torch.cli.patch_variants import (
        SCHEDULERS, find, ptxas_kernels, sass_functions, warps_an_sm,
    )

    funcs = sass_functions(lib_path)
    regs = ptxas_kernels(report)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue = sms * SCHEDULERS * clock_mhz * 1e6 / 1e3   # warp instructions a ms
    rows = []
    for nl, forms in ((False, LOOP_VARIANTS), (True, NL_VARIANTS)):
        body = {}
        for v in [v for v in forms if v not in ("library", 1)] + [
                NO_FALLBACK, NO_FALLBACK_SMEM, STUB]:
            parts, without = _loop_name(v, nl)
            fn = find(funcs, *parts, without=without)
            body[v] = (fn, *_pd_loop(funcs[fn]))
        rest = body[STUB][1] - body[STUB][2]
        # a ranked form's selection as it runs: its form without the fallback
        ranked = {k: body[k][1] - body[k][2] - rest for k in (NO_FALLBACK,
                                                            NO_FALLBACK_SMEM)}
        for v, (fn, pd, inner, outside) in body.items():
            g, t = {2: (2, 256), 4: (4, 1024), 8: (8, 1024), 14: (1, 128),
                    15: (1, 512), 18: (1, 128)}.get(v, (4, 512))
            cs = -(-121 * g // 32) * 32
            warps = 8192 * cs // 32
            kind = (NO_FALLBACK if v in (10, 11, 16, 17, 19, 20, 22, NO_FALLBACK)
                    else NO_FALLBACK_SMEM if v in (12, 13, 21, NO_FALLBACK_SMEM)
                    else None)
            sel = (pd - inner - rest if v == 0 else 0 if v == STUB
                   else ranked[kind] if kind else None)
            # the PD iterations as they run (the ranked forms without the
            # fallback they skip); the set-up outside the loop, whose static
            # count holds cold paths, is left out: a floor
            per_warp = iters * (rest + sel if kind else pd - inner)
            k = regs.get(fn, {})
            ranked_b = 48 if kind == NO_FALLBACK_SMEM else 0   # shared floats a cell
            smem = (t // cs) * 4 * ((1 + ranked_b) * 121 + 1 if not nl else
                                    (2 * 24 + 3 + 24 + ranked_b) * 121 + 1)
            row = dict(row="sass", kernel="K16" if nl else "K8 loop", form=v,
                       name=(NL_VARIANTS if nl else LOOP_VARIANTS).get(
                           v, {NO_FALLBACK: "ranked, no fallback (SASS only)",
                               NO_FALLBACK_SMEM: "ranked in shared memory, no "
                               "fallback (SASS only)",
                               STUB: "selection stubbed (SASS only)"}.get(v)),
                       card=card, clock_mhz=clock_mhz, pd_body=pd,
                       pd_inner_loops=inner, outside_pd=outside,
                       selection=sel, rest=rest,
                       fallback=(pd - inner) - (rest + sel) if kind else None,
                       warps=warps, floor_ms=warps * per_warp / issue, **k,
                       warps_an_sm=(warps_an_sm(k["registers"], t, smem)
                                    if "registers" in k else None))
            print("SASS " + json.dumps(row), flush=True)
            rows.append(row)
    return rows


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


LOOP_SHAPES = [("P 11 B 8192", 11, 8192, 4), ("P 11 B 676", 11, 676, 4),
               ("P 11 B 297", 11, 297, 4), ("P 11 B 1", 11, 1, 4),
               ("m5 P 11 B 1900", 11, 1900, 5), ("P 3 B 1703", 3, 1703, 4)]
NL_SHAPES = [("m6 P 11 B 8192", 11, 8192, 6, False), ("m6 P 11 B 676", 11, 676, 6, False),
             ("m6 P 11 B 297", 11, 297, 6, False), ("m6 P 11 B 1", 11, 1, 6, False),
             ("m7 P 11 B 1900, duals given", 11, 1900, 7, True),
             ("m6 P 3 B 1703", 3, 1703, 6, True)]


def main(argv=None) -> int:
    from faldoi_tpu_torch.ops.csad import csad_vstep, csad_vstep_plain

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="skip K8's v-step variants (a)")
    ap.add_argument("--global-only", action="store_true",
                    help="K14's and K15's forms (e) alone")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k8_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    clock = float(smi("clocks.max.sm").split()[0])
    print(card, f"max SM clock {clock} MHz", flush=True)
    glib, greport = build_global_variants()
    print("\n".join(greport), flush=True)
    rng = np.random.default_rng(0)
    gargs, frames = global_args(dev, rng)
    rows = global_rows(glib, greport, card, clock, frames, dev)
    if opts.global_only:
        return _finish(opts, greport, rows)
    lib, report = build_variants()
    print("\n".join(report), flush=True)
    if not opts.quick:
        shapes = [(f"{H}x{W}", gargs)] + [
            (f"P 11 B {nb}", patch_args(dev, rng, frames, nb)[0])
            for nb in (8192, 297, 1)]
        for name, args in shapes:
            runs = {v: (lambda v=v: call_variant(lib, v, args)) for v in VARIANTS
                    if v != "library"}
            runs["library"] = lambda: csad_vstep(*args)
            rows.append(time_row(f"K8 {name}", runs, csad_vstep_plain(*args[:9]),
                                 card, VARIANTS))
    for name, p, nb, m in LOOP_SHAPES:
        args = solve_args(dev, rng, frames, nb, p, m)
        forms = list(LOOP_VARIANTS) if p == 11 else [0, "library"]
        rows.append(time_row(f"K8 loop {name}",
                             {v: (lambda v=v: call_loop(lib, v, args)) for v in forms},
                             csad_patch_loop_plain_of(args), card, LOOP_VARIANTS))
        if p == 11:
            rows[-1]["stub_ms"] = stub_ms(lambda: call_loop(lib, STUB, args))
    for name, p, nb, m, d in NL_SHAPES:
        args = solve_args(dev, rng, frames, nb, p, m, d)
        forms = list(NL_VARIANTS) if p == 11 else [0, "library"]
        rows.append(time_row(f"K16 {name}",
                             {v: (lambda v=v: call_nl(lib, v, args)) for v in forms},
                             nltvcsad_patch_loop_plain_of(args), card, NL_VARIANTS))
        if p == 11:
            rows[-1]["stub_ms"] = stub_ms(lambda: call_nl(lib, STUB, args))
    rows += sass_rows(LIB, report, card, clock)
    return _finish(opts, greport + report, rows)


def _finish(opts, report, rows):
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(dict(ptxas=report, rows=rows), fh, indent=1)
    print(json.dumps([r for r in rows if r.get("row") not in ("sass", "ptxas")]))
    return 0


def stub_ms(fn):
    """The card's ms of a form whose selection is a stub (med = dot): the
    rest of the loop alone, the same PD iterations as the library's only
    where the tol does not stop a canvas (not held to the twin)."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms

    ms = cuda_ms(fn, graph=True)
    print(f"  selection stubbed: {ms:.4f} ms", flush=True)
    return ms


def csad_patch_loop_plain_of(args, max_iters=4):
    from faldoi_tpu_torch.ops.csad import csad_patch_loop_plain

    return csad_patch_loop_plain(*args, max_iters)


def nltvcsad_patch_loop_plain_of(args, max_iters=4):
    from faldoi_tpu_torch.core.functionals import nltvcsad_patch_loop_plain

    return nltvcsad_patch_loop_plain(*args, max_iters, keep_duals=True)


if __name__ == "__main__":
    sys.exit(main())

"""K10's and K11's former forms and design variants against the library's
forms on one CUDA card.

    python -m faldoi_tpu_torch.cli.fill_variants [--out FILE.json]

Builds ``csrc/variants/fill_variants.cu`` (the former forms: K10 as one
launch a flood direction with a distance buffer, K11 as one launch a Jacobi
iteration on the 25 weight planes; the library's forms at other block
sizes, batches, tiled strides and strip widths, K10's barriers alone) with the library's nvcc flags into ``faldoi_tpu_torch/_build/``,
then at 436x1024 holds every form bit for bit to the plain twin and times
it (a CUDA graph of 20 calls), twice in turns within this process: K10 at L
2, 1 and 8 on 1703 finite cells a lane at random positions (as many as the
golden DeepMatching seeds), K11 at L 2 with half the cells trusted.  It also
times K11's host set-up once a pair: the 5 colour planes to the card
against the former construction of the 25 weight planes
(``former_weights``).  Prints the card's name and power limit and one line
a row; ``--out`` also writes the rows as JSON.  Needs a CUDA card.
``chip_smoke.py`` calls ``time_k10`` and ``time_k11`` on its own inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb

H, W = 436, 1024
SRC = kb.CSRC / "variants" / "fill_variants.cu"
SEEDS = 1703


def build_variants():
    """nvcc the variants into a shared library; returns it."""
    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kb.BUILD_DIR / "libfill_variants.so"
    cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-shared", "-I", str(kb.CSRC), "-o",
           str(out), str(SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.faldoi_k10v_per_direction.argtypes = [p] * 5 + [i] * 5 + [f, p]
    lib.faldoi_k11v_per_iteration.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.faldoi_k10v_form.argtypes = [p] * 4 + [i] * 5 + [f, i, i, i, i, p]
    lib.faldoi_k11v_strips.argtypes = [p] * 7 + [i] * 6 + [p]
    for fn in (lib.faldoi_k10v_per_direction, lib.faldoi_k11v_per_iteration,
               lib.faldoi_k10v_form, lib.faldoi_k11v_strips):
        fn.restype = ctypes.c_int
    return lib


def former_weights(i0n: torch.Tensor) -> torch.Tensor:
    """K11's 25 weight planes as the former form built them on the host: an
    exponential a tap (float64, rounded once), times the inside mask and
    the spatial constant."""
    from faldoi_tpu_torch.core.bilateral import SHIFTS, SPATIAL, _row_shift
    from faldoi_tpu_torch.params import SIGMA_BILATERAL_COLOR

    i0 = i0n.detach().cpu().numpy().astype(np.float32)
    h, w = i0.shape
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    sig = np.float32(SIGMA_BILATERAL_COLOR)
    out = np.empty((len(SHIFTS), h, w), np.float32)
    for s, (dy, dx) in enumerate(SHIFTS):
        t = (i0 - _row_shift(i0, dy)) / sig
        a = np.float32(-0.5) * (t * t)
        e = np.exp(a.astype(np.float64)).astype(np.float32)
        inside = (((yy + dy >= 0) & (yy + dy < h))
                  & ((xx + dx >= 0) & (xx + dx < w))).astype(np.float32)
        out[s] = np.float32(SPATIAL[dy * dy + dx * dx]) * (e * inside)
    return torch.as_tensor(out, device=i0n.device)


def k10_former(lib, x: torch.Tensor, smooth_iters: int = 6,
               timestep: float = 0.4) -> torch.Tensor:
    """K10's former form on (L, C, h, w) float32 planes on the card."""
    nl, c, h, w = x.shape
    out = torch.empty_like(x)
    seeds = torch.empty((2, nl, h, w), dtype=torch.int32, device=x.device)
    best = torch.empty((nl, h, w), dtype=torch.float32, device=x.device)
    kb.check(lib.faldoi_k10v_per_direction(
        x.data_ptr(), out.data_ptr(), seeds[0].data_ptr(), seeds[1].data_ptr(),
        best.data_ptr(), nl, c, h, w, smooth_iters, timestep,
        kb.stream_ptr(x.device)), "k10v_per_direction")
    return out


def k11_former(lib, weights, u1, u2, keep, iters: int = 10):
    """K11's former form: (L, h, w) flow lanes, uint8 keep, the 25 planes."""
    nl, h, w = u1.shape
    o1, o2 = torch.empty_like(u1), torch.empty_like(u2)
    scratch = torch.empty((4,) + tuple(u1.shape), dtype=torch.float32,
                          device=u1.device)
    kb.check(lib.faldoi_k11v_per_iteration(
        weights.data_ptr(), keep.data_ptr(), u1.data_ptr(), u2.data_ptr(),
        scratch.data_ptr(), o1.data_ptr(), o2.data_ptr(), nl, h, w, iters,
        kb.stream_ptr(u1.device)), "k11v_per_iteration")
    return o1, o2


# K10's forms timed by main(): (threads a block, cells a batch in the
# grid-wide phases, the largest stride run in tiles); the library's is
# (1024, 4, 0)
K10_FORMS = ((256, 1, 0), (512, 4, 0), (1024, 1, 0), (1024, 4, 0),
             (1024, 4, 2), (1024, 4, 8), (1024, 4, 16), (512, 4, 8))


def k10_form(lib, x: torch.Tensor, nt: int, b: int, kt: int,
             barriers_only: bool = False, smooth_iters: int = 6,
             timestep: float = 0.4) -> torch.Tensor:
    """The library's K10 at ``nt`` threads a block, ``b`` cells a batch in
    the grid-wide phases and the strides up to ``kt`` in tiles;
    ``barriers_only``: its grid and barriers without a cell (the output
    stays unwritten)."""
    nl, c, h, w = x.shape
    out = torch.empty_like(x)
    seeds = torch.empty((2, nl, h, w), dtype=torch.int32, device=x.device)
    kb.check(lib.faldoi_k10v_form(
        x.data_ptr(), out.data_ptr(), seeds[0].data_ptr(), seeds[1].data_ptr(),
        nl, c, h, w, smooth_iters, timestep, nt, b, kt, int(barriers_only),
        kb.stream_ptr(x.device)), "k10v_form")
    return out


def k11_strips(lib, colour, u1, u2, keep, sw: int, nt: int, iters: int = 10):
    """The library's K11 on strips of ``sw`` columns, ``nt`` threads a
    block."""
    from faldoi_tpu_torch.core.bilateral import spatial_taps

    nl, h, w = u1.shape
    o1, o2 = torch.empty_like(u1), torch.empty_like(u2)
    spatial = spatial_taps()
    kb.check(lib.faldoi_k11v_strips(
        colour.data_ptr(), spatial.data_ptr(), keep.data_ptr(), u1.data_ptr(),
        u2.data_ptr(), o1.data_ptr(), o2.data_ptr(), nl, h, w, iters, sw, nt,
        kb.stream_ptr(u1.device)), "k11v_strips")
    return o1, o2


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def turns(runs):
    """Time every run twice in turns (a, b, .., b, a); ms lists by key."""
    out = {}
    for key, fn in list(runs.items()) + list(runs.items())[::-1]:
        out.setdefault(key, []).append(fn())
    return out


def time_k10(lib, x: torch.Tensor) -> dict:
    """The library's K10 and its former form on ``x`` (L, C, h, w) on the
    card, each held bit for bit to the twin first, then timed in turns (a
    CUDA graph of 20 calls each, the finite-set check off)."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image, nearest_fill_image_plain

    want = nearest_fill_image_plain(x)
    launches = nearest_fill_image.launches
    for name, got in (("library", nearest_fill_image(x)),
                      ("former", k10_former(lib, x))):
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"K10 {name} form differs from its twin at "
                                 f"{tuple(x.shape)}")
    ms = turns({"library": lambda: cuda_ms(
                    lambda: nearest_fill_image(x, check=False), graph=True),
                "former": lambda: cuda_ms(lambda: k10_former(lib, x),
                                          graph=True)})
    nearest_fill_image.launches = launches
    return ms


def time_k11(lib, frame, u1, u2, trust, fixed) -> dict:
    """The library's K11 and its former form on (L, h, w) lanes of
    ``frame`` on the card, each held bit for bit to the twin first, then
    timed in turns (a CUDA graph of 20 calls each); and the host set-up once
    a pair, ms: the 5 colour planes to the card against the former 25-plane
    construction (``setup_ms``, ``former_setup_ms``)."""
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.bilateral import (
        _keep, bilateral_colour_planes, bilateral_filter_flow,
        bilateral_filter_flow_plain, bilateral_weights,
    )

    colour = bilateral_colour_planes(frame)
    weights = former_weights(frame)
    if not same_bits(weights, bilateral_weights(frame, colour)):
        raise AssertionError("K11's 25 planes from the colour planes differ "
                             "from the former construction")
    keep = _keep(trust, fixed).to(torch.uint8).contiguous()
    want = bilateral_filter_flow_plain(weights, u1, u2, trust, fixed)
    launches = bilateral_filter_flow.launches
    for name, got in (("library", bilateral_filter_flow(
                           frame, u1, u2, trust, fixed, colour=colour)),
                      ("former", k11_former(lib, weights, u1, u2, keep))):
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K11 {name} form differs from its twin at "
                                 f"{tuple(u1.shape)}")

    def setup(fn):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(frame)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / 5 * 1e3
        return run

    ms = turns({"library": lambda: cuda_ms(lambda: bilateral_filter_flow(
                    frame, u1, u2, trust, fixed, colour=colour), graph=True),
                "former": lambda: cuda_ms(lambda: k11_former(
                    lib, weights, u1, u2, keep), graph=True),
                "setup": setup(bilateral_colour_planes),
                "former_setup": setup(former_weights)})
    bilateral_filter_flow.launches = launches
    return ms


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None) -> int:
    from faldoi_tpu_torch.cli.kernel_probe import cuda_ms
    from faldoi_tpu_torch.core.bilateral import _keep, bilateral_colour_planes

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fill_variants: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(card, flush=True)
    lib = build_variants()
    rng = np.random.default_rng(0)
    rows = []
    for lanes in (2, 1, 8):
        x = np.full((lanes, 2, H, W), np.nan, np.float32)
        for lane in range(lanes):
            cells = rng.choice(H * W, SEEDS, replace=False)
            x[lane][:, cells // W, cells % W] = rng.normal(size=(2, SEEDS))
        xg = torch.as_tensor(x, device=dev)
        ms = time_k10(lib, xg)
        want = k10_former(lib, xg)
        runs = {}
        for form in K10_FORMS:
            if not same_bits(k10_form(lib, xg, *form), want):
                raise AssertionError(f"K10 form {form} differs")
            key = "_".join(map(str, form))
            runs[f"form_{key}"] = (lambda f=form: cuda_ms(
                lambda: k10_form(lib, xg, *f), graph=True))
            runs[f"barriers_only_{key}"] = (lambda f=form: cuda_ms(
                lambda: k10_form(lib, xg, *f, True), graph=True))
        ms.update(turns(runs))
        rows.append(dict(kernel="K10", shape=f"L {lanes} x 2 x {H}x{W}, "
                         f"{SEEDS} finite cells a lane", card=card, **ms))
    frame = torch.as_tensor(rng.random((H, W)).astype(np.float32), device=dev)
    u = torch.as_tensor(rng.normal(size=(2, 2, H, W)).astype(np.float32),
                        device=dev)
    trust = torch.as_tensor((rng.random((2, H, W)) < 0.5).astype(np.int32),
                            device=dev)
    fixed = torch.zeros_like(trust)
    ms = time_k11(lib, frame, u[0], u[1], trust, fixed)
    colour = bilateral_colour_planes(frame)
    keep = _keep(trust, fixed).to(torch.uint8).contiguous()
    want = k11_former(lib, former_weights(frame), u[0], u[1], keep)
    runs = {}
    for sw in (8, 4, 2):
        for nt in (256, 512):
            got = k11_strips(lib, colour, u[0], u[1], keep, sw, nt)
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K11 at sw {sw}, {nt} threads differs")
            runs[f"strips_{sw}_{nt}"] = (lambda sw=sw, nt=nt: cuda_ms(
                lambda: k11_strips(lib, colour, u[0], u[1], keep, sw, nt),
                graph=True))
    ms.update(turns(runs))
    rows.append(dict(kernel="K11", shape=f"L 2 x {H}x{W}, half trusted",
                     card=card, **ms))
    for r in rows:
        print(json.dumps(r), flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The probe path: P1-P3 on the card against their plain twins.

The counterpart of ``scripts/tpu_pallas_probe.py`` and
``scripts/tpu_pallas_gather_probe.py``::

    python -m faldoi_tpu_torch.cli.kernel_probe

It builds the kernels, runs P1 (``2x + y``, (256, 256), and (4096, 4096)
beside it, where the time is the kernel's and not the launch's), P2 (the roll loop,
(11, 11, 1024)) and P3 (the window fetch, planes (3, 440, 1024), B = 1024,
the probe's default, and B = 8192, the sweep's batch) at the scripts'
shapes, checks each against its twin (P1 and P2 bit for bit, P3 within
relative 1e-5) and prints milliseconds per call (CUDA events, after a
warm-up): the kernel's from a CUDA graph of 20 calls (the card's time) and
called eagerly (each call goes through ctypes, so P1 and P2 then measure
the host's launch rate), the twin's, the bound (bytes over 3.35 TB/s or
float32 operations over 67 TFLOP/s) and, for P1, one ``torch.add``; and
GB/s for P3 (its kernel alone, then with the wrapper's origin check, which
reads a flag back from the card).  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

P3_RTOL = 1e-5
P3_PLANES = (3, 440, 1024)     # H padded to a multiple of 8, W of 128
# the H100 SXM's published peaks (NVIDIA's data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def cuda_ms(fn, reps=20, warmup=3, graph=False):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events).

    Called eagerly, a call whose kernels take less time than the host needs
    to issue it measures the host.  ``graph=True`` captures ``reps`` calls
    into one CUDA graph and times its replay: the card's time for the
    kernels, back to back, without the host's share."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    replays = 0
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        replays = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        for _ in range(replays):
            g.replay()
    else:
        for _ in range(reps):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * max(replays, 1))


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the memory
    rate and its float32 operations over the peak, and which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def touched(shape, rows: torch.Tensor, cols: torch.Tensor) -> int:
    """Distinct (row, col) cells of a ``shape`` grid that windows read:
    rows (B, r) and cols (B, c) index each window's rows and columns."""
    mask = torch.zeros(shape, dtype=torch.bool, device=rows.device)
    mask[rows[:, :, None], cols[:, None, :]] = True
    return int(mask.sum())


def window_origins(b: int, rng, shape=P3_PLANES):
    """P3's random aligned origins, as the TPU probe draws them."""
    from faldoi_tpu_torch.ops.probes import WIN_COLS, WIN_ROW_ALIGN, WIN_ROWS

    _, h, w = shape
    oy8 = rng.integers(0, (h - WIN_ROWS) // WIN_ROW_ALIGN, b) * WIN_ROW_ALIGN
    cb = rng.integers(0, (w - WIN_COLS) // WIN_COLS, b) * WIN_COLS
    return oy8.astype(np.int32), cb.astype(np.int32)


# P1's shapes: the TPU probe's, and one large enough that the launch floor
# does not hide the kernel; timings of kernel and yardstick, in turns
P1_SHAPES = ((256, 256), (4096, 4096))
P1_REPEATS = 5


def check_p1(dev, rng):
    """P1 against its twin (bit for bit) and against its yardstick, one
    ``torch.add(y, x, alpha=2)``, at the probe's shape and at a shape large
    enough to measure the kernel and not the launch.  Kernel and yardstick
    are timed in turns, ``P1_REPEATS`` graph timings each: the record keeps
    the medians and both spreads."""
    from faldoi_tpu_torch.ops.probes import probe_axpy, probe_axpy_plain

    rows = []
    for shape in P1_SHAPES:
        x, y = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                device=dev) for _ in range(2))
        got, want = probe_axpy(x, y), probe_axpy_plain(x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"P1 probe_axpy {shape} differs from its twin")
        del got, want
        ours, lib = [], []
        for _ in range(P1_REPEATS):
            ours.append(cuda_ms(lambda: probe_axpy(x, y), graph=True))
            lib.append(cuda_ms(lambda: torch.add(y, x, alpha=2), graph=True))
        n = x.numel()
        rows.append(dict(shape=str(shape), ms=float(np.median(ours)),
                         ms_spread=[min(ours), max(ours)],
                         eager_ms=cuda_ms(lambda: probe_axpy(x, y)),
                         plain_ms=cuda_ms(lambda: probe_axpy_plain(x, y)),
                         library_ms=float(np.median(lib)),
                         library_spread=[min(lib), max(lib)],
                         **bound(3 * n * 4, 2 * n)))
    return dict(name="probe_axpy", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_probe.py:23", max_abs_err=0.0,
                **rows[0], shapes=rows)


def check_p2(dev, rng):
    from faldoi_tpu_torch.ops.probes import probe_roll4, probe_roll4_plain

    x = torch.as_tensor(rng.standard_normal((11, 11, 1024)).astype(np.float32),
                        device=dev)
    got, want = probe_roll4(x), probe_roll4_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("P2 probe_roll4 differs from its twin")
    n = x.numel()
    return dict(name="probe_roll4", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_probe.py:47", shape="(11, 11, 1024)",
                max_abs_err=0.0, ms=cuda_ms(lambda: probe_roll4(x), graph=True),
                eager_ms=cuda_ms(lambda: probe_roll4(x)),
                plain_ms=cuda_ms(lambda: probe_roll4_plain(x)), library_ms=None,
                **bound(2 * n * 4, 4 * 2 * n))     # 4 steps of a mul and an add


def check_p3(dev, rng, b):
    from faldoi_tpu_torch.ops.probes import (
        WIN_COLS, WIN_ROWS, launch_window_fetch, probe_window_fetch,
        probe_window_fetch_plain,
    )

    planes = torch.as_tensor(rng.uniform(0, 1, P3_PLANES).astype(np.float32),
                             device=dev)
    oy8, cb = (torch.as_tensor(a, device=dev) for a in window_origins(b, rng))
    got = probe_window_fetch(planes, oy8, cb)
    want = probe_window_fetch_plain(planes, oy8, cb)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    if not rel <= P3_RTOL:
        raise AssertionError(f"P3 probe_window_fetch B={b}: relative error "
                             f"{rel} > {P3_RTOL}")
    # the kernel alone (origins checked above), and the wrapper with its check
    ms = cuda_ms(lambda: launch_window_fetch(planes, oy8, cb), graph=True)
    eager = cuda_ms(lambda: launch_window_fetch(planes, oy8, cb))
    wrapper = cuda_ms(lambda: probe_window_fetch(planes, oy8, cb))
    plain = cuda_ms(lambda: probe_window_fetch_plain(planes, oy8, cb), reps=5)
    nbytes = b * (P3_PLANES[0] * WIN_ROWS * WIN_COLS + WIN_COLS) * 4
    rows = oy8.long()[:, None] + torch.arange(WIN_ROWS, device=dev)
    cols = cb.long()[:, None] + torch.arange(WIN_COLS, device=dev)
    cells = touched(P3_PLANES[1:], rows, cols)
    least = bound(cells * P3_PLANES[0] * 4 + b * (2 + WIN_COLS) * 4,
                  b * P3_PLANES[0] * WIN_ROWS * WIN_COLS)   # one add a float
    return dict(name="probe_window_fetch", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_gather_probe.py:76",
                shape=f"planes {P3_PLANES}, B={b}", max_abs_err=err,
                rel_err=rel, ms=ms, eager_ms=eager, wrapper_ms=wrapper, plain_ms=plain,
                library_ms=None, gbps=nbytes / ms / 1e6, **least)


def run_probes(dev, rng):
    """Every probe against its twin at the scripts' shapes (P3 also at the
    sweep's B), timed; returns one record per run."""
    return [check_p1(dev, rng), check_p2(dev, rng), check_p3(dev, rng, 1024),
            check_p3(dev, rng, 8192)]


def describe(r) -> str:
    if "shapes" in r:       # one line a shape
        return "\n".join(describe({k: v for k, v in dict(r, **row).items()
                                   if k != "shapes"}) for row in r["shapes"])
    line = (f"{r['name']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.4f} ms (eager {r['eager_ms']:.4f})  twin "
            f"{r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    if r["library_ms"] is not None:
        line += f"  one PyTorch call {r['library_ms']:.4f} ms"
    if "ms_spread" in r:
        line += (f"  ({P1_REPEATS} timings in turns: kernel "
                 f"{r['ms_spread'][0]:.4f}-{r['ms_spread'][1]:.4f}, the call "
                 f"{r['library_spread'][0]:.4f}-{r['library_spread'][1]:.4f})")
    if "gbps" in r:
        line += (f"  {r['gbps']:.1f} GB/s (rel err {r['rel_err']:.2e}); with "
                 f"the origin check {r['wrapper_ms']:.4f} ms")
    return line


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from faldoi_tpu_torch.kernels import build as kb

    kb.library()
    recs = run_probes(torch.device("cuda"), np.random.default_rng(0))
    for r in recs:
        print(describe(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The probe path: P1-P3 on the card against their plain twins.

The counterpart of ``scripts/tpu_pallas_probe.py`` and
``scripts/tpu_pallas_gather_probe.py``::

    python -m faldoi_tpu_torch.cli.kernel_probe

It builds the kernels, runs P1 (``2x + y``, (256, 256)), P2 (the roll loop,
(11, 11, 1024)) and P3 (the window fetch, planes (3, 440, 1024), B = 1024,
the probe's default, and B = 8192, the sweep's batch) at the scripts'
shapes, checks each against its twin (P1 and P2 bit for bit, P3 within
relative 1e-5) and prints the kernel's and the twin's milliseconds per call
(CUDA events, after a warm-up; each call goes through ctypes, so P1 and P2
are bound by the host's launch rate), and GB/s for P3 (its kernel alone,
then with the wrapper's origin check, which reads a flag back from the
card).  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

P3_RTOL = 1e-5
P3_PLANES = (3, 440, 1024)     # H padded to a multiple of 8, W of 128


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def window_origins(b: int, rng, shape=P3_PLANES):
    """P3's random aligned origins, as the TPU probe draws them."""
    from faldoi_tpu_torch.ops.probes import WIN_COLS, WIN_ROW_ALIGN, WIN_ROWS

    _, h, w = shape
    oy8 = rng.integers(0, (h - WIN_ROWS) // WIN_ROW_ALIGN, b) * WIN_ROW_ALIGN
    cb = rng.integers(0, (w - WIN_COLS) // WIN_COLS, b) * WIN_COLS
    return oy8.astype(np.int32), cb.astype(np.int32)


def check_p1(dev, rng):
    from faldoi_tpu_torch.ops.probes import probe_axpy, probe_axpy_plain

    x, y = (torch.as_tensor(rng.standard_normal((256, 256)).astype(np.float32),
                            device=dev) for _ in range(2))
    got, want = probe_axpy(x, y), probe_axpy_plain(x, y)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("P1 probe_axpy differs from its twin")
    return dict(name="probe_axpy", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_probe.py:23", shape="(256, 256)",
                max_abs_err=0.0, ms=cuda_ms(lambda: probe_axpy(x, y)),
                plain_ms=cuda_ms(lambda: probe_axpy_plain(x, y)))


def check_p2(dev, rng):
    from faldoi_tpu_torch.ops.probes import probe_roll4, probe_roll4_plain

    x = torch.as_tensor(rng.standard_normal((11, 11, 1024)).astype(np.float32),
                        device=dev)
    got, want = probe_roll4(x), probe_roll4_plain(x)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("P2 probe_roll4 differs from its twin")
    return dict(name="probe_roll4", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_probe.py:47", shape="(11, 11, 1024)",
                max_abs_err=0.0, ms=cuda_ms(lambda: probe_roll4(x)),
                plain_ms=cuda_ms(lambda: probe_roll4_plain(x)))


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
    ms = cuda_ms(lambda: launch_window_fetch(planes, oy8, cb))
    wrapper = cuda_ms(lambda: probe_window_fetch(planes, oy8, cb))
    plain = cuda_ms(lambda: probe_window_fetch_plain(planes, oy8, cb), reps=5)
    nbytes = b * (P3_PLANES[0] * WIN_ROWS * WIN_COLS + WIN_COLS) * 4
    return dict(name="probe_window_fetch", route="cuda",
                source="faldoi_tpu_torch/csrc/probes.cu",
                replaces="scripts/tpu_pallas_gather_probe.py:76",
                shape=f"planes {P3_PLANES}, B={b}", max_abs_err=err,
                rel_err=rel, ms=ms, wrapper_ms=wrapper, plain_ms=plain,
                gbps=nbytes / ms / 1e6)


def run_probes(dev, rng):
    """Every probe against its twin at the scripts' shapes (P3 also at the
    sweep's B), timed; returns one record per run."""
    return [check_p1(dev, rng), check_p2(dev, rng), check_p3(dev, rng, 1024),
            check_p3(dev, rng, 8192)]


def describe(r) -> str:
    line = (f"{r['name']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.4f} ms  twin {r['plain_ms']:.4f} ms")
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

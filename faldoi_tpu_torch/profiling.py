"""Stage timing and device tracing of the port's CLIs.

Port of ``faldoi_tpu/profiling.py``: ``StageTimer`` collects named
wall-clock spans and prints the reference's style of percentage breakdown
(local_faldoi.cpp:1074-1282, global_faldoi.cpp:621-845); ``device_trace`` is
the counterpart of its ``jax.profiler`` trace, a ``torch.profiler`` trace
written as a Chrome trace into a directory.  A stage that runs on the card
ends in a host read of its result, so its span includes the device work.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional


class StageTimer:
    """Collects named wall-clock spans and prints a breakdown."""

    def __init__(self, enabled: bool = True, out=sys.stderr):
        self.enabled = enabled
        self.out = out
        self.spans: Dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.time() - t
            if self.enabled:
                print(f"({name}) took {self.spans[name]:.3f}s", file=self.out)

    def report(self):
        """Total + percentage breakdown (tvl2OF profiling style,
        global_faldoi.cpp:824-843)."""
        total = time.time() - self._t0
        if not self.enabled:
            return
        print(f"all stages took {total:.3f}s", file=self.out)
        for name, s in sorted(self.spans.items(), key=lambda kv: -kv[1]):
            print(f"\t({name}) total: {s:.3f}, perc.: {100 * s / total:.1f}%",
                  file=self.out)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block (host ops, and the card's
    kernels when CUDA is available) written to ``logdir/trace.json``; a
    no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

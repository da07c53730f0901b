"""Iterated FALDOI local minimization for method 0 (``match_growing``).

Port of ``faldoi_tpu/core/match_growing.py`` in the semantics of its CPU
default, ``mode="fused"`` (``_iterated_growing``, local_faldoi.cpp:
1060-1741): per outer iteration a forward drain and a backward drain, FB
pruning, and the warm requeue with band 10; then a final forward-only drain.
The floor scale is 64 in iteration 0 and 16 after.  JAX drains the two
directions in lockstep; a drained lane's sweeps are no-ops there, so draining
them one after the other, as here, gives the same states.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.functionals import make_solver_consts
from faldoi_tpu_torch.core.local_step import (
    GrowState, drain, init_state, insert_seeds,
)
from faldoi_tpu_torch.core.pruning import prune
from faldoi_tpu_torch.models import method_local_params

# match_growing's defaults (floor scale of iteration 0 and of the requeue
# drains; warm-requeue band in px)
FLOOR_SCALE = 64
FLOOR_SCALE_LATE = 16
WARM_BAND = 10


def warm_requeue(state: GrowState, trust, h: int, w: int,
                 band: int) -> GrowState:
    """``_warm_requeue``: trusted pixels farther than ``band`` px from any
    pruned hole stay fixed; trusted pixels inside the band re-queue as
    candidates; pruned pixels lose their flow and poison the working flow.
    The dilation does not wrap at the image edge."""
    n = h * w
    bad2d = trust[:n].view(h, w) == 0
    x = bad2d.to(torch.float32)[None, None]
    k = 2 * band + 1
    x = torch.nn.functional.max_pool2d(x, (k, 1), stride=1, padding=(band, 0))
    x = torch.nn.functional.max_pool2d(x, (1, k), stride=1, padding=(0, band))
    pad1 = torch.zeros((1,), dtype=torch.bool, device=trust.device)
    near = torch.cat([x[0, 0].reshape(n) > 0, pad1])
    bad = torch.cat([bad2d.reshape(n), pad1])
    ok = ~bad & torch.isfinite(state.out_u) & torch.isfinite(state.out_v)
    requeue = ok & near
    keep = ok & ~near
    zero = torch.zeros((), device=trust.device)
    inf = torch.full((), float("inf"), device=trust.device)
    nan = torch.full((), float("nan"), device=trust.device)
    nanv = torch.where(bad, nan, zero)
    return state._replace(
        cand_u=torch.where(requeue, state.out_u, zero),
        cand_v=torch.where(requeue, state.out_v, zero),
        cand_e=torch.where(requeue, state.ene, inf),
        fixed=keep,
        ene=torch.where(keep, state.ene, inf),
        out_u=torch.where(keep, state.out_u, nan),
        out_v=torch.where(keep, state.out_v, nan),
        wu=state.wu + nanv,
        wv=state.wv + nanv,
    )


def flow_of(state: GrowState, h: int, w: int) -> torch.Tensor:
    n = h * w
    return torch.stack([state.out_u[:n].view(h, w),
                        state.out_v[:n].view(h, w)], dim=-1)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def match_growing(go: np.ndarray, ba: np.ndarray, i0n: torch.Tensor,
                  i1n: torch.Tensor, prm: P.Parameters,
                  sal_go: Optional[np.ndarray] = None,
                  sal_ba: Optional[np.ndarray] = None, bsz: int = 4096,
                  seed_bsz: int = 2048, stats=None):
    """Grow the (h, w, 2) NaN-sparse forward seeds ``go`` and backward seeds
    ``ba`` over the normalized, smoothed frames ``i0n``, ``i1n`` (tensors on
    the run's device).  Returns (flow (h, w, 2), energy (h, w)) of the forward
    direction, as tensors on that device.

    ``stats`` (a dict, optional) receives the stage seconds and the sweeps
    of every drain."""
    if prm.val_method != P.M_TVL1:
        raise NotImplementedError(f"method {prm.val_method} not ported yet")
    dev = i0n.device
    h, w = i0n.shape
    n = h * w
    bsz = min(bsz, n)
    wr = prm.w_radio
    p = 2 * wr + 1
    lam, theta, tau = method_local_params(prm.val_method, wr)
    sc = (make_solver_consts(i0n, i1n, lam, theta, tau, prm.tol_OF, p),
          make_solver_consts(i1n, i0n, lam, theta, tau, prm.tol_OF, p))
    max_iters = max(prm.max_iter_patch, 1)
    stats = {} if stats is None else stats
    stats.setdefault("sweeps", [])
    stats.setdefault("seconds", {})

    def mksal(s):
        base = np.ones(n + 1, np.float32)
        if s is not None:
            base[:n] = np.asarray(s, np.float32).ravel()
        return torch.as_tensor(base, device=dev)

    sal = (mksal(sal_go), mksal(sal_ba))
    t = time.perf_counter()

    def tick(label):
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        stats["seconds"][label] = now - t
        t = now

    st = [init_state(h, w, dev), init_state(h, w, dev)]
    for lane, seeds in enumerate((go, ba)):
        st[lane] = insert_seeds(st[lane], seeds, sc[lane], sal[lane],
                                prm.warps, max_iters, seed_bsz=seed_bsz)
    tick("seed_insertion")

    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    trust2d = [ones, ones]

    def run_drain(lane, it, fs):
        s, k = drain(st[lane], sc[lane], trust2d[lane], sal[lane], it, h, w,
                     wr, bsz, prm.warps, max_iters, fs)
        st[lane] = s
        stats["sweeps"].append({"it": it, "lane": ("fwd", "bwd")[lane],
                                "sweeps": k})

    for it in range(prm.iterations_of):
        fs = FLOOR_SCALE if it == 0 else FLOOR_SCALE_LATE
        for lane in (0, 1):
            run_drain(lane, it, fs)
            tick(f"drain_it{it}_{('fwd', 'bwd')[lane]}")
        tg, tb = prune(i0n, i1n, flow_of(st[0], h, w), flow_of(st[1], h, w),
                       prm.epsilon)
        for lane, tr in enumerate((tg, tb)):
            trust = torch.cat([tr.reshape(-1),
                               torch.ones((1,), dtype=tr.dtype, device=dev)])
            trust2d[lane] = tr.to(torch.float32)
            st[lane] = warm_requeue(st[lane], trust, h, w, WARM_BAND)
        tick(f"prune_requeue_it{it}")

    run_drain(0, prm.iterations_of, FLOOR_SCALE_LATE)
    tick("drain_final_fwd")
    return flow_of(st[0], h, w), st[0].ene[:n].view(h, w)

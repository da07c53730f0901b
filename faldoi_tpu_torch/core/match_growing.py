"""Iterated FALDOI local minimization for methods 0-8 (``match_growing``).

Port of ``faldoi_tpu/core/match_growing.py`` in the semantics of its CPU
default, ``mode="fused"`` (``_iterated_growing``, local_faldoi.cpp:
1060-1741): per outer iteration a forward drain and a backward drain, FB
pruning, and a requeue; then a final forward-only drain.  The requeue is the
warm one with band 10 by default; ``warm_band=0`` gives the cold requeue, the
reference's full re-grow of every outer iteration (``_delete_untrusted`` +
``_insert_potential``, local_faldoi.cpp:283-311, 813-870).  The floor scale
is ``floor_scale`` (64) in iteration 0 and ``floor_scale_late`` (by default
``min(floor_scale, 16)``) after.  The throttles are arguments here, where
JAX also reads them from its ``FALDOI_GROW_*`` environment; the port reads
no environment.  JAX drains the two directions in
lockstep; a drained lane's sweeps are no-ops there, so draining them one
after the other, as here, gives the same states.

Method 8 (TV-L1 with occlusions) grows over four frames: the forward lane
warps I1 at +u and I-1 at -u with g from I0's gradient, the backward lane
I0 at +u and I2 at -u with g from I1's (JAX's match_growing.py:662-690), and
its patch PD cap is ``prm.iterations_of``, not ``max_iter_patch``
(:702-705).

The occlusion output is JAX's ``out_chi`` of the forward lane: every
requeue, warm or cold, sets it to 1 at the pixels the pruning distrusted
(match_growing.py:73,152).  For methods 0-7 no sweep touches it, so it is
the union of the forward lane's pruned masks; for method 8 the sweeps carry
the solved chi into it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.functionals import make_solver_consts, solver_for
from faldoi_tpu_torch.core.local_step import (
    GrowState, drain, exact_fill, init_state, insert_seeds,
)
from faldoi_tpu_torch.core.pruning import prune
from faldoi_tpu_torch.io.flo import write_flo
from faldoi_tpu_torch.models import method_local_params

# partial-results snapshots: forward fixed fraction thresholds, in percent
# (local_faldoi.cpp:895), checked at the forward drains' sync points
SNAPSHOT_PCTS = (30, 70, 80, 95)


def delete_untrusted(state: GrowState, trust) -> GrowState:
    """delete_not_trustable_candidates (local_faldoi.cpp:283-311): untrusted
    pixels lose their flow and energy, poison the working flow and are
    marked occluded (``out_chi``)."""
    bad = trust == 0
    dev = trust.device
    nan = torch.full((), float("nan"), device=dev)
    nanv = torch.where(bad, nan, torch.zeros((), device=dev))
    return state._replace(
        out_u=torch.where(bad, nan, state.out_u),
        out_v=torch.where(bad, nan, state.out_v),
        ene=torch.where(bad, torch.full((), float("inf"), device=dev), state.ene),
        wu=state.wu + nanv,
        wv=state.wv + nanv,
        out_chi=torch.where(bad, torch.ones((), device=dev), state.out_chi),
    )


def insert_potential(state: GrowState) -> GrowState:
    """insert_potential_candidates + prepare_data_for_growing
    (local_faldoi.cpp:813-870): the surviving flow becomes the new queue and
    every pixel is unfixed; the working flow stays."""
    dev = state.out_u.device
    ok = torch.isfinite(state.out_u) & torch.isfinite(state.out_v)
    zero = torch.zeros((), device=dev)
    return state._replace(
        cand_u=torch.where(ok, state.out_u, zero),
        cand_v=torch.where(ok, state.out_v, zero),
        cand_e=torch.where(ok, state.ene, torch.full((), float("inf"), device=dev)),
        fixed=torch.zeros_like(state.fixed),
        ene=torch.full_like(state.ene, float("inf")),
        out_u=torch.full_like(state.out_u, float("nan")),
        out_v=torch.full_like(state.out_v, float("nan")),
    )


def warm_requeue(state: GrowState, trust, h: int, w: int,
                 band: int) -> GrowState:
    """``_warm_requeue``: trusted pixels farther than ``band`` px from any
    pruned hole stay fixed; trusted pixels inside the band re-queue as
    candidates; pruned pixels lose their flow, poison the working flow and
    are marked occluded (``out_chi``).  The dilation does not wrap at the
    image edge."""
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
        out_chi=torch.where(bad, torch.ones((), device=trust.device),
                            state.out_chi),
    )


def flow_of(state: GrowState, h: int, w: int) -> torch.Tensor:
    n = h * w
    return torch.stack([state.out_u[:n].view(h, w),
                        state.out_v[:n].view(h, w)], dim=-1)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _snapshot_writer(snapshot_dir: str, h: int, w: int):
    """The partial-results hook of JAX's ``match_growing`` (match_growing.py:
    812-829): the first time the forward fixed fraction reaches 30/70/80/95%
    in outer iteration ``marks["it"]``, write the forward flow to
    ``partial_fwd_{pct}_iter_{it}.flo``.  Returns (marks, callback)."""
    os.makedirs(snapshot_dir, exist_ok=True)
    marks = {"it": 0}
    n = h * w

    def cb(state: GrowState):
        frac = float(state.fixed[:n].sum()) / n
        it = marks["it"]
        for pct in SNAPSHOT_PCTS:
            if frac * 100 >= pct and (it, pct) not in marks:
                marks[it, pct] = True
                write_flo(os.path.join(snapshot_dir,
                                       f"partial_fwd_{pct}_iter_{it}.flo"),
                          flow_of(state, h, w).cpu().numpy())

    return marks, cb


def match_growing(go: np.ndarray, ba: np.ndarray, i0n: torch.Tensor,
                  i1n: torch.Tensor, prm: P.Parameters,
                  sal_go: Optional[np.ndarray] = None,
                  sal_ba: Optional[np.ndarray] = None, bsz: int = 4096,
                  seed_bsz: int = 2048, stats=None, warm_band: int = 10,
                  snapshot_dir: Optional[str] = None,
                  i0_planes: Optional[np.ndarray] = None,
                  i1_planes: Optional[np.ndarray] = None,
                  delta: float = 0.05, delta_rel: float = 0.5,
                  floor: Optional[int] = None, floor_scale: int = 64,
                  floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
                  floor_scale_late: Optional[int] = None, block: int = 0,
                  fill: str = "patch", i_1n: Optional[torch.Tensor] = None,
                  i2n: Optional[torch.Tensor] = None):
    """Grow the (h, w, 2) NaN-sparse forward seeds ``go`` and backward seeds
    ``ba`` over the normalized, smoothed frames ``i0n``, ``i1n`` (tensors on
    the run's device) with method ``prm.val_method`` (0 to 8).  Returns
    (flow (h, w, 2), energy (h, w), occlusions (h, w) float32 0/1) of the
    forward direction, as tensors on that device.

    ``i0_planes``, ``i1_planes``: the raw (pd, h, w) colour planes of the two
    frames (0..255), which the NLTV methods (2, 3, 6, 7) need for their
    weights: the forward lane's from I0, the backward lane's from I1.
    ``i_1n``, ``i2n``: method 8's frames I-1 and I2, normalized with I0 and
    I1 (``preprocess.prepare_quad``).

    The throttles, each the counterpart of JAX's argument or environment
    knob of the same meaning: ``warm_band`` (the requeue band in px, 0 = the
    cold requeue; ``FALDOI_GROW_WARM_BAND``), ``delta``, ``delta_rel``,
    ``floor`` (None = 4096), ``floor_scale``, ``floor_scale_hi``,
    ``queue_hi``, ``block``, ``fill`` (see ``local_step.sweep_body``) and
    ``floor_scale_late`` (the requeue and final drains' scale; None =
    ``min(floor_scale, 16)``, ``FALDOI_GROW_FS_LATE``).
    ``snapshot_dir``: where the partial-results snapshots go (the CLIs'
    ``-partial_res``); None = none.
    ``stats`` (a dict, optional) receives the stage seconds and the sweeps
    of every drain."""
    method = prm.val_method
    solver_for(method)
    dev = i0n.device
    h, w = i0n.shape
    n = h * w
    bsz = min(bsz, n)
    wr = prm.w_radio
    p = 2 * wr + 1
    lam, theta, tau = method_local_params(method, wr)
    occ = ({}, {})
    if method == P.M_TVL1_OCC:
        if i_1n is None or i2n is None:
            raise ValueError("method 8 needs 4 frames (i_1n and i2n)")
        occ_prm = (prm.alpha, prm.beta, prm.mu, prm.tau_u, prm.tau_eta,
                   prm.tau_chi)
        occ = (dict(i_1=i_1n, occ_prm=occ_prm), dict(i_1=i2n, occ_prm=occ_prm))
    sc = (make_solver_consts(i0n, i1n, lam, theta, tau, prm.tol_OF, p, method,
                             i0_planes=i0_planes, **occ[0]),
          make_solver_consts(i1n, i0n, lam, theta, tau, prm.tol_OF, p, method,
                             i0_planes=i1_planes, **occ[1]))
    # the occlusion solver's PD cap is iterations_of (tvl2_model_occ.cpp:653)
    max_iters = max(prm.iterations_of if method == P.M_TVL1_OCC
                    else prm.max_iter_patch, 1)
    if floor_scale_late is None:
        floor_scale_late = min(floor_scale, 16)
    throttles = dict(delta=delta, delta_rel=delta_rel,
                     floor=4096 if floor is None else floor,
                     floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
                     block=block, fill=fill)
    exact_fill(fill, method)
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
                                prm.warps, max_iters, seed_bsz=seed_bsz,
                                method=method)
    tick("seed_insertion")
    marks, snapshot = (_snapshot_writer(snapshot_dir, h, w)
                       if snapshot_dir is not None else ({}, None))

    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    trust2d = [ones, ones]

    def run_drain(lane, it, fs):
        marks["it"] = it
        s, k = drain(st[lane], sc[lane], trust2d[lane], sal[lane], it, h, w,
                     wr, bsz, prm.warps, max_iters, fs, method,
                     on_chunk=snapshot if lane == 0 else None, **throttles)
        st[lane] = s
        stats["sweeps"].append({"it": it, "lane": ("fwd", "bwd")[lane],
                                "sweeps": k})

    for it in range(prm.iterations_of):
        fs = floor_scale if it == 0 else floor_scale_late
        for lane in (0, 1):
            run_drain(lane, it, fs)
            tick(f"drain_it{it}_{('fwd', 'bwd')[lane]}")
        tg, tb = prune(i0n, i1n, flow_of(st[0], h, w), flow_of(st[1], h, w),
                       prm.epsilon)
        for lane, tr in enumerate((tg, tb)):
            trust = torch.cat([tr.reshape(-1),
                               torch.ones((1,), dtype=tr.dtype, device=dev)])
            trust2d[lane] = tr     # int32; the state crop converts it
            st[lane] = (warm_requeue(st[lane], trust, h, w, warm_band)
                        if warm_band else
                        insert_potential(delete_untrusted(st[lane], trust)))
        tick(f"prune_requeue_it{it}")

    run_drain(0, prm.iterations_of, floor_scale_late)
    tick("drain_final_fwd")
    return (flow_of(st[0], h, w), st[0].ene[:n].view(h, w),
            st[0].out_chi[:n].view(h, w))

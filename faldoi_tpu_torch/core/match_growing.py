"""Iterated FALDOI local minimization for methods 0-8 (``match_growing``),
and N frame pairs grown together (``match_growing_pairs``).

Port of ``faldoi_tpu/core/match_growing.py`` in the semantics of its CPU
default, ``mode="fused"`` (``_iterated_growing``, local_faldoi.cpp:
1060-1741): per outer iteration a forward drain and a backward drain, FB
pruning, and a requeue; then a final forward-only drain.  The requeue is the
warm one with band 10 by default; ``warm_band=0`` gives the cold requeue, the
reference's full re-grow of every outer iteration (``_delete_untrusted`` +
``_insert_potential``, local_faldoi.cpp:283-311, 813-870).  The floor scale
is ``floor_scale`` (64) in iteration 0 and ``floor_scale_late`` (by default
``min(floor_scale, 16)``) after.  The throttles and the ordering modes
(relax, relax_late, exactmin, defer, polish, the dense fill, the bilateral
pre-fill) are arguments here, where JAX also reads them from its
``FALDOI_GROW_*`` environment; the port reads no environment, and applies
relax_late and polish on every path in the order of JAX's chunked loop
(JAX's fused path ignores them).

The growing runs in lanes: N pairs are 2N lanes [fwd0..fwdN-1,
bwd0..bwdN-1] (``match_growing`` is N = 1), and for methods 0-7 they drain
in lockstep, as JAX's ``grow_pair`` drains them: one lane-batched sweep
(``local_step.sweep_lanes``) serves every lane that still accepts, so the
fixed cost of a sweep is paid once for all of them.  Lanes share no pixel
and a drained lane's sweep changes nothing, so each lane's states are those
of its own one-lane drain.  FB pruning and the requeue run per pair.

Method 8 (TV-L1 with occlusions) grows over four frames: the forward lane
warps I1 at +u and I-1 at -u with g from I0's gradient, the backward lane
I0 at +u and I2 at -u with g from I1's (JAX's match_growing.py:662-690), and
its patch PD cap is ``prm.iterations_of``, not ``max_iter_patch``
(:702-705).  Its lanes drain one after the other: its patch solver (K9's
patch form) takes no lane index.

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
from faldoi_tpu_torch.core.functionals import (
    make_solver_consts, solver_for, stack_solver_consts,
)
from faldoi_tpu_torch.core.bilateral import (
    bilateral_colour_planes, bilateral_filter_flow,
)
from faldoi_tpu_torch.core.local_step import (
    GrowState, drain, drain_lanes, exact_fill, init_state, insert_seeds,
    lane_state, polish_lanes, stack_states,
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
                  i2n: Optional[torch.Tensor] = None, relax: bool = False,
                  relax_late: bool = False, exactmin: int = 0,
                  exactmin_band: str = "0", defer: float = 0.0,
                  defer_win: int = 0, polish: int = 0,
                  bilateral: bool = False):
    """Grow the (h, w, 2) NaN-sparse forward seeds ``go`` and backward seeds
    ``ba`` over the normalized, smoothed frames ``i0n``, ``i1n`` (tensors on
    the run's device) with method ``prm.val_method`` (0 to 8).  Returns
    (flow (h, w, 2), energy (h, w), occlusions (h, w) float32 0/1) of the
    forward direction, as tensors on that device.

    Methods 0-7 run as ``match_growing_pairs`` with one pair: the forward
    and the backward lane drain together, one batch a sweep.  Method 8
    drains them one after the other (its patch solver, K9, takes no lane
    index); the results are the same either way.

    ``i0_planes``, ``i1_planes``: the raw (pd, h, w) colour planes of the two
    frames (0..255), which the NLTV methods (2, 3, 6, 7) need for their
    weights: the forward lane's from I0, the backward lane's from I1.
    ``i_1n``, ``i2n``: method 8's frames I-1 and I2, normalized with I0 and
    I1 (``preprocess.prepare_quad``).

    The throttles, each the counterpart of JAX's argument or environment
    knob of the same meaning: ``warm_band`` (the requeue band in px, 0 = the
    cold requeue; ``FALDOI_GROW_WARM_BAND``), ``delta``, ``delta_rel``,
    ``floor`` (None = 4096), ``floor_scale``, ``floor_scale_hi``,
    ``queue_hi``, ``block``, ``fill`` (see ``local_step.sweep_lanes``) and
    ``floor_scale_late`` (the requeue and final drains' scale; None =
    ``min(floor_scale, 16)``, ``FALDOI_GROW_FS_LATE``).  ``fill`` also takes
    "dense": one whole-image nearest fill (K10) a sweep.
    The ordering modes (JAX's arguments and ``FALDOI_GROW_*`` knobs):
    ``relax`` (label-correcting drains; ``floor`` then defaults to bsz),
    ``relax_late`` (relax in the drains of iterations >= 1 and the final
    one; ``FALDOI_GROW_RELAX_LATE``), ``exactmin``, ``exactmin_band``,
    ``defer``, ``defer_win`` (``FALDOI_GROW_EXACTMIN[_BAND]``,
    ``FALDOI_GROW_DEFER[_WIN]``; see ``local_step.sweep_lanes``), ``polish``
    (``polish_lanes`` passes after the drains of iterations >= 1 and after
    the final drain; ``FALDOI_GROW_POLISH``) and ``bilateral`` (the
    bilateral pre-fill of the untrusted working flow after each prune and
    requeue, K11, both lanes weighted by I0 as JAX weights them).  The
    order per outer iteration is JAX's chunked loop (match_growing.py:
    857-903): drains, polish, prune and requeue, bilateral.
    ``snapshot_dir``: where the partial-results snapshots go (the CLIs'
    ``-partial_res``); None = none.
    ``stats`` (a dict, optional) receives the stage seconds and the sweeps
    of every lane's drains."""
    occ = None
    if prm.val_method == P.M_TVL1_OCC:
        if i_1n is None or i2n is None:
            raise ValueError("method 8 needs 4 frames (i_1n and i2n)")
        occ = [(i_1n, i2n)]
    return _grow([(go, ba)], [(i0n, i1n)], prm, bsz, seed_bsz, stats,
                 warm_band, snapshot_dir, [(i0_planes, i1_planes)],
                 [(sal_go, sal_ba)], occ, floor_scale, floor_scale_late,
                 dict(delta=delta, delta_rel=delta_rel, floor=floor,
                      floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
                      block=block, fill=fill, relax=relax, exactmin=exactmin,
                      exactmin_band=exactmin_band, defer=defer,
                      defer_win=defer_win),
                 relax_late, polish, bilateral)[0]


def match_growing_pairs(seeds_pairs, frames_pairs, prm: P.Parameters,
                        bsz: int = 8192, stats=None, warm_band: int = 10,
                        planes_pairs=None, sal_pairs=None,
                        delta: float = 0.05, delta_rel: float = 0.5,
                        floor: Optional[int] = None, floor_scale: int = 64,
                        floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
                        floor_scale_late: Optional[int] = None,
                        block: int = 0, fill: str = "patch",
                        relax: bool = False, relax_late: bool = False,
                        exactmin: int = 0, exactmin_band: str = "0",
                        defer: float = 0.0, defer_win: int = 0,
                        polish: int = 0, bilateral: bool = False):
    """Grow N frame pairs together (JAX's ``match_growing_pairs``, the
    throughput mode): the 2N lanes [fwd0..fwdN-1, bwd0..bwdN-1] drain as one
    lane-batched sweep (``local_step.drain_lanes``: one selection, one patch
    batch and one set of scatters a sweep for all of them) in every outer
    iteration; FB pruning and the warm or cold requeue run per pair; a final
    forward-only drain runs over the first N lanes.  Lanes share no pixel,
    so each pair's result is that of its own ``match_growing``, bit for bit.

    ``seeds_pairs``: N (go, ba) NaN-sparse (h, w, 2) seed fields;
    ``frames_pairs``: N (i0n, i1n) normalized, smoothed frames of one shape,
    on the run's device.  ``planes_pairs``: N (i0_planes, i1_planes) raw
    colour planes (the NLTV methods 2, 3, 6, 7); ``sal_pairs``: N (sal_go,
    sal_ba) saliency maps or None.  The throttles and the ordering modes are
    ``match_growing``'s, each applied to every lane alone (JAX's pairs mode
    takes ``relax`` and ``relax_late`` and ignores ``block``,
    ``floor_scale_hi``, ``queue_hi``, ``polish`` and ``bilateral``; the port
    takes them all).  Defaults are JAX's: bsz 8192, floor 4096 (bsz under
    ``relax``), the ``fill`` resolution of ``local_step.exact_fill``.
    Methods 0-7; method 8 (whose patch solver takes no lane index) raises.

    Returns a list of (flow (h, w, 2), energy (h, w), occlusions (h, w)),
    one a pair.  ``stats`` receives the stage seconds and every lane's
    sweeps (entries with "it", "lane" fwd/bwd, "pair", "sweeps")."""
    if prm.val_method == P.M_TVL1_OCC:
        raise ValueError("pairs mode takes methods 0-7; run method 8 per pair "
                         "(match_growing)")
    npairs = len(seeds_pairs)
    if npairs < 1 or len(frames_pairs) != npairs:
        raise ValueError(f"{npairs} seed pairs and {len(frames_pairs)} frame "
                         "pairs: expected N >= 1 of each")
    for name, opt in (("planes_pairs", planes_pairs), ("sal_pairs", sal_pairs)):
        if opt is not None and len(opt) != npairs:
            raise ValueError(f"{name}: {len(opt)} entries for {npairs} pairs")
    return _grow(seeds_pairs, frames_pairs, prm, bsz, 2048, stats, warm_band,
                 None, planes_pairs or [(None, None)] * npairs,
                 sal_pairs or [(None, None)] * npairs, None, floor_scale,
                 floor_scale_late,
                 dict(delta=delta, delta_rel=delta_rel, floor=floor,
                      floor_scale_hi=floor_scale_hi, queue_hi=queue_hi,
                      block=block, fill=fill, relax=relax, exactmin=exactmin,
                      exactmin_band=exactmin_band, defer=defer,
                      defer_win=defer_win),
                 relax_late, polish, bilateral)


def _grow(seeds_pairs, frames_pairs, prm, bsz, seed_bsz, stats, warm_band,
          snapshot_dir, planes_pairs, sal_pairs, occ_pairs, floor_scale,
          floor_scale_late, throttles, relax_late=False, polish=0,
          bilateral=False):
    """The iterated growing of N pairs as 2N lanes [fwd0..fwdN-1,
    bwd0..bwdN-1] (``match_growing`` is N = 1).  Methods 0-7 drain the lanes
    in lockstep (``drain_lanes`` on lane-stacked consts); method 8
    (``occ_pairs``: N (i_1n, i2n)) drains them one lane after the other.
    Per outer iteration: the drains (relax also from iteration 1 on under
    ``relax_late``), ``polish`` passes from iteration 1 on, prune and
    requeue, the bilateral pre-fill; then the final forward drain and its
    polish.  ``stats["sweeps"]`` entries name their pair where N > 1."""
    method = prm.val_method
    solver_for(method)
    npairs = len(seeds_pairs)
    nlanes = 2 * npairs
    i0n = frames_pairs[0][0]
    dev = i0n.device
    h, w = i0n.shape
    for a, b in frames_pairs:
        if a.shape != (h, w) or b.shape != (h, w):
            raise ValueError("the pairs must share one frame shape")
    n = h * w
    bsz = min(bsz, n)
    wr = prm.w_radio
    p = 2 * wr + 1
    lam, theta, tau = method_local_params(method, wr)
    occ = [({}, {})] * npairs
    if method == P.M_TVL1_OCC:
        occ_prm = (prm.alpha, prm.beta, prm.mu, prm.tau_u, prm.tau_eta,
                   prm.tau_chi)
        occ = [(dict(i_1=a, occ_prm=occ_prm), dict(i_1=b, occ_prm=occ_prm))
               for a, b in occ_pairs]
    # lane l < N: pair l forward (I0 -> I1); lane N + l: its backward
    scs = ([make_solver_consts(a, b, lam, theta, tau, prm.tol_OF, p, method,
                               i0_planes=pl[0], **oc[0])
            for (a, b), pl, oc in zip(frames_pairs, planes_pairs, occ)]
           + [make_solver_consts(b, a, lam, theta, tau, prm.tol_OF, p, method,
                                 i0_planes=pl[1], **oc[1])
              for (a, b), pl, oc in zip(frames_pairs, planes_pairs, occ)])
    lockstep = method != P.M_TVL1_OCC
    sc_lanes = stack_solver_consts(scs) if lockstep else None
    # the occlusion solver's PD cap is iterations_of (tvl2_model_occ.cpp:653)
    max_iters = max(prm.iterations_of if method == P.M_TVL1_OCC
                    else prm.max_iter_patch, 1)
    if floor_scale_late is None:
        floor_scale_late = min(floor_scale, 16)
    throttles = dict(throttles)
    if throttles["floor"] is None:
        # relax mode accepts the whole top-k batch (LocalSolver's default)
        throttles["floor"] = bsz if throttles["relax"] else 4096
    exact_fill(throttles["fill"], method)
    relax = throttles.pop("relax")
    stats = {} if stats is None else stats
    stats.setdefault("sweeps", [])
    stats.setdefault("seconds", {})

    def mksal(s):
        base = np.ones(n + 1, np.float32)
        if s is not None:
            base[:n] = np.asarray(s, np.float32).ravel()
        return torch.as_tensor(base, device=dev)

    sal = torch.stack([mksal(s[0]) for s in sal_pairs]
                      + [mksal(s[1]) for s in sal_pairs])
    t = time.perf_counter()

    def tick(label):
        nonlocal t
        _sync(dev)
        now = time.perf_counter()
        stats["seconds"][label] = now - t
        t = now

    seeds = [s[0] for s in seeds_pairs] + [s[1] for s in seeds_pairs]
    sts = [insert_seeds(init_state(h, w, dev), seeds[lane], scs[lane],
                        sal[lane], prm.warps, max_iters, seed_bsz=seed_bsz,
                        method=method) for lane in range(nlanes)]
    tick("seed_insertion")
    marks, snapshot = (_snapshot_writer(snapshot_dir, h, w)
                       if snapshot_dir is not None else ({}, None))
    trust2d = torch.ones((nlanes, h, w), dtype=torch.float32, device=dev)

    def record(it, lane, k):
        entry = {"it": it, "lane": ("fwd", "bwd")[lane >= npairs]}
        if npairs > 1:
            entry["pair"] = lane % npairs
        entry["sweeps"] = k
        stats["sweeps"].append(entry)

    def run_drains(it, fs, lanes):
        nonlocal sts
        marks["it"] = it
        label = "drain_final" if it == prm.iterations_of else f"drain_it{it}"
        kw = dict(on_chunk=snapshot, relax=relax or (relax_late and it >= 1),
                  **throttles)
        if lockstep:
            st, ks = drain_lanes(stack_states(sts), sc_lanes, trust2d, sal, it,
                                 h, w, wr, bsz, prm.warps, max_iters, fs,
                                 method, lanes=lanes, **kw)
            sts = [lane_state(st, lane) for lane in range(nlanes)]
            for lane, k in zip(lanes, ks):
                record(it, lane, k)
            tick("drain_final_fwd" if lanes == list(range(npairs)) else label)
            return
        for lane in lanes:
            kw["on_chunk"] = snapshot if lane == 0 else None
            sts[lane], k = drain(sts[lane], scs[lane], trust2d[lane],
                                 sal[lane], it, h, w, wr, bsz, prm.warps,
                                 max_iters, fs, method, **kw)
            record(it, lane, k)
            tick(f"{label}_{('fwd', 'bwd')[lane >= npairs]}")

    def run_polish(lanes, label):
        nonlocal sts
        if not polish:
            return
        for _ in range(polish):
            if lockstep:
                st = polish_lanes(stack_states(sts), sc_lanes, sal, h, w, wr,
                                  bsz, prm.warps, max_iters, method, lanes)
                sts = [lane_state(st, lane) for lane in range(nlanes)]
                continue
            for lane in lanes:
                st = polish_lanes(stack_states([sts[lane]]), scs[lane],
                                  sal[lane:lane + 1], h, w, wr, bsz, prm.warps,
                                  max_iters, method)
                sts[lane] = lane_state(st, 0)
        tick(label)

    bcolour = ([bilateral_colour_planes(a) for a, _ in frames_pairs]
               if bilateral else None)

    def run_bilateral(k, tg, tb):
        """JAX's ``_bfill`` of pair k's two lanes: the NaN-free working
        flow filtered where the new trust is 0, both weighted by I0."""
        fwd, bwd = k, npairs + k
        wu = torch.stack([torch.nan_to_num(sts[ln].wu[:n]).view(h, w)
                          for ln in (fwd, bwd)])
        wv = torch.stack([torch.nan_to_num(sts[ln].wv[:n]).view(h, w)
                          for ln in (fwd, bwd)])
        tr = torch.stack([tg, tb])
        bu, bv = bilateral_filter_flow(frames_pairs[k][0], wu, wv, tr,
                                       torch.zeros_like(tr),
                                       colour=bcolour[k])
        for m, ln in enumerate((fwd, bwd)):
            sts[ln] = sts[ln]._replace(
                wu=torch.cat([bu[m].reshape(-1), sts[ln].wu[n:]]),
                wv=torch.cat([bv[m].reshape(-1), sts[ln].wv[n:]]))

    for it in range(prm.iterations_of):
        fs = floor_scale if it == 0 else floor_scale_late
        run_drains(it, fs, list(range(nlanes)))
        if it >= 1:
            run_polish(list(range(nlanes)), f"polish_it{it}")
        trusts = [None] * nlanes
        for k, (a, b) in enumerate(frames_pairs):
            fwd, bwd = k, npairs + k
            tg, tb = prune(a, b, flow_of(sts[fwd], h, w),
                           flow_of(sts[bwd], h, w), prm.epsilon)
            for lane, tr in ((fwd, tg), (bwd, tb)):
                trust = torch.cat([tr.reshape(-1),
                                   torch.ones((1,), dtype=tr.dtype, device=dev)])
                trusts[lane] = tr     # int32; the state crop converts it
                sts[lane] = (warm_requeue(sts[lane], trust, h, w, warm_band)
                             if warm_band else
                             insert_potential(delete_untrusted(sts[lane], trust)))
            if bilateral:
                run_bilateral(k, tg, tb)
        trust2d = torch.stack(trusts)
        tick(f"prune_requeue_it{it}")

    run_drains(prm.iterations_of, floor_scale_late, list(range(npairs)))
    run_polish(list(range(npairs)), "polish_final")
    return [(flow_of(st, h, w), st.ene[:n].view(h, w),
             st.out_chi[:n].view(h, w)) for st in sts[:npairs]]

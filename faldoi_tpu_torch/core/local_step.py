"""Local step — energy-guided seed growing as batched best-first sweeps.

Port of ``faldoi_tpu/core/local_step.py`` (the CPU ``mode="fused"``
semantics that ``match_growing`` runs by default; by default in its strict
mode, with JAX's ordering modes as arguments of ``sweep_lanes``): per sweep
the ``bsz`` lowest-energy unfixed candidates are selected, those inside the
delta band or under the queue-adaptive rank floor are fixed, their 11x11
patches are cropped (K0's planes form, ``gather_plane_patches``: one launch,
counted in ``gather_plane_patches.launches``, returning the five state
canvases as contiguous (k, p, p) blocks), Poisson-filled (K13,
``poisson_fill_planes``: the u and v canvases in one launch), solved (the
method's patch solver: K12 for methods 0 and 1, one launch a solve) and the
results are scattered: min-energy wins for the 4-neighbour candidates and
the donations to pixels accepted in the same sweep, the centre update when
its energy improves, and max-energy wins for the persistent working flow
over the whole patch.

State layout: flat (h*w+1,) planes; the extra slot is the dump for masked
writes, as in JAX.  Lanes: the growing lanes of one or more frame pairs
(each pair's forward and backward direction) sweep as one batch
(``sweep_lanes``, ``drain_lanes``): their planes stack to (L, h*w+1), each
lane keeps its own dump slot, and one selection, one state crop, one patch
batch and one set of scatters serve every lane; ``sweep_body`` and
``drain`` are the one-lane case.  The occlusion planes ``out_chi``, ``cand_chi`` and
``wchi`` flow through the sweeps only for method 8 (``with_chi``): the fix
takes the candidate's chi, the state crop takes seven planes, the chi init
is ``out_chi`` at fixed pixels and the working chi elsewhere (0 where it is
not finite, and outside the box), and chi rides as a payload on every
scatter.  For methods 0-7 no sweep reads or writes them.

The selection is K2 (``ops/select.py``) and the payload scatters K3
(``ops/scatter.py``).  Ties, which JAX leaves to the backend: candidate
selection orders the keys as ``lax.top_k`` does on the CPU (their IEEE
total order, equal keys by the lower flat index), and a payload scatter
whose winners tie on the key keeps the LAST update in JAX's flattening
order (what XLA's sequential CPU scatter does), on every device.

Selection is exact.  JAX solves all ``bsz`` candidates of a sweep and
masks the rest; the drains of methods 0 and 1 under the patch fills do the
same (``sweep_static``: a fixed batch, nothing read back a sweep), while
``sweep_lanes`` solves only the accepted candidates, in the order of the
selected batch (a prefix of it unless block-local bands are on), sized by
one host read.  The masked candidates write nothing, so the results are
the same.

The throttles of the acceptance are ``sweep_lanes``' arguments, with JAX's
``match_growing`` defaults: the delta band ``e_min + max(delta, delta_rel *
e_min)``, optionally also per (block x block) tile; the rank floor
``min(floor, queue // fscale)``, where the divisor is ``floor_scale_hi`` once
the queue holds ``queue_hi`` candidates (if ``floor_scale_hi`` > 0) and
``floor_scale`` before; and the patch fill, exact raster Gauss-Seidel or
red-black, or the dense whole-image fill (``fill``).  The ordering modes
(label-correcting ``relax``, the window-min acceptance ``exactmin``, the
contested-accept deferral ``defer``) act on each lane alone; a re-polish
pass over the fixed pixels is ``polish_lanes``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.functionals import (
    CSAD_METHODS, SolverConsts, solver_for,
)
from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches
from faldoi_tpu_torch.ops.poisson import nearest_fill_image, poisson_fill_planes
# scatter_max_payload is the sweep's public scatter beside the min one
from faldoi_tpu_torch.ops.scatter import (  # noqa: F401
    scatter_max_payload, scatter_min_payload, wflow_scatter,
)
from faldoi_tpu_torch.ops.select import (
    RELAX_MARGIN, accept, band_floor_plain, keys_plain, select,
)
from faldoi_tpu_torch.ops.stencils import canvas_ids

INF = float("inf")
NAN = float("nan")
# the fills ``sweep_body`` takes; "patch" resolves per method
FILLS = ("patch", "patch_exact", "patch_rb", "dense")
# the bands of the exact window-min acceptance (``exactmin``): "0" none, "1"
# the global delta band, "2" the band or the rank floor
EXACTMIN_BANDS = ("0", "1", "2")
# 4-neighbour order of insert_candidates (and of JAX's concatenation)
NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0))
# the methods whose drains sweep with a fixed batch and no host read a
# sweep (``sweep_static``, ``drain_lanes``): K12's TV-L1 solves
STATIC_METHODS = (P.M_TVL1, P.M_TVL1_W)


class GrowState(NamedTuple):
    fixed: torch.Tensor   # (N+1,) bool
    out_u: torch.Tensor   # (N+1,) fixed flow (NaN where unfixed)
    out_v: torch.Tensor
    ene: torch.Tensor     # (N+1,) energy at fixed pixels
    cand_u: torch.Tensor  # (N+1,) best queued candidate
    cand_v: torch.Tensor
    cand_e: torch.Tensor  # inf = no candidate
    wu: torch.Tensor      # (N+1,) persistent working flow
    wv: torch.Tensor
    out_chi: torch.Tensor  # (N+1,) occlusion output (method 8; the pruned
    cand_chi: torch.Tensor  # pixels of the requeues for every method)
    wchi: torch.Tensor


def init_state(h: int, w: int, device) -> GrowState:
    n = h * w + 1
    dev = torch.device(device)

    def full(v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return GrowState(
        fixed=torch.zeros((n,), dtype=torch.bool, device=dev),
        out_u=full(NAN), out_v=full(NAN), ene=full(INF),
        cand_u=full(0.0), cand_v=full(0.0), cand_e=full(INF),
        wu=full(NAN), wv=full(NAN),
        out_chi=full(0.0), cand_chi=full(0.0), wchi=full(0.0),
    )


def state_from_numpy(st, device) -> GrowState:
    """Carry a JAX ``GrowState`` (any object with its field names, or a
    mapping) into the port, the method-8 chi planes included."""
    get = st.get if isinstance(st, dict) else (lambda k: getattr(st, k))
    dev = torch.device(device)
    out = {}
    for k in GrowState._fields:
        a = np.asarray(get(k))
        out[k] = torch.as_tensor(a if k == "fixed" else a.astype(np.float32),
                                 device=dev).clone()
    return GrowState(**out)


def state_to_numpy(st: GrowState) -> dict:
    return {k: getattr(st, k).detach().cpu().numpy() for k in GrowState._fields}


def patch_geometry(idx, h, w, wr, ymin=0, ymax=None):
    """get_index_patch (utils.cpp:36-54) for flat indices:
    (i, j, oy, ox, ph, pw).  ``ymin``, ``ymax`` (default 0, h) clamp the box
    vertically: a row shard of the sharded growing passes the true image
    border in its extended domain's rows, so that its inner edges do not
    clamp."""
    if ymax is None:
        ymax = h
    i = idx % w
    j = idx // w
    oy = (j - wr).clamp(min=ymin)
    ox = (i - wr).clamp(min=0)
    ph = (j + 1 + wr).clamp(max=ymax) - oy
    pw = (i + 1 + wr).clamp(max=w) - ox
    return i, j, oy, ox, ph, pw


def _chi_payload(tgt_c, c):
    """The chi payload's keyword arguments of a scatter (none where c is
    None: methods 0-7)."""
    return {} if c is None else dict(tgt_c=tgt_c, c=c)


def _solve(solver, sc, i, j, oy, ox, ph, pw, u0, v0, p, warps, max_iters,
           chi, lane=None):
    """The method's patch solve: (u, v, chi, ener).  ``chi`` is method 8's
    init canvases and None for methods 0-7, whose solvers take and return
    no chi.  ``lane``: None, or the patches' lane index into lane-stacked
    consts."""
    if chi is None:
        su, sv, ener = solver(sc, i, j, oy, ox, ph, pw, u0, v0, p, warps,
                              max_iters, lane=lane)
        return su, sv, None, ener
    return solver(sc, i, j, oy, ox, ph, pw, u0, v0, p, warps, max_iters,
                  chi=chi, lane=lane)


def _neighbour_candidates(su, sv, ener, i, j, oy, ox, sal, h, w, p, schi=None,
                          base=None, ymin=0, ymax=None):
    """The 4-neighbour candidates of B solved patches, concatenated in
    ``NEIGHBOURS`` order: (q, in_image, energy, u, v, chi or None).  q is the
    flat slot ``base + qj * w + qi`` (``base``: each patch's lane times
    h*w + 1, None for one lane), the lane's dump slot ``base + h*w`` where
    the neighbour leaves the rows [ymin, ymax) (default [0, h)) or the
    columns; (u, v) and chi (given ``schi``) come from the patch cell next
    to the centre."""
    if ymax is None:
        ymax = h
    cy, cx = j - oy, i - ox
    bidx = torch.arange(i.shape[0], device=i.device)
    qs, inbs, nus, nvs, ncs = [], [], [], [], []
    for dx, dy in NEIGHBOURS:
        qi, qj = i + dx, j + dy
        inb = (qi >= 0) & (qi < w) & (qj >= ymin) & (qj < ymax)
        q = torch.where(inb, qj * w + qi, torch.full_like(qi, h * w))
        qs.append(q if base is None else base + q)
        inbs.append(inb)
        r = (cy + dy).clamp(0, p - 1)
        c = (cx + dx).clamp(0, p - 1)
        nus.append(su[bidx, r, c])
        nvs.append(sv[bidx, r, c])
        if schi is not None:
            ncs.append(schi[bidx, r, c])
    q = torch.cat(qs)
    return (q, torch.cat(inbs), ener.repeat(len(NEIGHBOURS)) * sal[q],
            torch.cat(nus), torch.cat(nvs),
            torch.cat(ncs) if schi is not None else None)


def exact_fill(fill: str, method: int) -> bool:
    """Whether ``fill`` means the exact raster Gauss-Seidel fill for
    ``method`` (JAX's resolution, match_growing.py:628-637): "patch" is the
    exact fill for the inert-TV CSAD family (methods 4-7), which passes the
    Poisson init through to its output, and red-black for every other
    method; "patch_exact" and "patch_rb" force one or the other; "dense"
    (one whole-image nearest fill a sweep, K10) is neither."""
    if fill not in FILLS:
        raise ValueError(f"fill {fill!r}: expected one of {FILLS}")
    return fill == "patch_exact" or (fill == "patch" and method in CSAD_METHODS)


def _window_reduce(x, k: int, op: str):
    """Min or max of (L, h, w) over the k x k window around each cell, rows
    then columns, with XLA's "SAME" padding: (k - 1) // 2 cells before and
    the rest after, filled with the reduction's identity (+-inf), so an even
    window leans one cell towards the end."""
    lo, hi = (k - 1) // 2, k - 1 - (k - 1) // 2
    y = -x if op == "min" else x
    y = torch.nn.functional.pad(y[:, None], (lo, hi, lo, hi), value=-INF)
    y = torch.nn.functional.max_pool2d(y, (1, k), stride=1)
    y = torch.nn.functional.max_pool2d(y, (k, 1), stride=1)[:, 0]
    return -y if op == "min" else y


def _contested(valid, idx, e_pop, pop_u, pop_v, h, w, defer, win):
    """JAX's contested-accept deferral: scatter the tentative accepts' key
    and flow to per-lane grids, reduce them over ``win`` x ``win`` windows,
    and flag the accepts whose window holds a strictly lower key (by more
    than 1e-6) while the window's accepted flows spread by more than
    ``defer`` px in u or v.  (L, bsz) in, (L, bsz) bool out."""
    nl = valid.shape[0]

    def grid(vals, fill):
        g = torch.full((nl, h * w), fill, dtype=torch.float32, device=idx.device)
        return g.scatter(1, idx, torch.where(valid, vals, torch.full_like(vals, fill)))

    def red(vals, fill, op):
        return _window_reduce(grid(vals, fill).view(nl, h, w), win, op).view(nl, -1)

    wmin_e = red(e_pop, INF, "min")
    spread = ((red(pop_u, -INF, "max") - red(pop_u, INF, "min") > defer)
              | (red(pop_v, -INF, "max") - red(pop_v, INF, "min") > defer))
    cont = (spread & torch.isfinite(wmin_e)).gather(1, idx)
    return cont & (wmin_e.gather(1, idx) < e_pop - 1e-6)


def _block_band(eligible, h, w, block, delta, delta_rel):
    """Per lane and pixel, whether its energy lies in the delta band of its
    (block x block) tile, anchored at the tile's minimum eligible energy;
    ``eligible`` (L, h*w) -> (L, h*w)."""
    nl = eligible.shape[0]
    by, bx = -(-h // block), -(-w // block)
    e2d = torch.nn.functional.pad(eligible.view(nl, h, w),
                                  (0, bx * block - w, 0, by * block - h),
                                  value=INF)
    bmin = e2d.view(nl, by, block, bx, block).amin(dim=(2, 4))
    bmin_f = bmin.repeat_interleave(block, 1).repeat_interleave(block, 2)[
        :, :h, :w]
    bband = bmin_f + torch.clamp(delta_rel * bmin_f, min=delta)
    return eligible <= bband.reshape(nl, -1)


def _dense_fill(fixed, out_u, out_v, nl, rows, h, w):
    """JAX's ``_dense_fill`` of u and v for the swept lanes ``rows``: the
    fixed flow (NaN elsewhere) filled by one K10 launch
    (``nearest_fill_image``) -> (L, 2, h, w), zeros in lanes that do not
    sweep.  ``fixed``, ``out_u``, ``out_v``: the flat (L * (N+1),) planes
    after this sweep's fix."""
    n = h * w
    stride = n + 1
    fx = fixed.view(nl, stride)[rows, :n]
    nan = torch.full((), NAN, device=fixed.device)
    x = torch.stack([torch.where(fx, pl.view(nl, stride)[rows, :n], nan)
                     for pl in (out_u, out_v)], 1).view(-1, 2, h, w)
    filled = nearest_fill_image(x)
    if filled.shape[0] == nl:
        return filled
    out = torch.zeros((nl, 2, h, w), device=fixed.device)
    out[rows] = filled
    return out


def lane_state(state: GrowState, lane: int) -> GrowState:
    """Lane ``lane`` of a lane-stacked state, as views."""
    return GrowState(*(t[lane] for t in state))


def stack_states(states) -> GrowState:
    """One-lane states stacked into one state with (L, N+1) planes."""
    return GrowState(*(torch.stack(ts) for ts in zip(*states)))


def _lane_rows(nl: int, lanes, dev):
    """The index of the swept lanes into the planes' lane axis (a full
    slice where every lane sweeps in order)."""
    rows_l = list(range(nl)) if lanes is None else list(lanes)
    return (slice(None) if rows_l == list(range(nl))
            else torch.as_tensor(rows_l, dtype=torch.int64, device=dev))


def eligibility(state: GrowState, n: int, relax: bool = False, lanes=None,
                owned=None):
    """The sort key of the sweep's selection, (L', n) for the lanes
    ``lanes`` (None: all): a pixel's candidate energy while it is unfixed,
    +inf where it cannot be popped.  Under ``relax`` a pixel is eligible
    while its candidate beats its energy (cand_e < ene * ``RELAX_MARGIN`` -
    1e-6), and a fixed pixel's key is cand_e + ``RECLAIM_BIAS``.  ``owned``
    ((n,) bool, optional): +inf outside a row shard's own rows.  (K2 forms
    the same keys itself; the ordering modes and the sharded growing's band
    anchor read them here.)"""
    rows = _lane_rows(state.fixed.shape[0], lanes, state.cand_e.device)
    return keys_plain(state.cand_e, state.fixed, state.ene, n, relax, rows,
                      owned)


def sweep_lanes(state: GrowState, sconsts: SolverConsts, trust2d, sal,
                iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
                max_iters: int, floor_scale: int, method: int = P.M_TVL1,
                delta: float = 0.05, delta_rel: float = 0.5, floor: int = 4096,
                floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
                block: int = 0, fill: str = "patch", relax: bool = False,
                exactmin: int = 0, exactmin_band: str = "0",
                defer: float = 0.0, defer_win: int = 0, lanes=None,
                owned=None, ybounds=None, row_offset: int = 0,
                band_min=None, with_wkey: bool = False, *, _static=False):
    """One wavefront sweep of L independent growing lanes as one batch
    (``_sweep_body`` with the exact working-flow scatter of radius wr for
    every lane), solving with ``method``'s patch solver.

    ``state``: (L, N+1) planes; ``trust2d`` (L, h, w); ``sal`` (L, N+1);
    ``sconsts``: the lanes' consts stacked by ``stack_solver_consts``, or
    for L = 1 one lane's plain consts (then the kernels take no lane index).
    ``lanes``: the lanes that sweep (None: all); the others are carried
    untouched.  The throttles default to ``match_growing``'s values:
    ``delta``, ``delta_rel`` (the band), ``floor``, ``floor_scale``,
    ``floor_scale_hi``, ``queue_hi`` (the rank floor), ``block`` (0: no
    block-local bands) and ``fill`` (see ``exact_fill``; "dense": the patch
    inits come from one whole-image nearest fill of the fixed flow a sweep,
    K10, cropped with the state); they act on each lane alone.  The
    ordering dials, also per lane, are JAX's (``_sweep_body``,
    ``ordering_dials``):

    * ``relax``: label-correcting relaxation.  A pixel is eligible while its
      candidate beats its energy, cand_e < ene * ``RELAX_MARGIN`` - 1e-6, so
      a fixed pixel is popped again by a lower claim; a fixed pixel's key is
      cand_e + ``RECLAIM_BIAS`` (float32), which the top-k, the band anchor
      and the deferral use, while the fix takes the unbiased cand_e.  The
      neighbour candidates go to any pixel whose candidate and energy they
      beat the same way.  A re-popped pixel gets no donation.
    * ``exactmin`` (px, 0 = off): only the candidates that hold the minimum
      key of their exactmin x exactmin window are accepted, in place of the
      band and the floor; ``exactmin_band`` "1" adds the delta band, "2" the
      band or the rank floor.
    * ``defer`` (px, 0 = off): accepts whose ``defer_win`` window (0: p)
      holds a strictly lower accepted key while the window's accepted flows
      spread by more than ``defer`` are dropped (``_contested``).

    Selection is per lane (K2, ``ops/select.py``): the top min(bsz, h*w)
    keys of each lane in ``lax.top_k``'s order (the keys' IEEE total order,
    ties to the lower flat index within the lane), and each lane its own
    e_min and band, queue and rank floor, and block-local band.  The
    accepted candidates of all lanes are flattened lane-major into one
    batch that gets one state crop (K0's planes form), one fill, one solve
    and one set of scatters (K3, ``ops/scatter.py``).  A pixel's slot is
    flat at ``lane * (N+1) + q``, each lane's dump slot at ``lane * (N+1) +
    N``.  Ties of the payload scatters keep, within a lane, the order of a
    one-lane sweep: positions d*K+b (neighbour candidates) and (r*p+c)*K+b
    (working flow) with b lane-major, so a lane's winners keep their
    relative order, and slots of different lanes never collide.  Each
    lane's result is therefore that of its own one-lane sweep, bit for bit.

    The hooks of a row shard of the sharded growing
    (``parallel.spatial_grow``), which sweeps an extended domain of h rows:
    its own rows and a halo from each row neighbour.  All are off by
    default, and then change nothing:

    * ``owned`` ((h*w,) bool): only these pixels are eligible;
    * ``ybounds`` ((ymin, ymax), default (0, h)): the rows where patch boxes
      and the 4-neighbour candidates clamp, the true image border;
    * ``row_offset``: added to the rows of the patch solver's reads, which
      take the whole image (the state crop and the scatters keep the
      domain's own rows);
    * ``band_min`` ((L', 1) tensor): the delta band's anchor in place of
      each lane's minimum key (the minimum over every shard);
    * ``with_wkey``: also return the working-flow scatter's key plane,
      (L, h*w+1), -inf where nothing landed.

    The batch holds the accepted candidates only, sized by one host read of
    the counts (``_static``: ``sweep_static``'s fixed batch and no read).
    Returns (new state, accepted counts of the swept lanes, in
    ``lanes`` order), read from the card in that one host read; and the key
    plane third under ``with_wkey``."""
    solver = solver_for(method)
    exact = exact_fill(fill, method)
    dense = fill == "dense"
    exactmin_band = str(exactmin_band)
    if exactmin_band not in EXACTMIN_BANDS:
        raise ValueError(f"exactmin_band {exactmin_band!r}: expected one of "
                         f"{EXACTMIN_BANDS}")
    with_chi = method == P.M_TVL1_OCC
    n = h * w
    stride = n + 1
    nl = state.fixed.shape[0]
    stacked = sconsts.i0pad.dim() == 3
    if nl > 1 and not stacked:
        raise ValueError(f"{nl} lanes need lane-stacked consts "
                         "(stack_solver_consts)")
    p = 2 * wr + 1
    dev = state.cand_e.device
    delta = float(np.float32(delta))
    rows = _lane_rows(nl, lanes, dev)
    ymin, ymax = (0, h) if ybounds is None else ybounds

    # --- selection, per lane (K2): top-bsz eligible, delta band,
    # queue-adaptive floor; the ordering modes build their mask with plain
    # ops between K2's two calls
    e_pop, idx, queue = select(state.cand_e, state.fixed, state.ene, n, bsz,
                               relax, None if isinstance(rows, slice) else rows,
                               owned)
    throttle = (delta, delta_rel, floor, floor_scale, floor_scale_hi,
                queue_hi)
    valid = None
    if block or exactmin > 0 or defer > 0:
        eligible = eligibility(state, n, relax, lanes, owned)
        _, e_ok, floor_dyn = band_floor_plain(e_pop, queue, *throttle,
                                              band_min)
        if block:
            # a candidate passes with its tile's band or the global one
            e_ok = e_ok | _block_band(eligible, h, w, block, delta,
                                      delta_rel).gather(1, idx)
        rank = torch.arange(e_pop.shape[1], device=dev)
        in_floor = e_ok | (rank < floor_dyn)
        valid = torch.isfinite(e_pop) & in_floor
        if exactmin > 0:
            # the window minima of the keys, in place of the band and the
            # floor
            wmin = _window_reduce(eligible.view(-1, h, w), int(exactmin), "min")
            valid = torch.isfinite(e_pop) & (eligible <= wmin.view(-1, n)).gather(
                1, idx)
            if exactmin_band == "1":
                valid = valid & e_ok
            elif exactmin_band == "2":
                valid = valid & in_floor
        if defer > 0:
            pops = [getattr(state, f)[rows, :n].gather(1, idx)
                    for f in ("cand_u", "cand_v")]
            valid = valid & ~_contested(valid, idx, e_pop, *pops, h, w,
                                        float(np.float32(defer)),
                                        int(defer_win) or p)
    acc = accept(e_pop, queue, *throttle, band_min=band_min, valid=valid)
    width = e_pop.shape[1]
    if _static:
        # the whole batch, the accepted (lane, rank) pairs first
        pick = acc.order
        if dev.type == "cpu":
            # no card to spare a read of here, and the CPU twins' time grows
            # with the batch: cut it to the accepted count rounded up to a
            # power of two (canvases are independent: the same result)
            total = int(acc.total)
            pick = pick[:min(pick.shape[0], 1 << max(total - 1, 0).bit_length())]
        ok_b = torch.arange(pick.shape[0], device=dev) < acc.total
        counts = acc.counts
    else:
        counts = acc.counts.tolist()        # the sweep's one host read
        k = sum(counts)
        if k == 0:
            if with_wkey:
                return state, counts, torch.full(state.wu.shape, -INF,
                                                 dtype=torch.float32,
                                                 device=dev)
            return state, counts
        # the accepted (lane, rank) pairs, lane-major, in rank order
        pick = acc.order[:k]
        ok_b = None
    k = pick.shape[0]
    pix = idx.reshape(-1)[pick]
    lane = pick // width
    if not isinstance(rows, slice):
        lane = rows[lane]
    base = lane * stride
    q = base + pix                         # flat slots of the batch's pixels
    dump = base + n                        # their lanes' dump slots
    q_fix = q if ok_b is None else torch.where(ok_b, q, dump)

    i, j, oy, ox, ph, pw = patch_geometry(pix, h, w, wr, ymin, ymax)

    # --- fix accepted candidates (local_growing pop, :899-937)
    flat = GrowState(*(t.reshape(-1) for t in state))
    fixed = flat.fixed.index_put((q_fix,), torch.ones((), dtype=torch.bool,
                                                      device=dev))
    out_u = flat.out_u.index_put((q_fix,), flat.cand_u[q])
    out_v = flat.out_v.index_put((q_fix,), flat.cand_v[q])
    ene = flat.ene.index_put((q_fix,), flat.cand_e[q])
    cand_e = flat.cand_e.index_put((q_fix,), torch.full((), INF, device=dev))
    out_chi = (flat.out_chi.index_put((q_fix,), flat.cand_chi[q]) if with_chi
               else flat.out_chi)

    # --- per-patch init (add_neighbors :688-705): one launch of K0's planes
    # form crops the five state planes where they lie (the flat planes with
    # their dump slot, the trust map in the dtype the caller holds), out_chi
    # and wchi for method 8, and the dense fill's u and v, into contiguous
    # (k, p, p) canvases; the edge pad is the kernel's clamp, at each patch's
    # own lane's edge
    planes = (out_u, out_v, flat.wu, flat.wv)
    if with_chi:
        planes += (out_chi, flat.wchi)
    if stacked:
        planes = tuple(pl.view(nl, stride) for pl in planes)
        planes = planes[:4] + (trust2d,) + planes[4:]
        ln = lane
    else:
        planes = planes[:4] + (trust2d[0],) + planes[4:]
        ln = None
    if dense:
        fills = _dense_fill(fixed, out_u, out_v, nl, rows, h, w)
        planes += ((fills[:, 0], fills[:, 1]) if stacked
                   else (fills[0, 0], fills[0, 1]))
    crops = gather_plane_patches(planes, oy, ox, p, h, w, lane=ln).unbind(0)
    ou, ov, wu_p, wv_p, tr = crops[:5]
    rows_c, cols_c = canvas_ids(p, dev)
    inbox = (rows_c < ph[:, None, None]) & (cols_c < pw[:, None, None])
    fxp = torch.isfinite(ou) & inbox
    nan = torch.full((), NAN, device=dev)
    zero = torch.zeros((), device=dev)
    if dense:
        fill_u, fill_v = crops[-2], crops[-1]
    else:
        fill_u, fill_v = poisson_fill_planes(
            (torch.where(fxp, ou, nan), torch.where(fxp, ov, nan)), ph, pw,
            exact=exact)
    alt_u = torch.where(fxp, ou, wu_p)
    alt_v = torch.where(fxp, ov, wv_p)
    if iteration == 0:
        use_fill = torch.ones((k,), dtype=torch.bool, device=dev)
    else:
        bad_alt = (inbox & ~(torch.isfinite(alt_u) & torch.isfinite(alt_v))
                   ).any(dim=2).any(dim=1)
        untrusted = (inbox & (tr == 0)).any(dim=2).any(dim=1)
        use_fill = untrusted | bad_alt
    uf = use_fill[:, None, None]
    u_init = torch.where(inbox, torch.where(uf, fill_u, alt_u), zero)
    v_init = torch.where(inbox, torch.where(uf, fill_v, alt_v), zero)

    # --- batched patch solve
    c_init = None
    if with_chi:
        # chi init: fixed pixels take out_chi, the others the working chi
        # where it is finite, else 0; 0 outside the box
        oc, wc_p = crops[5], crops[6]
        c_init = torch.where(fxp, oc, torch.where(torch.isfinite(wc_p), wc_p,
                                                  zero))
        c_init = torch.where(inbox, c_init, zero)
    # the solver reads the whole image: at the image's rows
    jg, oyg = (j + row_offset, oy + row_offset) if row_offset else (j, oy)
    su, sv, schi, ener = _solve(solver, sconsts, i, jg, oyg, ox, ph, pw,
                                u_init, v_init, p, warps, max_iters, c_init, ln)

    # --- 4-neighbour candidates and same-sweep donations (:497-537), K3
    q4, inb4, e4, nu4, nv4, nc4 = _neighbour_candidates(
        su, sv, ener, i, j, oy, ox, sal.reshape(-1), h, w, p, schi, base,
        ymin, ymax)
    dump4 = dump.repeat(len(NEIGHBOURS))
    if ok_b is not None:
        inb4 = inb4 & ok_b.repeat(len(NEIGHBOURS))
    if relax:
        ok = (inb4 & (e4 < cand_e[q4])
              & (e4 < ene[q4] * RELAX_MARGIN - 1e-6))
    else:
        ok = inb4 & ~fixed[q4] & (e4 < cand_e[q4])
    okd = inb4 & fixed[q4] & ~flat.fixed[q4] & (e4 < ene[q4])
    cand = scatter_min_payload(cand_e, flat.cand_u, flat.cand_v, q4, e4,
                               nu4, nv4, ok, dump4,
                               **_chi_payload(flat.cand_chi, nc4))
    don = scatter_min_payload(ene, out_u, out_v, q4, e4, nu4, nv4, okd, dump4,
                              **_chi_payload(out_chi, nc4))
    cand_e, cand_u, cand_v = cand[:3]
    ene, out_u, out_v = don[:3]
    cand_chi = cand[3] if with_chi else flat.cand_chi
    out_chi = don[3] if with_chi else out_chi

    # --- centre update (add_neighbors :718-726), after the donations: a
    # min scatter (K3) of the patches whose energy beats their pixel's
    cy, cx = j - oy, i - ox
    bidx = torch.arange(k, device=dev)
    better = ener < ene[q]
    if ok_b is not None:
        better = better & ok_b
    centre = scatter_min_payload(
        ene, out_u, out_v, q, ener, su[bidx, cy, cx], sv[bidx, cy, cx], better,
        dump, **_chi_payload(out_chi, schi[bidx, cy, cx] if with_chi else None))
    ene, out_u, out_v = centre[:3]
    out_chi = centre[3] if with_chi else out_chi

    # --- persistent working flow (max energy wins == later pop wins), K3
    inbox_w = inbox if ok_b is None else inbox & ok_b[:, None, None]
    wu, wv, wchi, wkey = wflow_scatter(flat.wu, flat.wv, flat.wchi, su, sv,
                                       schi, ener, oy, ox, inbox_w, h, w, p,
                                       base)
    new = GrowState(fixed, out_u, out_v, ene, cand_u, cand_v, cand_e, wu, wv,
                    out_chi, cand_chi, wchi)
    new = GrowState(*(t.view(nl, stride) for t in new))
    if with_wkey:
        return new, counts, wkey.view(nl, stride)
    return new, counts


def sweep_static(state: GrowState, sconsts: SolverConsts, trust2d, sal,
                 iteration: int, h: int, w: int, wr: int, bsz: int,
                 warps: int, max_iters: int, floor_scale: int,
                 method: int = P.M_TVL1, lanes=None, **throttles):
    """The drains' sweep of methods 0 and 1 under the patch fills, shaped as
    JAX's ``_sweep_body``: the batch is every swept lane's top min(bsz,
    h*w) candidates, the accepted ones first (lane-major, in rank order, as
    ``sweep_lanes`` batches them) and then the rest, each keeping its pixel
    so that its box lies in the image; every write of a candidate that was
    not accepted (the fix, its neighbour candidates and donations, the
    centre update, the working flow) goes to its lane's dump slot.  K0's
    planes form, K13 and K12 run on the whole batch; canvases are
    independent, so the accepted ones come out bit for bit as in
    ``sweep_lanes``, and the state's h*w cells equal its.  (On CPU tensors
    the batch is cut to the accepted count rounded up to a power of two:
    the twins' time grows with it, and there is no card to read.)  Nothing
    is read back from a card: returns (new state, the swept lanes' accepted counts as an (L',)
    int64 tensor on the state's device).  ``throttles``: ``sweep_lanes``'
    throttles and ordering dials."""
    if method not in STATIC_METHODS or throttles.get("fill") == "dense":
        raise ValueError(f"sweep_static takes methods {STATIC_METHODS} under "
                         f"the patch fills, not method {method}, fill "
                         f"{throttles.get('fill')!r}")
    return sweep_lanes(state, sconsts, trust2d, sal, iteration, h, w, wr, bsz,
                       warps, max_iters, floor_scale, method, lanes=lanes,
                       _static=True, **throttles)


def sweep_body(state: GrowState, sconsts: SolverConsts, trust2d, sal,
               iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
               max_iters: int, floor_scale: int, method: int = P.M_TVL1,
               **throttles):
    """One strict-mode wavefront sweep of one growing lane: ``sweep_lanes``
    at L = 1 on the flat (N+1,) state, (h, w) trust map and (N+1,) saliency,
    with one lane's consts.  ``throttles``: ``sweep_lanes``' (``delta``,
    ``delta_rel``, ``floor``, ``floor_scale_hi``, ``queue_hi``, ``block``,
    ``fill``).  Returns (new state, n_accepted)."""
    st, counts = sweep_lanes(GrowState(*(t[None] for t in state)), sconsts,
                             trust2d[None], sal[None], iteration, h, w, wr,
                             bsz, warps, max_iters, floor_scale, method,
                             **throttles)
    return lane_state(st, 0), counts[0]


def seed_batch(state: GrowState, seed_idx, seed_u, seed_v,
               sconsts: SolverConsts, sal, h: int, w: int, warps: int,
               max_iters: int, method: int = P.M_TVL1) -> GrowState:
    """insert_initial_seeds (:748-796): 3x3 solves around each seed with only
    the seed fixed (exact raster Gauss-Seidel fill), 4-neighbour candidates,
    and the working-flow scatter.  Every lane here is a real seed.  Method
    8's solves start from chi 0, and their chi rides along."""
    solver = solver_for(method)
    with_chi = method == P.M_TVL1_OCC
    n = h * w
    dump = n
    wr, p = 1, 3
    dev = state.cand_e.device
    i, j, oy, ox, ph, pw = patch_geometry(seed_idx, h, w, wr)
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    is_center = (((oy[:, None, None] + rows) == j[:, None, None])
                 & ((ox[:, None, None] + cols) == i[:, None, None]))
    nan = torch.full((), NAN, device=dev)
    zero = torch.zeros((), device=dev)
    fu, fv = poisson_fill_planes(
        (torch.where(is_center, seed_u[:, None, None], nan),
         torch.where(is_center, seed_v[:, None, None], nan)), ph, pw,
        exact=True)
    u_init = torch.where(inbox, fu, zero)
    v_init = torch.where(inbox, fv, zero)
    su, sv, schi, ener = _solve(
        solver, sconsts, i, j, oy, ox, ph, pw, u_init, v_init, p, warps,
        max_iters, torch.zeros_like(u_init) if with_chi else None)

    q4, inb4, e4, nu4, nv4, nc4 = _neighbour_candidates(
        su, sv, ener, i, j, oy, ox, sal, h, w, p, schi)
    out = scatter_min_payload(
        state.cand_e, state.cand_u, state.cand_v, q4, e4, nu4, nv4,
        inb4 & (e4 < state.cand_e[q4]), dump,
        **_chi_payload(state.cand_chi, nc4))
    wu, wv, wchi, _ = wflow_scatter(state.wu, state.wv, state.wchi, su, sv,
                                    schi, ener, oy, ox, inbox, h, w, p)
    return state._replace(cand_e=out[0], cand_u=out[1], cand_v=out[2],
                          cand_chi=out[3] if with_chi else state.cand_chi,
                          wu=wu, wv=wv, wchi=wchi)


def refix_seeds(state: GrowState, idx, su, sv) -> GrowState:
    """Overwrite seed pixels with their original flow at zero energy
    (local_faldoi.cpp:785-795)."""
    dev = state.cand_e.device
    return state._replace(
        fixed=state.fixed.index_put((idx,), torch.ones((), dtype=torch.bool,
                                                       device=dev)),
        out_u=state.out_u.index_put((idx,), su),
        out_v=state.out_v.index_put((idx,), sv),
        ene=state.ene.index_put((idx,), torch.zeros((), device=dev)),
        cand_e=state.cand_e.index_put((idx,), torch.full((), INF, device=dev)),
    )


def insert_seeds(state: GrowState, seeds: np.ndarray, sconsts: SolverConsts,
                 sal, warps: int, max_iters: int, seed_bsz: int = 2048,
                 method: int = P.M_TVL1) -> GrowState:
    """Seed insertion from an (h, w, 2) NaN-sparse field, in chunks of
    ``seed_bsz`` seeds as ``LocalSolver.insert_seeds`` does (each chunk's
    working-flow scatter starts from a fresh key plane, so chunking is part
    of the result), then re-fix the seeds."""
    h, w = seeds.shape[:2]
    dev = state.cand_e.device
    su = np.asarray(seeds[:, :, 0], np.float32).ravel()
    sv = np.asarray(seeds[:, :, 1], np.float32).ravel()
    pos = np.nonzero(np.isfinite(su) & np.isfinite(sv))[0]
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    su_t = torch.as_tensor(su[pos], device=dev)
    sv_t = torch.as_tensor(sv[pos], device=dev)
    for k0 in range(0, len(pos), seed_bsz):
        sl = slice(k0, k0 + seed_bsz)
        state = seed_batch(state, pos_t[sl], su_t[sl], sv_t[sl], sconsts, sal,
                           h, w, warps, max_iters, method)
    return refix_seeds(state, pos_t, su_t, sv_t)


# sweeps between the sync points of JAX's chunked ``grow``
CHUNK = 64
# sweeps between the host's reads of a static drain's lane flags and sweep
# counts: a divisor of CHUNK, so that the snapshots fall where they did.
# Measured on the m0 growing on four hosts (PERF.md 6, with
# ``cli/sweep_profile.time_sync_sweeps``): the best interval moved from host
# to host within 1-16; 4 came within 14% of the best median on each (a
# read stalls the host, a no-op sweep costs a full sweep)
SYNC_SWEEPS = 4


def drain_lanes(state: GrowState, sconsts: SolverConsts, trust2d, sal,
                iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
                max_iters: int, floor_scale: int, method: int = P.M_TVL1,
                lanes=None, on_chunk=None, reads=None, **throttles):
    """Sweep the lanes ``lanes`` (None: all) of a lane-stacked state together
    until every one accepts nothing (``grow_to_completion`` a lane).  A
    lane's count ends with its first empty sweep, which it includes, as
    JAX's does; a drained lane's sweep changes nothing.  Returns (state,
    sweeps of each lane in ``lanes`` order).  ``throttles`` go to every
    sweep.

    Methods 0 and 1 under the patch fills drain as JAX's ``drain_pair``
    does (``sweep_static``): every lane sweeps every time, a drained one as
    a no-op, and each lane's active flag and sweep count stay on the card;
    the host reads them once every ``SYNC_SWEEPS`` sweeps (so up to
    ``SYNC_SWEEPS`` - 1 no-op sweeps run after the last lane drained).
    ``reads`` (a list, optional) gets (sweeps run, host reads) of such a
    drain.
    The other methods and ``fill="dense"`` sweep with ``sweep_lanes``, one
    host read a sweep, the drained lanes left out.

    ``on_chunk(state of lane 0)``, if given, is called after every ``CHUNK``
    sweeps of lane 0 and after its last one: the sync points of JAX's
    chunked ``grow`` (local_step.py:1219-1236), where the partial-results
    snapshots are taken."""
    order = list(range(state.fixed.shape[0])) if lanes is None else list(lanes)
    if method in STATIC_METHODS and throttles.get("fill", "patch") != "dense":
        return _drain_static(state, sconsts, trust2d, sal, iteration, h, w,
                             wr, bsz, warps, max_iters, floor_scale, method,
                             lanes, order, on_chunk, reads, throttles)
    sweeps = dict.fromkeys(order, 0)
    active = order
    while active:
        state, counts = sweep_lanes(state, sconsts, trust2d, sal, iteration,
                                    h, w, wr, bsz, warps, max_iters,
                                    floor_scale, method, lanes=active,
                                    **throttles)
        for lane in active:
            sweeps[lane] += 1
        if on_chunk is not None and 0 in active:
            if counts[active.index(0)] == 0 or sweeps[0] % CHUNK == 0:
                on_chunk(lane_state(state, 0))
        active = [lane for lane, c in zip(active, counts) if c > 0]
    return state, [sweeps[lane] for lane in order]


def _drain_static(state, sconsts, trust2d, sal, iteration, h, w, wr, bsz,
                  warps, max_iters, floor_scale, method, lanes, order,
                  on_chunk, reads_out, throttles):
    """``drain_lanes``' fixed-shape drain: ``sweep_static`` until every
    lane's flag is down, read every ``SYNC_SWEEPS`` sweeps."""
    dev = state.cand_e.device
    nl = len(order)
    active = torch.ones((nl,), dtype=torch.bool, device=dev)
    sweeps = torch.zeros((nl,), dtype=torch.int64, device=dev)
    lane0 = order.index(0) if on_chunk is not None and 0 in order else None
    lane0_done = False
    t = reads = 0
    while True:
        state, counts = sweep_static(state, sconsts, trust2d, sal, iteration,
                                     h, w, wr, bsz, warps, max_iters,
                                     floor_scale, method, lanes=lanes,
                                     **throttles)
        sweeps += active
        active &= counts > 0
        t += 1
        if t % SYNC_SWEEPS:
            continue
        flags = torch.cat([active.to(torch.int64), sweeps]).tolist()
        reads += 1
        up, done = flags[:nl], flags[nl:]
        if lane0 is not None and not lane0_done:
            if not up[lane0] or t % CHUNK == 0:
                on_chunk(lane_state(state, 0))
            lane0_done = not up[lane0]
        if not any(up):
            if reads_out is not None:
                reads_out.append((t, reads))
            return state, done


def drain(state: GrowState, sconsts: SolverConsts, trust2d, sal,
          iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
          max_iters: int, floor_scale: int, method: int = P.M_TVL1,
          on_chunk=None, reads=None, **throttles):
    """Sweep one growing lane until a sweep accepts nothing: ``drain_lanes``
    at L = 1 on the flat state (``sweep_body``'s arguments).  Returns
    (state, sweeps); the count includes the final empty sweep.
    ``on_chunk(state)`` and ``reads`` as in ``drain_lanes``."""
    st, sweeps = drain_lanes(GrowState(*(t[None] for t in state)), sconsts,
                             trust2d[None], sal[None], iteration, h, w, wr,
                             bsz, warps, max_iters, floor_scale, method,
                             on_chunk=on_chunk, reads=reads, **throttles)
    return lane_state(st, 0), sweeps[0]


def polish_lanes(state: GrowState, sconsts: SolverConsts, sal, h: int, w: int,
                 wr: int, bsz: int, warps: int, max_iters: int,
                 method: int = P.M_TVL1, lanes=None) -> GrowState:
    """One re-polish pass over the lanes ``lanes`` (None: all) of a
    lane-stacked state (JAX's ``polish_all``, local_step.py:1466-1546, a
    lane at a time): every fixed pixel's patch is solved again from the
    current flow, in raster chunks of ``bsz`` pixels, each chunk reading the
    planes the chunks before it wrote (within a chunk, Jacobi).  The init is
    out_u, out_v (and method 8's out_chi) cropped exactly (K0's planes
    form; NaN as 0, 0 outside the patch box); where the solved centre flow is
    finite, out_u, out_v (out_chi), ene = energy * saliency and the working
    flow at the centre take the re-solve.  Unfixed pixels keep their state.

    ``sconsts``, ``sal`` and the lane layout as in ``sweep_lanes``.  Every
    pixel of a chunk is solved for every lane and the results of unfixed
    ones are dropped (each patch solve is independent of the others)."""
    solver = solver_for(method)
    with_chi = method == P.M_TVL1_OCC
    n = h * w
    stride = n + 1
    nl = state.fixed.shape[0]
    stacked = sconsts.i0pad.dim() == 3
    if nl > 1 and not stacked:
        raise ValueError(f"{nl} lanes need lane-stacked consts "
                         "(stack_solver_consts)")
    p = 2 * wr + 1
    dev = state.out_u.device
    rows_l = list(range(nl)) if lanes is None else list(lanes)
    lanes_t = torch.as_tensor(rows_l, dtype=torch.int64, device=dev)
    flat = GrowState(*(t.reshape(-1) for t in state))
    out_u, out_v, out_chi = flat.out_u, flat.out_v, flat.out_chi
    ene, wu, wv = flat.ene, flat.wu, flat.wv
    sal_f = sal.reshape(-1)
    zero = torch.zeros((), device=dev)
    for c0 in range(0, n, bsz):
        pix1 = torch.arange(c0, min(c0 + bsz, n), device=dev)
        lane = lanes_t.repeat_interleave(pix1.shape[0])
        pix = pix1.repeat(len(rows_l))
        q = lane * stride + pix
        dump = lane * stride + n
        i, j, oy, ox, ph, pw = patch_geometry(pix, h, w, wr)
        planes = (out_u, out_v) + ((out_chi,) if with_chi else ())
        if stacked:
            planes = tuple(pl.view(nl, stride) for pl in planes)
        ln = lane if stacked else None
        crops = gather_plane_patches(planes, oy, ox, p, h, w, lane=ln)
        rows_c, cols_c = canvas_ids(p, dev)
        inbox = (rows_c < ph[:, None, None]) & (cols_c < pw[:, None, None])
        init = [torch.where(inbox, torch.nan_to_num(cr), zero) for cr in crops]
        su, sv, schi, ener = _solve(solver, sconsts, i, j, oy, ox, ph, pw,
                                    init[0], init[1], p, warps, max_iters,
                                    init[2] if with_chi else None, ln)
        bidx = torch.arange(pix.shape[0], device=dev)
        cy, cx = j - oy, i - ox
        cu, cv = su[bidx, cy, cx], sv[bidx, cy, cx]
        good = flat.fixed[q] & torch.isfinite(cu) & torch.isfinite(cv)
        upd = torch.where(good, q, dump)

        def put(t, v):
            return t.index_put((upd,), torch.where(good, v, t[upd]))

        out_u, out_v = put(out_u, cu), put(out_v, cv)
        if with_chi:
            out_chi = put(out_chi, schi[bidx, cy, cx])
        ene = put(ene, ener * sal_f[q])
        wu, wv = put(wu, cu), put(wv, cv)
    new = flat._replace(out_u=out_u, out_v=out_v, out_chi=out_chi, ene=ene,
                        wu=wu, wv=wv)
    return GrowState(*(t.view(state.fixed.shape) for t in new))

"""Local step — energy-guided seed growing as batched best-first sweeps.

Port of ``faldoi_tpu/core/local_step.py`` in its strict mode (the CPU
``mode="fused"`` semantics that ``match_growing`` runs by default): per sweep
the ``bsz`` lowest-energy unfixed candidates are selected, those inside the
delta band or under the queue-adaptive rank floor are fixed, their 11x11
patches are cropped (K0), Poisson-filled, solved (the method's patch
solver, with K4 warps) and the results are scattered: min-energy wins for the
4-neighbour candidates and the donations to pixels accepted in the same
sweep, the centre update when its energy improves, and max-energy wins for
the persistent working flow over the whole patch.

State layout: flat (h*w+1,) planes; the extra slot is the dump for masked
writes, as in JAX.

Ties, which JAX leaves to the backend: candidate selection breaks equal
energies by the lower flat index (``lax.top_k``'s rule; a stable sort here),
and a payload scatter whose winners tie on the key keeps the LAST update in
JAX's flattening order (what XLA's sequential CPU scatter does), on every
device.

Selection is exact: the accepted lanes are always a prefix of the sorted
batch (every acceptance test is monotone in the sorted energy), so the port
solves only those ``n_acc`` lanes.  JAX solves all ``bsz`` lanes and masks
the rest; the masked lanes write nothing, so the results are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.functionals import (
    SolverConsts, pad_for_crops, solver_for,
)
from faldoi_tpu_torch.ops.patch_gather import gather_patches
from faldoi_tpu_torch.ops.poisson import poisson_fill_canvas
from faldoi_tpu_torch.ops.stencils import canvas_ids

INF = float("inf")
NAN = float("nan")
# strict-mode acceptance of match_growing's defaults: the delta band is
# e_min + max(DELTA, DELTA_REL * e_min), and the rank floor is
# min(FLOOR, queue // floor_scale)
DELTA = 0.05
DELTA_REL = 0.5
FLOOR = 4096
# 4-neighbour order of insert_candidates (and of JAX's concatenation)
NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0))


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
    )


def state_from_numpy(st, device) -> GrowState:
    """Carry a JAX ``GrowState`` (any object with its field names, or a
    mapping) into the port; the method-8 chi planes are not used by m0."""
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


def patch_geometry(idx, h, w, wr):
    """get_index_patch (utils.cpp:36-54) for flat indices:
    (i, j, oy, ox, ph, pw)."""
    i = idx % w
    j = idx // w
    oy = (j - wr).clamp(min=0)
    ox = (i - wr).clamp(min=0)
    ph = (j + 1 + wr).clamp(max=h) - oy
    pw = (i + 1 + wr).clamp(max=w) - ox
    return i, j, oy, ox, ph, pw


def _last_winner(qs, winner, pos, size):
    """Among the winners that target one slot keep the one with the largest
    ``pos`` (JAX's flattening order: XLA's sequential scatter keeps the last
    write)."""
    key = torch.where(winner, pos, torch.full_like(pos, -1))
    best = torch.full((size,), -1, dtype=pos.dtype, device=pos.device)
    best = best.scatter_reduce(0, qs, key, "amax", include_self=True)
    return winner & (best[qs] == pos)


def _positions(q, pos):
    return torch.arange(q.shape[0], device=q.device) if pos is None else pos


def scatter_min_payload(tgt_e, tgt_u, tgt_v, q, e, u, v, ok, dump, pos=None):
    """Scatter (e, u, v) to q where ok, keeping per slot the minimum e
    (``_scatter_min_payload``).  ``pos`` orders tied winners (default: the
    update order)."""
    qs = torch.where(ok, q, torch.full_like(q, dump))
    e_m = torch.where(ok, e, torch.full_like(e, INF))
    tgt_e = tgt_e.scatter_reduce(0, qs, e_m, "amin", include_self=True)
    winner = ok & (e_m <= tgt_e[qs])
    sel = _last_winner(qs, winner, _positions(q, pos), tgt_e.shape[0])
    qw = torch.where(sel, q, torch.full_like(q, dump))
    return tgt_e, tgt_u.index_put((qw,), u), tgt_v.index_put((qw,), v)


def scatter_max_payload(key_buf, tgt_u, tgt_v, q, key, u, v, ok, dump,
                        pos=None):
    """Scatter (u, v) to q where ok, keeping the payload of the maximum key
    (``_scatter_max_payload`` in its exact form)."""
    qs = torch.where(ok, q, torch.full_like(q, dump))
    k_m = torch.where(ok, key, torch.full_like(key, -INF))
    key_buf = key_buf.scatter_reduce(0, qs, k_m, "amax", include_self=True)
    winner = ok & (k_m >= key_buf[qs])
    sel = _last_winner(qs, winner, _positions(q, pos), key_buf.shape[0])
    qw = torch.where(sel, q, torch.full_like(q, dump))
    return key_buf, tgt_u.index_put((qw,), u), tgt_v.index_put((qw,), v)


def _neighbour_candidates(su, sv, ener, i, j, oy, ox, sal, h, w, p):
    """The 4-neighbour candidates of B solved patches, concatenated in
    ``NEIGHBOURS`` order: (q, in_image, energy, u, v).  q is the dump slot
    where the neighbour leaves the image; (u, v) come from the patch cell
    next to the centre."""
    cy, cx = j - oy, i - ox
    bidx = torch.arange(i.shape[0], device=i.device)
    qs, inbs, nus, nvs = [], [], [], []
    for dx, dy in NEIGHBOURS:
        qi, qj = i + dx, j + dy
        inb = (qi >= 0) & (qi < w) & (qj >= 0) & (qj < h)
        qs.append(torch.where(inb, qj * w + qi, torch.full_like(qi, h * w)))
        inbs.append(inb)
        r = (cy + dy).clamp(0, p - 1)
        c = (cx + dx).clamp(0, p - 1)
        nus.append(su[bidx, r, c])
        nvs.append(sv[bidx, r, c])
    q = torch.cat(qs)
    return (q, torch.cat(inbs), ener.repeat(len(NEIGHBOURS)) * sal[q],
            torch.cat(nus), torch.cat(nvs))


def _wflow_scatter(state_wu, state_wv, su, sv, ener, oy, ox, inbox, h, w, p):
    """Max-energy-wins working-flow scatter over every in-box patch cell."""
    n = h * w
    k = su.shape[0]
    rows, cols = canvas_ids(p, su.device)
    gy = oy[:, None, None] + rows
    gx = ox[:, None, None] + cols
    flat_q = torch.where(inbox, gy * w + gx, torch.full_like(gy, n))
    key = ener[:, None, None].expand(k, p, p)
    bidx = torch.arange(k, device=su.device)[:, None, None]
    pos = (rows * p + cols) * k + bidx          # JAX order: cell-major
    key_buf = torch.full((n + 1,), -INF, dtype=torch.float32, device=su.device)
    _, wu, wv = scatter_max_payload(
        key_buf, state_wu, state_wv, flat_q.reshape(-1), key.reshape(-1),
        su.reshape(-1), sv.reshape(-1), inbox.reshape(-1), n, pos.reshape(-1))
    return wu, wv


def _fill_pair(u, v, ph, pw, exact):
    """Poisson-fill the u and v canvases as one batch of 2B."""
    f = poisson_fill_canvas(torch.cat([u, v]), torch.cat([ph, ph]),
                            torch.cat([pw, pw]), exact=exact)
    return f[:u.shape[0]], f[u.shape[0]:]


def sweep_body(state: GrowState, sconsts: SolverConsts, trust2d, sal,
               iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
               max_iters: int, floor_scale: int, method: int = P.M_TVL1):
    """One strict-mode wavefront sweep (``_sweep_body`` with relax=False,
    fill="patch_rb", block=0, delta/delta_rel/floor at match_growing's
    defaults, exact working-flow scatter of radius wr), solving with
    ``method``'s patch solver.  Returns (new state, n_accepted)."""
    solver = solver_for(method)
    n = h * w
    dump = n
    p = 2 * wr + 1
    dev = state.cand_e.device
    f32 = torch.float32

    # --- selection: top-bsz eligible, delta band, queue-adaptive floor
    eligible = torch.where(state.fixed[:n], torch.full((), INF, device=dev),
                           state.cand_e[:n])
    vals, order = torch.sort(eligible, stable=True)
    e_pop = vals[:bsz]
    idx = order[:bsz]
    e_min = e_pop[0]
    band = e_min + torch.clamp(DELTA_REL * e_min, min=float(np.float32(DELTA)))
    queue = torch.isfinite(eligible).sum()
    fscale = max(int(floor_scale), 1)
    floor_dyn = (queue // fscale).clamp(min=1).clamp(max=FLOOR) \
        if fscale > 1 else FLOOR
    rank = torch.arange(e_pop.shape[0], device=dev)
    valid = torch.isfinite(e_pop) & ((e_pop <= band) | (rank < floor_dyn))
    k = int(valid.sum())
    if k == 0:
        return state, 0
    idx = idx[:k]

    i, j, oy, ox, ph, pw = patch_geometry(idx, h, w, wr)

    # --- fix accepted candidates (local_growing pop, :899-937)
    fixed = state.fixed.index_put((idx,), torch.ones((), dtype=torch.bool,
                                                     device=dev))
    out_u = state.out_u.index_put((idx,), state.cand_u[idx])
    out_v = state.out_v.index_put((idx,), state.cand_v[idx])
    ene = state.ene.index_put((idx,), state.cand_e[idx])
    cand_e = state.cand_e.index_put((idx,), torch.full((), INF, device=dev))

    # --- per-patch init (add_neighbors :688-705): one K0 crop of 5 planes
    planes = torch.stack([out_u[:n].view(h, w), out_v[:n].view(h, w),
                          state.wu[:n].view(h, w), state.wv[:n].view(h, w),
                          trust2d.to(f32)], dim=-1)
    oy32, ox32 = oy.to(torch.int32), ox.to(torch.int32)
    pl = gather_patches(pad_for_crops(planes, p), oy32, ox32, p).permute(3, 0, 1, 2)
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    ou, ov, wu_p, wv_p, tr = (pl[..., c] for c in range(5))
    fxp = torch.isfinite(ou) & inbox
    nan = torch.full((), NAN, device=dev)
    zero = torch.zeros((), device=dev)
    fill_u, fill_v = _fill_pair(torch.where(fxp, ou, nan),
                                torch.where(fxp, ov, nan), ph, pw, exact=False)
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
    su, sv, ener = solver(sconsts, i, j, oy, ox, ph, pw, u_init, v_init,
                          p, warps, max_iters)

    # --- 4-neighbour candidates and same-sweep donations (:497-537)
    q4, inb4, e4, nu4, nv4 = _neighbour_candidates(su, sv, ener, i, j, oy, ox,
                                                   sal, h, w, p)
    ok = inb4 & ~fixed[q4] & (e4 < cand_e[q4])
    okd = inb4 & fixed[q4] & ~state.fixed[q4] & (e4 < ene[q4])
    cand_e, cand_u, cand_v = scatter_min_payload(
        cand_e, state.cand_u, state.cand_v, q4, e4, nu4, nv4, ok, dump)
    ene, out_u, out_v = scatter_min_payload(
        ene, out_u, out_v, q4, e4, nu4, nv4, okd, dump)

    # --- centre update (add_neighbors :718-726), after the donations
    cy, cx = j - oy, i - ox
    bidx = torch.arange(k, device=dev)
    better = ener < ene[idx]
    upd = torch.where(better, idx, torch.full_like(idx, dump))
    out_u = out_u.index_put((upd,), su[bidx, cy, cx])
    out_v = out_v.index_put((upd,), sv[bidx, cy, cx])
    ene = ene.index_put((upd,), torch.where(better, ener,
                                            torch.full_like(ener, INF)))

    # --- persistent working flow (max energy wins == later pop wins)
    wu, wv = _wflow_scatter(state.wu, state.wv, su, sv, ener, oy, ox, inbox,
                            h, w, p)
    return GrowState(fixed, out_u, out_v, ene, cand_u, cand_v, cand_e,
                     wu, wv), k


def seed_batch(state: GrowState, seed_idx, seed_u, seed_v,
               sconsts: SolverConsts, sal, h: int, w: int, warps: int,
               max_iters: int, method: int = P.M_TVL1) -> GrowState:
    """insert_initial_seeds (:748-796): 3x3 solves around each seed with only
    the seed fixed (exact raster Gauss-Seidel fill), 4-neighbour candidates,
    and the working-flow scatter.  Every lane here is a real seed."""
    solver = solver_for(method)
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
    fu, fv = _fill_pair(torch.where(is_center, seed_u[:, None, None], nan),
                        torch.where(is_center, seed_v[:, None, None], nan),
                        ph, pw, exact=True)
    u_init = torch.where(inbox, fu, zero)
    v_init = torch.where(inbox, fv, zero)
    su, sv, ener = solver(sconsts, i, j, oy, ox, ph, pw, u_init, v_init,
                          p, warps, max_iters)

    q4, inb4, e4, nu4, nv4 = _neighbour_candidates(su, sv, ener, i, j, oy, ox,
                                                   sal, h, w, p)
    cand_e, cand_u, cand_v = scatter_min_payload(
        state.cand_e, state.cand_u, state.cand_v, q4, e4, nu4, nv4,
        inb4 & (e4 < state.cand_e[q4]), dump)
    wu, wv = _wflow_scatter(state.wu, state.wv, su, sv, ener, oy, ox, inbox,
                            h, w, p)
    return state._replace(cand_u=cand_u, cand_v=cand_v, cand_e=cand_e,
                          wu=wu, wv=wv)


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


def drain(state: GrowState, sconsts: SolverConsts, trust2d, sal,
          iteration: int, h: int, w: int, wr: int, bsz: int, warps: int,
          max_iters: int, floor_scale: int, method: int = P.M_TVL1,
          on_chunk=None):
    """Sweep until a sweep accepts nothing (``grow_to_completion``).
    Returns (state, sweeps); the count includes the final empty sweep, as
    JAX's does.

    ``on_chunk(state)``, if given, is called after every ``CHUNK`` sweeps
    and after the last one: the sync points of JAX's chunked ``grow``
    (local_step.py:1219-1236), where the partial-results snapshots are
    taken."""
    sweeps = 0
    while True:
        state, k = sweep_body(state, sconsts, trust2d, sal, iteration, h, w,
                              wr, bsz, warps, max_iters, floor_scale, method)
        sweeps += 1
        if on_chunk is not None and (k == 0 or sweeps % CHUNK == 0):
            on_chunk(state)
        if k == 0:
            return state, sweeps

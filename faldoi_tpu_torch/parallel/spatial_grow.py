"""The local growing with its rows sharded over a device list
(``spatial_match_growing``, ``drain_spatial``).

Port of ``faldoi_tpu/parallel/spatial_grow.py``, the replacement for the
reference's ``-split_img`` partitions (aux_partitions.cpp:47-270).  JAX runs
each drain as one ``shard_map`` program over the mesh's ``space`` axis; here,
as in ``parallel/mesh.py``, a shard is a set of tensors on one device of
``mesh.devices[0]``, the host drives the shards in turn, and a halo exchange
is a ``.to(neighbour's device)`` copy of boundary rows.  Shards that share a
device run the same code and copies.

* Each of the n_space shards owns hs = h / n_space rows of the twelve
  ``GrowState`` planes, the trust map and the saliency, and sweeps an
  extended domain of ``halo + hs + halo`` rows: its own rows and a halo from
  each row neighbour (replicated edge rows at the image border), exchanged
  before every sweep.  It runs ``local_step.sweep_lanes`` there with the
  shard hooks: only its own rows are eligible, boxes and neighbour inserts
  clamp at the true image border, the patch solver reads the replicated
  whole-image consts at global rows.
* The batch is ``bsz_shard = max(256, min(bsz, n) // n_space)`` a shard, the
  rank floor ``bsz_shard // 16`` (``bsz_shard`` under ``relax``), and the
  delta band is anchored at the minimum key over every shard, so acceptance
  follows the global energy order: the shards' per-lane minima go to the
  first device, their minimum comes back (no host read).
* After each sweep the writes that landed in a halo go back to their owner
  (``merge_halo_writes``): a candidate where the neighbour's is strictly
  lower, the working flow where the neighbour's scatter key is strictly
  higher than the owner's own.  Donations do not cross shards: they arrive
  one sweep later as candidates, as in JAX.
* ``spatial_match_growing`` is ``match_growing``'s outer loop
  (``match_growing._grow``) with a sharded drain: the seeds go in unsharded
  on the first device; each drain shards the state, runs ``drain_spatial``
  and gathers the owned rows back there, where the whole flows are pruned
  and requeued.

The CUDA kernels run on every shard's device through ``sweep_lanes``: K0's
planes form (the state crop) and its stack form (the I0 crop of the solver,
at global rows), K4's patch form (the I1 warp), and for methods 4 and 5 the
K8 loop.  The halo exchange and the merges are copies and selects.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.core.local_step import (
    GrowState, eligibility, sweep_lanes,
)
from faldoi_tpu_torch.core.match_growing import _grow
from faldoi_tpu_torch.parallel.mesh import Mesh, _halo_exchange_band

# the methods JAX's sharded growing can run: it builds no NLTV weights
# (methods 2, 3, 6, 7) and no occlusion consts (method 8)
SPATIAL_METHODS = (P.M_TVL1, P.M_TVL1_W, P.M_TVCSAD, P.M_TVCSAD_W)
# the value of each plane in a flat state's pad slot (JAX's ``pads``)
PADS = {"fixed": False, "out_u": float("nan"), "out_v": float("nan"),
        "ene": float("inf"), "cand_u": 0.0, "cand_v": 0.0,
        "cand_e": float("inf"), "wu": float("nan"), "wv": float("nan"),
        "out_chi": 0.0, "cand_chi": 0.0, "wchi": 0.0}
# the planes a halo merge returns to their owner: the candidates (lowest
# cand_e wins) and the working flow (highest scatter key wins)
CAND_KEYS = ("cand_e", "cand_u", "cand_v", "cand_chi")
W_KEYS = ("wu", "wv", "wchi")


def _flat_with_pad(x, k):
    """(L, rows, w) plane -> (L, rows * w + 1) with plane ``k``'s pad."""
    nl = x.shape[0]
    pad = torch.full((nl, 1), PADS[k], dtype=x.dtype, device=x.device)
    return torch.cat([x.reshape(nl, -1), pad], dim=1)


def _to_ext(shards, halo: int):
    """The shards' (L, hs, w) states extended by ``halo`` rows from each
    row neighbour, as flat (L, (hs + 2 halo) * w + 1) states."""
    planes = {k: _halo_exchange_band([getattr(s, k) for s in shards], halo,
                                     dim=1)
              for k in GrowState._fields}
    return [GrowState(**{k: _flat_with_pad(planes[k][s], k)
                         for k in GrowState._fields})
            for s in range(len(shards))]


def merge_halo_writes(ext, wkeys, halo: int):
    """Each shard's own rows after a sweep, with the writes its neighbours
    made in their halo copies of its rows merged back (JAX's
    spatial_grow.py:197-242).

    ``ext``: per shard, a mapping of the twelve plane names to (L, he, w)
    extended-domain planes; ``wkeys``: per shard, its working-flow scatter's
    (L, he, w) key plane.  Shard s's last ``halo`` rows take shard s+1's top
    halo strip, its first ``halo`` rows shard s-1's bottom strip, in that
    order (the edge shards lack one): first the candidates (cand_e, cand_u,
    cand_v, cand_chi) where the strip's cand_e is strictly lower than the
    owner's current one, then the working flow (wu, wv, wchi) where the
    strip's key is strictly higher than the owner's own key at that row.
    Ties keep the owner's value.  Returns per shard a dict of (L, hs, w)
    planes on its device."""
    ns = len(ext)
    out = []
    for s in range(ns):
        he = wkeys[s].shape[1]
        hs = he - 2 * halo
        dev = wkeys[s].device
        new = {k: x[:, halo:halo + hs].clone() for k, x in ext[s].items()}
        # (my rows, neighbour, its strip, my own key at those rows)
        sides = []
        if s < ns - 1:
            sides.append((slice(hs - halo, hs), s + 1, slice(0, halo),
                          wkeys[s][:, hs:hs + halo]))
        if s > 0:
            sides.append((slice(0, halo), s - 1, slice(he - halo, he),
                          wkeys[s][:, halo:2 * halo]))
        for mine, nb, strip, _ in sides:
            their = {k: ext[nb][k][:, strip].to(dev) for k in CAND_KEYS}
            win = their["cand_e"] < new["cand_e"][:, mine]
            for k in CAND_KEYS:
                new[k][:, mine] = torch.where(win, their[k], new[k][:, mine])
        for mine, nb, strip, own_key in sides:
            win = wkeys[nb][:, strip].to(dev) > own_key
            for k in W_KEYS:
                new[k][:, mine] = torch.where(win, ext[nb][k][:, strip].to(dev),
                                              new[k][:, mine])
        out.append(new)
    return out


def _shard_geometry(devs, hs: int, halo: int, w: int):
    """Per shard: the owned mask of its extended domain's flat pixels, its
    true-image row bounds there, and the offset from its rows to the
    image's."""
    ns = len(devs)
    he = hs + 2 * halo
    out = []
    for s, dev in enumerate(devs):
        rr = torch.arange(he, device=dev)
        owned = ((rr >= halo) & (rr < halo + hs)).repeat_interleave(w)
        ybounds = (halo if s == 0 else 0, halo + hs if s == ns - 1 else he)
        out.append((owned, ybounds, s * hs - halo))
    return out


def drain_spatial(mesh: Mesh, shards, sconsts, trust, sal, iteration: int,
                  h: int, w: int, wr: int, bsz: int, warps: int,
                  max_iters: int, floor_scale: int, method: int = P.M_TVL1,
                  halo: int = 8, lanes=None, relax: bool = False,
                  **throttles):
    """Drain the lanes ``lanes`` (None: all) of a row-sharded growing state.

    ``shards``: per device of ``mesh.devices[0]``, a ``GrowState`` of
    (L, hs, w) planes, its own rows; ``sconsts``: per shard, the whole
    image's lane-stacked consts on its device; ``trust``, ``sal``: per
    shard, (L, hs, w).  Every sweep extends the shards by their halos, runs
    ``sweep_lanes`` on each (``bsz`` a shard, the band anchored at the
    minimum key over the shards) and merges the halo writes back
    (``merge_halo_writes``).  A lane leaves after a sweep in which no shard
    accepted for it: its state is then a fixed point (no write, and the
    strict merges change nothing).  ``throttles`` go to every sweep.
    Returns (shards, sweeps of each lane in ``lanes`` order, the final
    empty sweep included)."""
    devs = mesh.devices[0]
    hs = h // len(devs)
    he = hs + 2 * halo
    ne = he * w
    nl = shards[0].fixed.shape[0]
    geo = _shard_geometry(devs, hs, halo, w)
    trust_ext = _halo_exchange_band(trust, halo, dim=1)
    sal_ext = [torch.cat([x.reshape(nl, ne),
                          torch.ones((nl, 1), dtype=x.dtype, device=x.device)],
                         dim=1)
               for x in _halo_exchange_band(sal, halo, dim=1)]
    order = list(range(nl)) if lanes is None else list(lanes)
    sweeps = dict.fromkeys(order, 0)
    active = order
    first = devs[0]
    while active:
        ext = _to_ext(shards, halo)
        mins = [eligibility(e, ne, relax, active, g[0]).amin(1, keepdim=True)
                for e, g in zip(ext, geo)]
        band_min = torch.stack([m.to(first) for m in mins]).amin(0)
        totals = [0] * len(active)
        planes, wkeys = [], []
        for s, dev in enumerate(devs):
            owned, ybounds, roff = geo[s]
            st, counts, wkey = sweep_lanes(
                ext[s], sconsts[s], trust_ext[s], sal_ext[s], iteration, he,
                w, wr, bsz, warps, max_iters, floor_scale, method,
                lanes=active, relax=relax, owned=owned, ybounds=ybounds,
                row_offset=roff, band_min=band_min.to(dev), with_wkey=True,
                **throttles)
            totals = [a + c for a, c in zip(totals, counts)]
            planes.append({k: getattr(st, k)[:, :ne].view(nl, he, w)
                           for k in GrowState._fields})
            wkeys.append(wkey[:, :ne].view(nl, he, w))
        shards = [GrowState(**m) for m in merge_halo_writes(planes, wkeys,
                                                            halo)]
        for lane in active:
            sweeps[lane] += 1
        active = [lane for lane, c in zip(active, totals) if c > 0]
    return shards, [sweeps[lane] for lane in order]


def _split_rows(x, devs, hs: int):
    """(L, h, w) -> per device its (L, hs, w) rows."""
    return [x[:, s * hs:(s + 1) * hs].to(dev).contiguous()
            for s, dev in enumerate(devs)]


def _shard_state(state: GrowState, devs, h: int, w: int):
    """A flat (L, h*w+1) state -> per device a state of its (L, hs, w)
    rows."""
    nl = state.fixed.shape[0]
    hs = h // len(devs)
    planes = {k: _split_rows(getattr(state, k)[:, :h * w].view(nl, h, w),
                             devs, hs)
              for k in GrowState._fields}
    return [GrowState(**{k: planes[k][s] for k in GrowState._fields})
            for s in range(len(devs))]


def _gather_state(shards, dev) -> GrowState:
    """The shards' rows joined on ``dev`` as a flat (L, h*w+1) state, each
    plane's pad slot at ``PADS``."""
    return GrowState(**{k: _flat_with_pad(
        torch.cat([getattr(s, k).to(dev) for s in shards], dim=1), k)
        for k in GrowState._fields})


def _consts_on(sc, dev):
    """``SolverConsts`` with every tensor on ``dev`` (the same tensors where
    they lie there already)."""
    return sc._replace(**{k: v.to(dev) for k, v in sc._asdict().items()
                          if isinstance(v, torch.Tensor)})


def _sharded_drain(mesh: Mesh, halo: int):
    """A drain with ``local_step.drain_lanes``'s signature that shards the
    flat lane-stacked state by rows over ``mesh.devices[0]``, drains it
    there (``drain_spatial``) and joins the rows back on the state's device.
    The consts go to every device once.  ``on_chunk`` is always None here:
    the sharded growing takes no snapshots; ``reads`` stays empty (its
    sweeps read the card every sweep)."""
    devs = mesh.devices[0]
    cache = {}

    def drain(state, sconsts, trust2d, sal, iteration, h, w, wr, bsz, warps,
              max_iters, floor_scale, method=P.M_TVL1, lanes=None,
              on_chunk=None, reads=None, **throttles):
        if cache.get("of") is not sconsts:
            cache.update(of=sconsts, on=[_consts_on(sconsts, d) for d in devs])
        hs = h // len(devs)
        nl = state.fixed.shape[0]
        shards, sweeps = drain_spatial(
            mesh, _shard_state(state, devs, h, w), cache["on"],
            _split_rows(trust2d, devs, hs),
            _split_rows(sal[:, :h * w].view(nl, h, w), devs, hs), iteration,
            h, w, wr, bsz, warps, max_iters, floor_scale, method, halo, lanes,
            **throttles)
        return _gather_state(shards, state.fixed.device), sweeps

    return drain


def spatial_match_growing(mesh: Mesh, go: np.ndarray, ba: np.ndarray,
                          i0n, i1n, prm: P.Parameters, bsz: int = 8192,
                          halo: int = 8, delta: float = 0.05,
                          fill: str = "patch", relax: bool = False,
                          delta_rel: float = 0.5, floor_scale: int = 64,
                          floor_scale_late: Optional[int] = None,
                          warm_band: int = 10, exactmin: int = 0,
                          exactmin_band: str = "0", defer: float = 0.0,
                          defer_win: int = 0, stats=None):
    """``match_growing`` with the growing state and its sweeps sharded by
    rows over the mesh's ``space`` axis (``mesh.devices[0]``): the outer
    loop is ``match_growing``'s (seeds inserted, pruned and requeued whole
    on the first device: the warm requeue with ``warm_band``, the cold one
    at 0), and every drain is ``drain_spatial``.  JAX's final drain sweeps
    both lanes; this one sweeps the forward lane alone, which gives the same
    forward state, as the lanes never interact.

    ``go``, ``ba``: (h, w, 2) NaN-sparse seeds; ``i0n``, ``i1n``: the
    normalized, smoothed frames (moved to the first device).  Methods 0, 1,
    4 and 5; ``fill`` "patch" is the red-black fill for methods 0 and 1 and
    the exact one for 4 and 5, as in JAX.  The defaults are JAX's; its
    environment knobs are arguments: ``floor_scale_late`` (the later drains'
    scale, None = ``min(floor_scale, 16)``; ``FALDOI_GROW_FS_LATE``),
    ``warm_band`` (``FALDOI_GROW_WARM_BAND``) and the ordering dials
    ``exactmin``, ``exactmin_band``, ``defer``, ``defer_win`` (see
    ``local_step.sweep_lanes``; their windows are shard-local, as in JAX).
    ``relax`` makes every drain label-correcting, with ``delta_rel``'s band.
    The batch a shard is ``max(256, min(bsz, n) // n_space)``, its rank
    floor a 16th of that (all of it under ``relax``).  JAX's rung ladder,
    ``FALDOI_GROW_CHUNK`` and ``FALDOI_GROW_LEAN`` are not ported: they
    change no value, and at bsz <= 256 n_space the ladder is this one rung.

    Returns (flow (h, w, 2), energy (h, w), occlusions (h, w)) of the
    forward lane as tensors on the first device, as ``match_growing`` does.
    ``stats`` (a dict, optional) receives ``match_growing``'s stage seconds
    (seed_insertion, drain_it{k}, prune_requeue_it{k}, drain_final_fwd) and
    each lane's sweeps a drain (``sweeps``: entries with "it", "lane",
    "sweeps")."""
    method = prm.val_method
    if method not in SPATIAL_METHODS:
        raise ValueError(
            f"spatial_match_growing runs methods 0, 1, 4 and 5, not {method}: "
            "JAX's sharded growing builds no NLTV weights (methods 2, 3, 6, "
            "7) and no occlusion consts or frames I-1, I2 (method 8)")
    if mesh.shape["data"] > 1:
        raise ValueError(
            f"spatial_match_growing shards one frame over 'space'; a 'data' "
            f"axis of {mesh.shape['data']} would repeat the same growing")
    first = mesh.devices[0][0]
    ns = mesh.shape["space"]
    i0n = i0n.to(first, torch.float32)
    i1n = i1n.to(first, torch.float32)
    h, w = i0n.shape
    if h % ns:
        raise ValueError(f"{h} rows do not divide the space axis {ns}")
    hs = h // ns
    wr = prm.w_radio
    if not wr + 1 <= halo <= hs:
        raise ValueError(f"halo {halo} must cover the patch reach (>= "
                         f"{wr + 1}) and fit a shard of {hs} rows")
    bsz_shard = max(256, min(bsz, h * w) // ns)
    floor = bsz_shard if relax else max(1, bsz_shard // 16)
    return _grow([(go, ba)], [(i0n, i1n)], prm, bsz_shard, 2048, stats,
                 warm_band, None, [(None, None)], [(None, None)], None,
                 floor_scale, floor_scale_late,
                 dict(delta=delta, delta_rel=delta_rel, floor=floor,
                      floor_scale_hi=0, queue_hi=1 << 30, block=0, fill=fill,
                      relax=relax, exactmin=exactmin,
                      exactmin_band=exactmin_band, defer=defer,
                      defer_win=defer_win),
                 drain_fn=_sharded_drain(mesh, halo))[0]

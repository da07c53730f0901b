"""Candidate selection of the growing's sweep — kernel K2 and its plain twins.

Counterpart of the selection in ``faldoi_tpu/core/local_step.py:302-405``
(``_sweep_body``): per lane the eligibility key of every pixel, the
``bsz`` lowest keys in ``lax.top_k(-key, bsz)``'s order (:333), the queue,
the delta band, the queue-adaptive rank floor and the accepted mask.  Two
entry points, so that the ordering modes (``local_step.sweep_lanes``: the
block-local band, ``exactmin``, ``defer``) can build their masks with plain
ops between them:

* ``select``: the keys, the top ``cap = min(bsz, h*w)`` of each swept lane
  (e_pop, flat idx) and the queue (the count of finite keys);
* ``accept``: each lane's band and floor, the accepted mask (or the one the
  modes built), and the accepted (lane, rank) pairs lane-major in rank
  order, followed by the rest, with each lane's count and the total.  All
  of it stays on the card: the sweep reads nothing back to size its batch.

The order is ``lax.top_k``'s on the CPU: the ascending IEEE total order of
the keys (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN), ties to the
lower flat index.  (A stable sort of the float keys would tie -0.0 and
+0.0 and put every NaN last.)  The twins sort the keys' total-order
words; the kernel
(``csrc/select.cu``) finds the cap-th word by a radix select and ranks the
cap words below it, and equals the twin bit for bit.

CPU tensors go to the twins; CUDA tensors launch the kernels (or raise).
``select.launches`` and ``accept.launches`` count the calls that launched
(``faldoi_select`` enqueues up to nine kernels, ``faldoi_accept`` one).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb

INF = float("inf")
# the sort-key bias of a relax-mode re-claim (a fixed pixel's candidate):
# it ranks after every frontier candidate (JAX's RECLAIM_BIAS)
RECLAIM_BIAS = 1.0e6
# relax mode: a claim must beat the energy times this, less 1e-6 (JAX's
# relax_margin, float32)
RELAX_MARGIN = float(np.float32(0.95))
# bytes of faldoi_select's zeroed work buffer a lane: its 64-byte lane
# state and six 2048-bin histograms (csrc/select.cu)
WORK_BYTES_PER_LANE = 64 + 4 * 2048 * 6


class Accepted(NamedTuple):
    band: torch.Tensor       # (L', 1) float32
    floor_dyn: torch.Tensor  # (L', 1) int64
    valid: torch.Tensor      # (L', cap) bool
    order: torch.Tensor      # (L' * cap,) int64: accepted (l * cap + rank) first
    counts: torch.Tensor     # (L',) int64
    total: torch.Tensor      # () int64


def keys_plain(cand_e, fixed, ene, n: int, relax: bool = False, rows=None,
               owned=None):
    """The eligibility keys (L', n) of the lanes ``rows`` (None: all) of
    (L, >= n) planes: a pixel's candidate energy while it is unfixed, +inf
    where it cannot be popped.  Under ``relax`` a pixel is eligible while
    its candidate beats its energy (cand_e < ene * ``RELAX_MARGIN`` - 1e-6),
    and a fixed pixel's key is cand_e + ``RECLAIM_BIAS``.  ``owned`` ((n,)
    bool, optional): +inf outside a row shard's own rows."""
    rows = slice(None) if rows is None else rows
    inf = torch.full((), INF, device=cand_e.device)
    cand_rows = cand_e[rows, :n]
    if relax:
        improving = cand_rows < ene[rows, :n] * RELAX_MARGIN - 1e-6
        key = torch.where(fixed[rows, :n], cand_rows + RECLAIM_BIAS, cand_rows)
        eligible = torch.where(improving, key, inf)
    else:
        eligible = torch.where(fixed[rows, :n], inf, cand_rows)
    if owned is not None:
        eligible = torch.where(owned, eligible, inf)
    return eligible


def total_order(x: torch.Tensor) -> torch.Tensor:
    """int32 words of float32 ``x`` whose signed order is the IEEE total
    order of ``x`` (``lax.top_k(-x)``'s ranking on the CPU)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def select_plain(cand_e, fixed, ene, n: int, bsz: int, relax: bool = False,
                 lanes=None, owned=None):
    """Plain twin of ``select``: a stable sort of the keys' total-order
    words.  Returns (e_pop (L', cap), idx (L', cap) int64, queue (L',)
    int64), cap = min(bsz, n)."""
    eligible = keys_plain(cand_e, fixed, ene, n, relax, lanes, owned)
    _, order = torch.sort(total_order(eligible), dim=1, stable=True)
    idx = order[:, :min(bsz, n)]
    return (eligible.gather(1, idx), idx,
            torch.isfinite(eligible).sum(1))


def select(cand_e, fixed, ene, n: int, bsz: int, relax: bool = False,
           lanes=None, owned=None):
    """K2's first entry point.  ``cand_e``, ``fixed`` (bool) and ``ene``
    (read under ``relax`` only): lane-stacked (L, >= n) planes whose first
    n cells are the image (the sweep's (L, h*w + 1) state planes);
    ``lanes``: None (every lane, in order) or an (L',) int64 tensor of the
    lanes to select for; ``owned``: None or (n,) bool.  Returns (e_pop (L',
    cap) float32, the keys in order; idx (L', cap) int64, their flat
    pixels; queue (L',) int64), cap = min(bsz, n).

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if cand_e.dim() != 2 or fixed.shape != cand_e.shape:
        raise ValueError("cand_e and fixed must be (L, N) planes of one shape")
    if cand_e.shape[1] < n or n < 1 or bsz < 1:
        raise ValueError(f"n {n}, bsz {bsz} for planes {tuple(cand_e.shape)}")
    if cand_e.device.type == "cpu":
        return select_plain(cand_e, fixed, ene, n, bsz, relax, lanes, owned)
    dev = cand_e.device
    nl = cand_e.shape[0] if lanes is None else lanes.shape[0]
    cap = min(bsz, n)
    if n >= 2 ** 31 or nl > 65535:
        raise ValueError(f"{nl} lanes of {n} pixels exceed the kernel's grid")
    kb.require_cuda_tensor(cand_e, "cand_e", torch.float32)
    kb.require_cuda_tensor(fixed, "fixed", torch.bool, dev)
    if relax:
        kb.require_cuda_tensor(ene, "ene", torch.float32, dev,
                               tuple(cand_e.shape))
    if lanes is not None:
        kb.require_cuda_tensor(lanes, "lanes", torch.int64, dev, (nl,))
    if owned is not None:
        kb.require_cuda_tensor(owned, "owned", torch.bool, dev, (n,))
    words = torch.empty((nl, n), dtype=torch.int32, device=dev)
    cand = torch.empty((nl, cap), dtype=torch.int64, device=dev)
    work = torch.empty((nl * WORK_BYTES_PER_LANE,), dtype=torch.uint8,
                       device=dev)
    e_pop = torch.empty((nl, cap), dtype=torch.float32, device=dev)
    idx = torch.empty((nl, cap), dtype=torch.int64, device=dev)
    queue = torch.empty((nl,), dtype=torch.int64, device=dev)
    code = kb.library().faldoi_select(
        cand_e.data_ptr(), fixed.data_ptr(), ene.data_ptr() if relax else None,
        None if owned is None else owned.data_ptr(),
        None if lanes is None else lanes.data_ptr(), cand_e.stride(0),
        int(bool(relax)), RELAX_MARGIN, RECLAIM_BIAS, words.data_ptr(),
        cand.data_ptr(), work.data_ptr(), e_pop.data_ptr(), idx.data_ptr(),
        queue.data_ptr(), nl, n, cap, kb.stream_ptr(dev))
    kb.check(code, "select")
    select.launches += 1
    return e_pop, idx, queue


select.launches = 0   # calls that launched K2's selection


def band_floor_plain(e_pop, queue, delta: float, delta_rel: float,
                     floor: int, floor_scale: int, floor_scale_hi: int = 0,
                     queue_hi: int = 1 << 30, band_min=None):
    """Each lane's delta band e_min + max(delta, delta_rel * e_min) (e_min
    the lane's first key, or ``band_min`` (L', 1)), the keys in it, and the
    rank floor min(floor, max(1, queue // fscale)), the divisor
    ``floor_scale_hi`` once the queue reaches ``queue_hi`` (if > 0) and
    ``floor_scale`` before (a divisor of 1 or less: the floor itself).
    Returns (band (L', 1), e_ok (L', cap), floor_dyn (L', 1))."""
    e_min = e_pop[:, :1] if band_min is None else band_min
    band = e_min + torch.clamp(delta_rel * e_min, min=delta)
    q = queue.view(-1, 1)
    floor_base = max(int(floor), 1)
    fscale = torch.full_like(q, max(int(floor_scale), 1))
    if floor_scale_hi > 0:
        fscale = torch.where(q >= queue_hi, int(floor_scale_hi), fscale)
    floor_dyn = torch.where(fscale > 1, (q // fscale).clamp(1, floor_base),
                            floor_base)
    return band, e_pop <= band, floor_dyn


def accept_plain(e_pop, queue, delta: float, delta_rel: float, floor: int,
                 floor_scale: int, floor_scale_hi: int = 0,
                 queue_hi: int = 1 << 30, band_min=None,
                 valid=None) -> Accepted:
    """Plain twin of ``accept``."""
    band, e_ok, floor_dyn = band_floor_plain(
        e_pop, queue, delta, delta_rel, floor, floor_scale, floor_scale_hi,
        queue_hi, band_min)
    if valid is None:
        rank = torch.arange(e_pop.shape[1], device=e_pop.device)
        valid = torch.isfinite(e_pop) & (e_ok | (rank < floor_dyn))
    vflat = valid.reshape(-1)
    counts = valid.sum(1)
    total = counts.sum()
    before = vflat.cumsum(0) - vflat.to(torch.int64)
    f = torch.arange(vflat.shape[0], device=e_pop.device)
    dest = torch.where(vflat, before, total + f - before)
    order = torch.empty_like(f).scatter_(0, dest, f)
    return Accepted(band, floor_dyn, valid, order, counts, total)


def accept(e_pop, queue, delta: float, delta_rel: float, floor: int,
           floor_scale: int, floor_scale_hi: int = 0, queue_hi: int = 1 << 30,
           band_min=None, valid=None) -> Accepted:
    """K2's second entry point, on ``select``'s e_pop (L', cap) and queue
    (L',): the band, the floor and the accepted mask valid = finite &
    (key <= band | rank < floor) (``band_floor_plain``'s rules; ``valid``
    (L', cap) bool: the ordering modes' mask in its place), then the
    compaction: ``order`` lists the flat (lane * cap + rank) entries, the
    accepted ones first, lane-major in rank order, then the others in the
    same order; each lane's count and the total (a 0-dim tensor).
    ``delta`` is a float32 value; ``band_min`` None or (L', 1) float32.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if e_pop.dim() != 2 or tuple(queue.shape) != (e_pop.shape[0],):
        raise ValueError(f"e_pop {tuple(e_pop.shape)} and queue "
                         f"{tuple(queue.shape)}: expected (L', cap), (L',)")
    if e_pop.device.type == "cpu":
        return accept_plain(e_pop, queue, delta, delta_rel, floor, floor_scale,
                            floor_scale_hi, queue_hi, band_min, valid)
    dev = e_pop.device
    nl, cap = e_pop.shape
    kb.require_cuda_tensor(e_pop, "e_pop", torch.float32)
    kb.require_cuda_tensor(queue, "queue", torch.int64, dev)
    if band_min is not None:
        band_min = band_min.reshape(-1).contiguous()
        kb.require_cuda_tensor(band_min, "band_min", torch.float32, dev, (nl,))
    if valid is not None:
        valid = valid.contiguous()
        kb.require_cuda_tensor(valid, "valid", torch.bool, dev, (nl, cap))
    band = torch.empty((nl, 1), dtype=torch.float32, device=dev)
    floor_dyn = torch.empty((nl, 1), dtype=torch.int64, device=dev)
    valid_out = torch.empty((nl, cap), dtype=torch.bool, device=dev)
    order = torch.empty((nl * cap,), dtype=torch.int64, device=dev)
    counts = torch.empty((nl,), dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    code = kb.library().faldoi_accept(
        e_pop.data_ptr(), queue.data_ptr(),
        None if band_min is None else band_min.data_ptr(),
        None if valid is None else valid.data_ptr(), float(np.float32(delta)),
        float(np.float32(delta_rel)), max(int(floor), 1),
        max(int(floor_scale), 1), int(floor_scale_hi), int(queue_hi),
        band.data_ptr(), floor_dyn.data_ptr(), valid_out.data_ptr(),
        order.data_ptr(), counts.data_ptr(), total.data_ptr(), nl, cap,
        kb.stream_ptr(dev))
    kb.check(code, "accept")
    accept.launches += 1
    return Accepted(band, floor_dyn, valid_out, order, counts, total)


accept.launches = 0   # calls that launched K2's acceptance

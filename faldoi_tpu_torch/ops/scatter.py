"""Payload scatters of the growing's sweep — kernel K3 and its plain twins.

Counterpart of ``faldoi_tpu/core/local_step.py:174`` ``_scatter_min_payload``
and ``:192`` ``_scatter_max_payload`` in its exact form: each slot keeps the
minimum (maximum) key over its current key and its updates where ``ok``,
and the winning update's payload.  The sweep's uses (``local_step``): the
4-neighbour candidates and the same-sweep donations (min), the centre
update (a min whose updates already beat their target), the working flow
over every in-box cell of every solved patch (max, ``wflow_scatter``), and
the seed insertion's candidates and working flow; method 8's chi rides as a
third payload.

Ties, which JAX leaves to the backend, as XLA's sequential CPU scatter
resolves them: among a slot's winners the LAST update in JAX's flattening
order writes the payload (``pos``: d*K + b for the neighbour candidates,
(r*p + c)*K + b for the working flow), the slot's current key takes part
and an update equal to it wins; -0.0 and +0.0 tie.  A NaN key, the slot's
or an update's, makes the slot's key NaN and writes no payload (the
reductions propagate NaN, as XLA's min and max do, and nothing compares <=
NaN).  The key plane takes the winner's key.  Masked updates go to their
lane's dump slot in the twins and nowhere in the kernel: the dump slot's
payload is unspecified (its key stays).

CPU tensors go to the twins; CUDA tensors launch the kernel
(``csrc/scatter.cu``: a 64-bit slot word of (key order, position), three
launches a call) or raise.  ``scatter_payload.launches`` counts the generic
form's calls (min and max), ``wflow_scatter.launches`` the working-flow
form's.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.stencils import canvas_ids

INF = float("inf")


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


def _dumps(q, dump):
    """The dump slot of every update: ``dump`` itself where it is a tensor
    (one slot an update: each lane's own), else ``dump`` everywhere."""
    return dump if isinstance(dump, torch.Tensor) else torch.full_like(q, dump)


def _scatter_plain(is_min, tgt_key, tgt_u, tgt_v, q, key, u, v, ok, dump, pos,
                   tgt_c, c):
    dumps = _dumps(q, dump)
    qs = torch.where(ok, q, dumps)
    k_m = torch.where(ok, key, torch.full_like(key, INF if is_min else -INF))
    red = tgt_key.scatter_reduce(0, qs, k_m, "amin" if is_min else "amax",
                                 include_self=True)
    winner = ok & ((k_m <= red[qs]) if is_min else (k_m >= red[qs]))
    sel = _last_winner(qs, winner, _positions(q, pos), red.shape[0])
    qw = torch.where(sel, q, dumps)
    # the key plane takes the winner's key; the dump slot keeps its own
    tgts, vals = (red, tgt_u, tgt_v), (torch.where(sel, key, red[dumps]), u, v)
    if tgt_c is not None:
        tgts, vals = tgts + (tgt_c,), vals + (c,)
    return tuple(t.index_put((qw,), x) for t, x in zip(tgts, vals))


def scatter_min_payload_plain(tgt_e, tgt_u, tgt_v, q, e, u, v, ok, dump,
                              pos=None, tgt_c=None, c=None):
    """Plain twin of ``scatter_min_payload``."""
    return _scatter_plain(True, tgt_e, tgt_u, tgt_v, q, e, u, v, ok, dump,
                          pos, tgt_c, c)


def scatter_max_payload_plain(key_buf, tgt_u, tgt_v, q, key, u, v, ok, dump,
                              pos=None, tgt_c=None, c=None):
    """Plain twin of ``scatter_max_payload``."""
    return _scatter_plain(False, key_buf, tgt_u, tgt_v, q, key, u, v, ok,
                          dump, pos, tgt_c, c)


def _f32(t, name, m, dev):
    t = t.contiguous()
    kb.require_cuda_tensor(t, name, torch.float32, dev, (m,))
    return t


def scatter_payload(is_min: bool, tgt_key, tgt_u, tgt_v, q, key, u, v, ok,
                    dump, pos=None, tgt_c=None, c=None):
    """K3, generic form: scatter (key, u, v[, c]) to the slots ``q`` where
    ``ok``, keeping per slot the minimum (``is_min``) or maximum key and the
    winner's payload (the module's rules).  ``tgt_*``: flat float32 planes
    (returned as new tensors: key plane, u, v[, c]); ``q`` (m,) int64;
    ``key``, ``u``, ``v``, ``c`` (m,) float32; ``ok`` (m,) bool; ``dump``:
    the slot masked updates go to in the twin, an int or one an update;
    ``pos`` (m,) int64 orders tied winners (default: the update order)."""
    if q.dim() != 1:
        raise ValueError(f"q must be a (m,) vector, got {tuple(q.shape)}")
    if (tgt_c is None) != (c is None):
        raise ValueError("tgt_c and c go together")
    if tgt_key.device.type == "cpu":
        return _scatter_plain(is_min, tgt_key, tgt_u, tgt_v, q, key, u, v, ok,
                              dump, pos, tgt_c, c)
    dev = tgt_key.device
    m = q.shape[0]
    size = tgt_key.shape
    outs = [t.contiguous().clone() for t in
            (tgt_key, tgt_u, tgt_v) + ((tgt_c,) if tgt_c is not None else ())]
    for name, t in zip(("tgt_key", "tgt_u", "tgt_v", "tgt_c"), outs):
        kb.require_cuda_tensor(t, name, torch.float32, dev, size)
    if len(size) != 1:
        raise ValueError(f"the target planes must be flat, got {tuple(size)}")
    q = q.contiguous()
    kb.require_cuda_tensor(q, "q", torch.int64, dev, (m,))
    ok = ok.contiguous()
    kb.require_cuda_tensor(ok, "ok", torch.bool, dev, (m,))
    vals = [_f32(t, n, m, dev) for n, t in
            (("key", key), ("u", u), ("v", v)) + ((("c", c),) if c is not None
                                                  else ())]
    if pos is not None:
        pos = pos.contiguous()
        kb.require_cuda_tensor(pos, "pos", torch.int64, dev, (m,))
    words = torch.empty(size, dtype=torch.int64, device=dev)
    if m:
        code = kb.library().faldoi_scatter_payload(
            int(bool(is_min)), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), outs[3].data_ptr() if c is not None else None,
            q.data_ptr(), vals[0].data_ptr(), ok.data_ptr(),
            None if pos is None else pos.data_ptr(), vals[1].data_ptr(),
            vals[2].data_ptr(), vals[3].data_ptr() if c is not None else None,
            words.data_ptr(), m, kb.stream_ptr(dev))
        kb.check(code, "scatter_payload")
        scatter_payload.launches += 1
    return tuple(outs)


scatter_payload.launches = 0   # generic-form calls that launched


def scatter_min_payload(tgt_e, tgt_u, tgt_v, q, e, u, v, ok, dump, pos=None,
                        tgt_c=None, c=None):
    """Scatter (e, u, v) to q where ok, keeping per slot the minimum e
    (``_scatter_min_payload``).  ``dump``: the slot masked updates go to, an
    int or one slot an update.  ``pos`` orders tied winners (default: the
    update order).  With ``tgt_c`` and ``c`` (method 8's chi) the winner's c
    goes to tgt_c as well, and the result has it fourth."""
    return scatter_payload(True, tgt_e, tgt_u, tgt_v, q, e, u, v, ok, dump,
                           pos, tgt_c, c)


def scatter_max_payload(key_buf, tgt_u, tgt_v, q, key, u, v, ok, dump,
                        pos=None, tgt_c=None, c=None):
    """Scatter (u, v) to q where ok, keeping the payload of the maximum key
    (``_scatter_max_payload`` in its exact form); ``dump``, ``tgt_c``, ``c``
    as in ``scatter_min_payload``."""
    return scatter_payload(False, key_buf, tgt_u, tgt_v, q, key, u, v, ok,
                           dump, pos, tgt_c, c)


def wflow_scatter_plain(wu, wv, wchi, su, sv, schi, ener, oy, ox, inbox, h, w,
                        p, base=None):
    """Plain twin of ``wflow_scatter``."""
    n = h * w
    k = su.shape[0]
    rows, cols = canvas_ids(p, su.device)
    gy = oy[:, None, None] + rows
    gx = ox[:, None, None] + cols
    flat_q = torch.where(inbox, gy * w + gx, torch.full_like(gy, n))
    dump = n
    if base is not None:
        flat_q = base[:, None, None] + flat_q
        dump = (base + n)[:, None, None].expand(k, p, p).reshape(-1)
    key = ener[:, None, None].expand(k, p, p)
    bidx = torch.arange(k, device=su.device)[:, None, None]
    pos = (rows * p + cols) * k + bidx          # JAX order: cell-major
    key_buf = torch.full(wu.shape, -INF, dtype=torch.float32, device=su.device)
    out = scatter_max_payload_plain(
        key_buf, wu, wv, flat_q.reshape(-1), key.reshape(-1), su.reshape(-1),
        sv.reshape(-1), inbox.reshape(-1), dump, pos.reshape(-1),
        **({} if schi is None else dict(tgt_c=wchi, c=schi.reshape(-1))))
    return out[1], out[2], out[3] if schi is not None else wchi, out[0]


def wflow_scatter(wu, wv, wchi, su, sv, schi, ener, oy, ox, inbox, h, w, p,
                  base=None):
    """K3, working-flow form: the max-energy-wins scatter of K patches'
    (p, p) canvases ``su``, ``sv`` (and method 8's ``schi``, or None) over
    every cell where ``inbox`` ((K, p, p) bool) into the flat planes ``wu``,
    ``wv`` (``wchi``): one lane's (h*w+1,), or L lanes' flattened, with
    ``base`` ((K,) int64) each patch's lane times h*w + 1.  A cell's slot is
    (oy + r) * w + ox + c, its key the patch's ``ener`` and its position
    (r*p + c)*K + b.  Returns (wu, wv, wchi, the key plane: each slot's
    winning energy, -inf where no cell landed), new tensors."""
    k = su.shape[0]
    if tuple(su.shape) != (k, p, p) or tuple(inbox.shape) != (k, p, p):
        raise ValueError(f"su {tuple(su.shape)}, inbox {tuple(inbox.shape)}: "
                         f"expected ({k}, {p}, {p})")
    if wu.device.type == "cpu":
        return wflow_scatter_plain(wu, wv, wchi, su, sv, schi, ener, oy, ox,
                                   inbox, h, w, p, base)
    dev = wu.device
    size = wu.shape
    if len(size) != 1:
        raise ValueError(f"the target planes must be flat, got {tuple(size)}")
    outs = [t.contiguous().clone() for t in
            (wu, wv) + ((wchi,) if schi is not None else ())]
    for name, t in zip(("wu", "wv", "wchi"), outs):
        kb.require_cuda_tensor(t, name, torch.float32, dev, size)
    cans = [t.contiguous() for t in (su, sv) + ((schi,) if schi is not None
                                                 else ())]
    for name, t in zip(("su", "sv", "schi"), cans):
        kb.require_cuda_tensor(t, name, torch.float32, dev, (k, p, p))
    ener = _f32(ener, "ener", k, dev)
    oy, ox = oy.contiguous(), ox.contiguous()
    kb.require_cuda_tensor(oy, "oy", torch.int64, dev, (k,))
    kb.require_cuda_tensor(ox, "ox", torch.int64, dev, (k,))
    inbox = inbox.contiguous()
    kb.require_cuda_tensor(inbox, "inbox", torch.bool, dev, (k, p, p))
    if base is not None:
        base = base.contiguous()
        kb.require_cuda_tensor(base, "base", torch.int64, dev, (k,))
    key_buf = torch.full(size, -INF, dtype=torch.float32, device=dev)
    words = torch.empty(size, dtype=torch.int64, device=dev)
    if k:
        code = kb.library().faldoi_wflow_scatter(
            key_buf.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if schi is not None else None,
            cans[0].data_ptr(), cans[1].data_ptr(),
            cans[2].data_ptr() if schi is not None else None, ener.data_ptr(),
            oy.data_ptr(), ox.data_ptr(), inbox.data_ptr(),
            None if base is None else base.data_ptr(), words.data_ptr(), w, k,
            p, kb.stream_ptr(dev))
        kb.check(code, "wflow_scatter")
        wflow_scatter.launches += 1
    return (outs[0], outs[1], outs[2] if schi is not None else wchi, key_buf)


wflow_scatter.launches = 0   # working-flow-form calls that launched

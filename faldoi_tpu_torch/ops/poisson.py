"""Batched Poisson/harmonic hole filling on fixed-size patch canvases.

Port of ``faldoi_tpu/ops/poisson.py::poisson_fill_canvas`` (the reference's
``src/elap_recsep.c``, called by ``interpolate_poisson`` with timestep 0.4,
niter 3, scale 7): a coarse-to-fine pyramid where each level fills the NaN
holes by relaxation of the Laplace equation, initialised from the coarser
level (NaN-discarding 2x2 block averages down, pixel replication up).

It runs on B canvases at once: ``x`` is (B, P, P) with per-canvas valid boxes
``[0, ph) x [0, pw)``.  Two relaxation modes, as in JAX:

* ``exact=True``: raster-order Gauss-Seidel, computed exactly as anti-diagonal
  wavefronts (cell (r, c) reads the updated (r-1, c), (r, c-1) on diagonal
  r+c-1 and the old (r+1, c), (r, c+1)); ``seed_batch`` uses it at p = 3,
  and the sweep of methods 4-7 at p = 11;
* ``exact=False``: red-black Gauss-Seidel, which the sweep of the other
  methods uses.

The canvas fill is kernel K13 (``csrc/poisson_fill.cu``): one launch fills
every canvas of one or two planes that share their boxes
(``poisson_fill_planes``: the u and v canvases of a sweep or of a seed
insertion), the whole pyramid of a canvas in shared memory; its plain twin
is ``poisson_fill_canvas_plain``.

Also the whole-image fills of ``faldoi_tpu/ops/poisson.py``: the
rectangular multigrid ``poisson_fill_image`` (plain torch, on no path), and
``nearest_fill_image``, the growing's dense fill (``fill="dense"``): the
jump-flood nearest fill, kernel K10 (``csrc/dense_fill.cu``), with its plain
twin ``nearest_fill_image_plain``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.stencils import canvas_ids


def _level_sizes(p: int, scale: int):
    sizes = [p]
    for _ in range(scale - 1):
        if sizes[-1] == 1:
            break  # 1x1 levels are exact no-ops (clamped laplacian = 0)
        sizes.append(max(1, math.ceil(sizes[-1] / 2)))
    return sizes


def _neighbour_index(ph, pw, p):
    """Flat canvas indices (B, 4 * P * P) of each cell's right, left, down
    and up neighbour as ``getpixel_1`` reads them: the cell itself where the
    neighbour leaves the valid box [0, ph) x [0, pw) (the left and up
    neighbours leave it only at column or row 0).  ph, pw: (B, 1, 1)."""
    rows, cols = canvas_ids(p, ph.device)
    cell = rows * p + cols
    right = torch.where(cols + 1 < pw, cell + 1, cell)
    left = torch.where(cols - 1 >= 0, cell - 1, cell).expand_as(right)
    down = torch.where(rows + 1 < ph, cell + p, cell)
    up = torch.where(rows - 1 >= 0, cell - p, cell).expand_as(down)
    return torch.stack([right, left, down.expand_as(right),
                        up.expand_as(right)], dim=1).reshape(ph.shape[0], -1)


def _laplacian(y, nbr):
    """-4 y + the four getpixel_1 neighbours (``_neighbour_index``), summed
    right, left, down, up."""
    b, p = y.shape[0], y.shape[-1]
    n = torch.gather(y.reshape(b, p * p), 1, nbr).view(b, 4, p, p)
    return -4.0 * y + n[:, 0] + n[:, 1] + n[:, 2] + n[:, 3]


def _relax(y, hole, ph, pw, timestep, niter, p, exact):
    """Gauss-Seidel relaxation of the holes on the valid box
    (``perform_one_iteration``, elap_recsep.c:49-68)."""
    rows, cols = canvas_ids(p, y.device)
    inbox = (rows < ph) & (cols < pw)
    diag = rows + cols
    upd = hole & inbox
    nbr = _neighbour_index(ph, pw, p)
    if not exact:
        red = upd & (diag % 2 == 0)
        for _ in range(niter):
            for mask in (red, upd & ~red):
                y = torch.where(mask, y + timestep * _laplacian(y, nbr), y)
        return y
    fronts = upd[None] & (diag == torch.arange(2 * p - 1, device=y.device)
                          .view(-1, 1, 1, 1))
    for _ in range(niter):
        for d in range(2 * p - 1):
            y = torch.where(fronts[d], y + timestep * _laplacian(y, nbr), y)
    return y


def _zoom_out2(x, ph, pw, p_parent, p_child):
    """NaN-discarding 2x2 block average (elap_recsep.c:129-185)."""
    rows, cols = canvas_ids(p_parent, x.device)
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    x = torch.where((rows < ph) & (cols < pw), x, nan)
    pad = 2 * p_child - p_parent
    if pad:
        x = torch.nn.functional.pad(x, (0, pad, 0, pad), value=float("nan"))
    blocks = (x[:, 0::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 0::2],
              x[:, 1::2, 1::2])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.zeros_like(blocks[0])
    cnt = torch.zeros(blocks[0].shape, dtype=torch.int32, device=x.device)
    for b in blocks:
        fin = torch.isfinite(b)
        cnt = cnt + fin.to(torch.int32)
        s = s + torch.where(fin, b, zero)
    return torch.where(cnt > 0, s / cnt.clamp(min=1).to(x.dtype), nan)


def _zoom_in2(x, p_parent):
    """Pixel replication into 2x2 blocks (elap_recsep.c:191-199)."""
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return up[:, :p_parent, :p_parent]


def poisson_fill_canvas_plain(x: torch.Tensor, ph: torch.Tensor,
                              pw: torch.Tensor, timestep: float = 0.4,
                              niter: int = 3, scale: int = 7,
                              exact: bool = True) -> torch.Tensor:
    """Plain twin of K13: fill the NaNs of B (P, P) canvases whose valid
    regions are [0, ph) x [0, pw).  ``x``: (B, P, P); ``ph``, ``pw``: (B,)
    ints.  Values outside the valid box come back as 0."""
    p = x.shape[-1]
    sizes = _level_sizes(p, scale)
    levels = [x]
    phs = [ph[:, None, None]]
    pws = [pw[:, None, None]]
    for k in range(1, len(sizes)):
        levels.append(_zoom_out2(levels[-1], phs[-1], pws[-1], sizes[k - 1],
                                 sizes[k]))
        phs.append((phs[-1] + 1) // 2)
        pws.append((pws[-1] + 1) // 2)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = None
    for k in range(len(sizes) - 1, -1, -1):
        xk = levels[k]
        init = torch.zeros_like(xk) if out is None else _zoom_in2(out, sizes[k])
        rows, cols = canvas_ids(sizes[k], x.device)
        inbox = (rows < phs[k]) & (cols < pws[k])
        hole = ~torch.isfinite(xk)
        y = torch.where(inbox, torch.where(hole, init, xk), zero)
        y = torch.where(torch.isfinite(y), y, zero)
        out = _relax(y, hole, phs[k], pws[k], timestep, niter, sizes[k], exact)
    return out


def poisson_fill_args(planes, ph, pw, timestep, niter, scale, exact):
    """K13's C arguments (all but the stream) for one or two CUDA planes of
    the same (B, P, P) shape, checked as ``poisson_fill_planes`` checks
    them: returns (args or None for B 0, the allocated outputs, what must
    stay alive until the launch is enqueued).  ``cli/patch_variants.py``
    launches the former form and the variants with the same arguments."""
    x, n = planes[0], len(planes)
    b, p, dev = x.shape[0], x.shape[1], x.device
    for k, t in enumerate(planes):
        kb.require_cuda_tensor(t, f"plane {k}", torch.float32, dev)
    boxes = [kb.int64_vector(t, name, b, dev) for name, t in
             (("ph", ph), ("pw", pw))]
    outs = tuple(torch.empty_like(t) for t in planes)
    if b == 0:
        return None, outs, ()
    sides = _level_sizes(p, scale)
    c_sides = (ctypes.c_int * len(sides))(*sides)
    args = (x.data_ptr(), planes[-1].data_ptr() if n > 1 else None,
            outs[0].data_ptr(), outs[-1].data_ptr() if n > 1 else None,
            boxes[0].data_ptr(), boxes[1].data_ptr(), b, n, p, c_sides,
            len(sides), float(timestep), int(niter), int(bool(exact)))
    return args, outs, (boxes, c_sides)


def poisson_fill_planes(planes, ph: torch.Tensor, pw: torch.Tensor,
                        timestep: float = 0.4, niter: int = 3, scale: int = 7,
                        exact: bool = True):
    """K13: ``poisson_fill_canvas`` of one or two planes of B (P, P) float32
    canvases that share their (B,) boxes ``ph``, ``pw`` (the u and v
    canvases of a sweep), in one launch.  Returns a tuple of filled planes,
    each zero outside its boxes; the inputs are not changed.  P * P <= 1024.

    CPU tensors go to the plain twin (the planes as one batch); CUDA tensors
    launch the kernel (or raise).  ``launches`` counts launches."""
    planes = tuple(planes)
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"{len(planes)} planes: K13 takes one or two")
    x = planes[0]
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"canvases must be (B, P, P), got {tuple(x.shape)}")
    b, p = x.shape[0], x.shape[1]
    kb.check_canvas_side(p, "poisson_fill_planes")
    for t in planes[1:]:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"plane {tuple(t.shape)} on {t.device}: expected "
                             f"{tuple(x.shape)} on {x.device}")
    n = len(planes)
    if x.device.type == "cpu":
        for name, t in (("ph", ph), ("pw", pw)):
            if tuple(t.shape) != (b,):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                                 f"({b},)")
        both = torch.cat(planes) if n > 1 else x
        f = poisson_fill_canvas_plain(both, ph.repeat(n), pw.repeat(n),
                                      timestep, niter, scale, exact)
        return tuple(f.split(b)) if n > 1 else (f,)
    args, outs, _keep = poisson_fill_args(planes, ph, pw, timestep, niter,
                                          scale, exact)
    if args is None:
        return outs
    code = kb.library().faldoi_poisson_fill(*args, kb.stream_ptr(x.device))
    kb.check(code, "poisson_fill_planes")
    poisson_fill_planes.launches += 1
    return outs


poisson_fill_planes.launches = 0   # K13 launches, raised after a launch


def poisson_fill_canvas(x: torch.Tensor, ph: torch.Tensor, pw: torch.Tensor,
                        timestep: float = 0.4, niter: int = 3, scale: int = 7,
                        exact: bool = True) -> torch.Tensor:
    """Fill the NaNs of B (P, P) canvases whose valid regions are
    [0, ph) x [0, pw): K13 on one plane (``poisson_fill_planes``).  ``x``:
    (B, P, P); ``ph``, ``pw``: (B,) ints.  Values outside the valid box come
    back as 0."""
    return poisson_fill_planes((x,), ph, pw, timestep, niter, scale, exact)[0]


def poisson_fill_batch(x: torch.Tensor, ph: torch.Tensor, pw: torch.Tensor,
                       timestep: float = 0.4, niter: int = 3, scale: int = 7,
                       exact: bool = True) -> torch.Tensor:
    """``poisson_fill_canvas`` over a (B, P, P) batch with (B,) boxes (JAX's
    ``poisson_fill_batch``, a vmap of the one-canvas fill; here the canvas
    fill is batched already)."""
    return poisson_fill_canvas(x, ph, pw, timestep, niter, scale, exact)


def _rect_level_sizes(py: int, px: int, scale: int):
    sizes = [(py, px)]
    for _ in range(scale - 1):
        if max(sizes[-1]) == 1:
            break
        sizes.append((max(1, math.ceil(sizes[-1][0] / 2)),
                      max(1, math.ceil(sizes[-1][1] / 2))))
    return sizes


def _rect_zoom_out2(x, child):
    """NaN-discarding 2x2 block average of (..., y, x) onto (..., cy, cx)."""
    cy, cx = child
    pad_y, pad_x = 2 * cy - x.shape[-2], 2 * cx - x.shape[-1]
    if pad_y or pad_x:
        x = torch.nn.functional.pad(x, (0, pad_x, 0, pad_y), value=float("nan"))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.zeros_like(x[..., 0::2, 0::2])
    cnt = torch.zeros(s.shape, dtype=torch.int32, device=x.device)
    for b in (x[..., 0::2, 0::2], x[..., 0::2, 1::2], x[..., 1::2, 0::2],
              x[..., 1::2, 1::2]):
        fin = torch.isfinite(b)
        cnt = cnt + fin.to(torch.int32)
        s = s + torch.where(fin, b, zero)
    return torch.where(cnt > 0, s / cnt.clamp(min=1).to(x.dtype),
                       torch.full((), float("nan"), dtype=x.dtype,
                                  device=x.device))


def _rect_relax(y, hole, timestep, niter):
    """Red-black Gauss-Seidel of the holes of full (..., py, px) canvases
    with Neumann (clamped) edges, red = (row + col) even first; the
    Laplacian summed right, left, down, up after -4 y."""
    py, px = y.shape[-2:]
    rows = torch.arange(py, device=y.device)[:, None]
    cols = torch.arange(px, device=y.device)[None, :]
    red = (rows + cols) % 2 == 0

    def lap(a):
        right = torch.cat([a[..., 1:], a[..., -1:]], -1)
        left = torch.cat([a[..., :1], a[..., :-1]], -1)
        down = torch.cat([a[..., 1:, :], a[..., -1:, :]], -2)
        up = torch.cat([a[..., :1, :], a[..., :-1, :]], -2)
        return -4.0 * a + right + left + down + up

    for _ in range(niter):
        for color in (red, ~red):
            y = torch.where(hole & color, y + timestep * lap(y), y)
    return y


def poisson_fill_image(x: torch.Tensor, timestep: float = 0.4, niter: int = 3,
                       scale: int = 0) -> torch.Tensor:
    """Whole-image NaN fill of an (h, w) image with the patch fill's
    coarse-to-fine multigrid on rectangular levels (JAX's
    ``poisson_fill_image``); ``scale=0``: levels down to 1x1."""
    h, w = x.shape[-2:]
    if not scale:
        scale = max(h, w).bit_length() + 1
    sizes = _rect_level_sizes(h, w, scale)
    levels = [x]
    for k in range(1, len(sizes)):
        levels.append(_rect_zoom_out2(levels[-1], sizes[k]))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = None
    for k in range(len(sizes) - 1, -1, -1):
        xk = levels[k]
        if out is None:
            init = torch.zeros_like(xk)
        else:
            up = out.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            init = up[..., :sizes[k][0], :sizes[k][1]]
        hole = ~torch.isfinite(xk)
        y = torch.where(hole, init, xk)
        y = torch.where(torch.isfinite(y), y, zero)
        out = _rect_relax(y, hole, timestep, niter)
    return out


# the far state of the jump flood's empty cells, JAX's (-1e6, -1e6)
_FAR = -1.0e6


def flood_strides(h: int, w: int):
    """The jump flood's strides: the largest power of two k with 2k <
    max(h, w), halved down to 1."""
    k = 1
    while k * 2 < max(h, w):
        k *= 2
    out = []
    while k >= 1:
        out.append(k)
        k //= 2
    return out


def nearest_fill_image_plain(x: torch.Tensor, smooth_iters: int = 6,
                             timestep: float = 0.4) -> torch.Tensor:
    """Plain twin of K10 on (L, C, h, w) planes: the jump flood of plane 0's
    finite cells (each cell's nearest finite cell as a flat index, -1 for
    none yet), the 8 directions of a stride in JAX's order, each reading the
    previous one's state; the holes then take their nearest cell's values
    (0 with none) and get ``smooth_iters`` pinned red-black sweeps."""
    nl, c, h, w = x.shape
    dev = x.device
    fin = torch.isfinite(x[:, 0])
    cell = torch.arange(h * w, device=dev).view(h, w)
    seed = torch.where(fin, cell, torch.full((), -1, device=dev))
    inf = torch.full((), float("inf"), device=dev)
    best = torch.where(fin, torch.zeros((), device=dev), inf)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    far = torch.full((), _FAR, device=dev)
    ri, ci = torch.arange(h, device=dev), torch.arange(w, device=dev)
    for k in flood_strides(h, w):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                nb = (seed.index_select(1, (ri - dy).clamp(0, h - 1))
                      .index_select(2, (ci - dx).clamp(0, w - 1)))
                real = nb >= 0
                ey = yy - torch.where(real, (nb // w).to(torch.float32), far)
                ex = xx - torch.where(real, (nb % w).to(torch.float32), far)
                d2 = ey * ey + ex * ex
                better = d2 < best
                best = torch.where(better, d2, best)
                seed = torch.where(better, nb, seed)
    flat = x.reshape(nl, c, h * w)
    take = flat.gather(2, seed.clamp(min=0).view(nl, 1, h * w).expand(nl, c, -1))
    take = torch.where(seed.view(nl, 1, h * w) >= 0, take,
                       torch.zeros((), device=dev)).view(nl, c, h, w)
    y = torch.where(fin[:, None], x, take)
    return _rect_relax(y, ~fin[:, None], timestep, smooth_iters)


def nearest_fill_image(x: torch.Tensor, smooth_iters: int = 6,
                       timestep: float = 0.4, check: bool = True) -> torch.Tensor:
    """K10: whole-image NaN fill by nearest-finite-cell extension (jump
    flooding) plus ``smooth_iters`` pinned red-black relaxation sweeps
    (JAX's ``ops/poisson.py::nearest_fill_image``, the dense fill of the
    growing), in one cooperative launch.  ``x``: (h, w), (C, h, w) or (L,
    C, h, w) float32; the C planes of a lane must be finite on one set (u
    and v of the fixed flow), which is checked (one host read on the card;
    ``check=False`` skips it, as a CUDA graph capture must); one flood
    serves them all.  Returns x's shape.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise)."""
    if not 2 <= x.dim() <= 4:
        raise ValueError(f"x must be (h, w), (C, h, w) or (L, C, h, w), got "
                         f"{tuple(x.shape)}")
    shape = x.shape
    x4 = x.reshape((1,) * (4 - x.dim()) + tuple(shape))
    nl, c, h, w = x4.shape
    if c > 1 and check:
        fin = torch.isfinite(x4)
        if not torch.equal(fin, fin[:, :1].expand_as(fin)):
            raise ValueError("the planes of a lane must be finite on the same "
                             "cells")
    if x.device.type == "cpu":
        return nearest_fill_image_plain(x4, smooth_iters, timestep).reshape(shape)
    kb.require_cuda_tensor(x4, "x", torch.float32)
    if h >= 1 << 15 or w >= 1 << 16 or nl * h * w >= 1 << 31:
        raise ValueError(f"K10 packs a seed's (y, x) into 16 bits each and "
                         f"indexes cells in 32 bits: h < 32768, w < 65536 and "
                         f"fewer than 2^31 cells, got {nl} x {h}x{w}")
    out = torch.empty_like(x4)
    if out.numel() == 0:
        return out.reshape(shape)
    seeds = torch.empty((2, nl, h, w), dtype=torch.int32, device=x.device)
    code = kb.library().faldoi_dense_fill(
        x4.data_ptr(), out.data_ptr(), seeds[0].data_ptr(), seeds[1].data_ptr(),
        nl, c, h, w, smooth_iters, timestep, kb.stream_ptr(x.device))
    kb.check(code, "nearest_fill_image")
    nearest_fill_image.launches += 1
    return out.reshape(shape)


nearest_fill_image.launches = 0   # launches of K10, one a fill of all lanes

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
  r+c-1 and the old (r+1, c), (r, c+1)); ``seed_batch`` uses it at p = 3;
* ``exact=False``: red-black Gauss-Seidel, which the sweep uses
  (``fill="patch_rb"``).
"""

from __future__ import annotations

import math

import torch

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


def poisson_fill_canvas(x: torch.Tensor, ph: torch.Tensor, pw: torch.Tensor,
                        timestep: float = 0.4, niter: int = 3, scale: int = 7,
                        exact: bool = True) -> torch.Tensor:
    """Fill the NaNs of B (P, P) canvases whose valid regions are
    [0, ph) x [0, pw).  ``x``: (B, P, P); ``ph``, ``pw``: (B,) ints.
    Values outside the valid box come back as 0."""
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

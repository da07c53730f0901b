"""Finite-difference stencils with the reference's boundary conditions.

Port of ``faldoi_tpu/ops/stencils.py``:

* ``divergence`` / ``forward_gradient``: Chambolle-2004 boundaries
  (``src/mask.c:39-176``);
* ``centered_gradient``: one-sided halves at the borders (``mask.c:184-240``);
* ``*_patch``: the patch-domain variants on fixed (P, P) canvases with a
  valid box ``[0, ph) x [0, pw)``, where the box edge acts as the image edge
  (the reference's patch-edge-as-image-edge quirk, ``utils.cpp:63-220``).
  They take a batch of canvases (..., P, P) and per-canvas ``ph``/``pw`` of
  the batch shape; a canvas may be (H, W), not square (method 8's global
  step runs them on the whole image with the box (h, w)).
"""

from __future__ import annotations

import torch


def forward_gradient(f: torch.Tensor):
    """Forward differences; zero on the last row/col (mask.c:92-130)."""
    fx = torch.zeros_like(f)
    fy = torch.zeros_like(f)
    fx[:, :-1] = f[:, 1:] - f[:, :-1]
    fy[:-1, :] = f[1:, :] - f[:-1, :]
    return fx, fy


def centered_gradient(f: torch.Tensor):
    """Centered differences, one-sided halves at borders (mask.c:184-240)."""
    px = torch.cat([f[:, :1], f, f[:, -1:]], dim=1)
    py = torch.cat([f[:1, :], f, f[-1:, :]], dim=0)
    dx = 0.5 * (px[:, 2:] - px[:, :-2])
    dy = 0.5 * (py[2:, :] - py[:-2, :])
    return dx, dy


def divergence(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, Chambolle BCs (mask.c:39-83)."""
    dx = torch.cat([v1[:, :1], v1[:, 1:-1] - v1[:, :-2], -v1[:, -2:-1]], dim=1)
    dy = torch.cat([v2[:1, :], v2[1:-1, :] - v2[:-2, :], -v2[-2:-1, :]], dim=0)
    return dx + dy


def canvas_ids(p: int, device):
    """(rows (P, 1), cols (1, P)) index grids of a P x P canvas."""
    ar = torch.arange(p, device=device)
    return ar[:, None], ar[None, :]


def grid_ids(f: torch.Tensor):
    """(rows (H, 1), cols (1, W)) index grids of f's trailing (H, W)."""
    return (torch.arange(f.shape[-2], device=f.device)[:, None],
            torch.arange(f.shape[-1], device=f.device)[None, :])


def canvas_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum (B, P, P) canvases in a fixed order (columns, then rows), so the
    patch energy rounds the same on every device."""
    s = x[:, :, 0]
    for c in range(1, x.shape[2]):
        s = s + x[:, :, c]
    t = s[:, 0]
    for r in range(1, x.shape[1]):
        t = t + s[:, r]
    return t


def _box(t, f):
    """Per-canvas box size -> broadcastable against (..., P, P)."""
    t = torch.as_tensor(t, device=f.device)
    return t[..., None, None]


def forward_gradient_patch(f: torch.Tensor, ph, pw):
    """Forward differences on the valid box; the box edge acts as the image
    edge (utils.cpp:175-220).  Values outside the box are zero."""
    rows, cols = grid_ids(f)
    ph, pw = _box(ph, f), _box(pw, f)
    right = torch.cat([f[..., :, 1:], f[..., :, -1:]], dim=-1)
    down = torch.cat([f[..., 1:, :], f[..., -1:, :]], dim=-2)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    fx = torch.where((cols < pw - 1) & (rows < ph), right - f, zero)
    fy = torch.where((rows < ph - 1) & (cols < pw), down - f, zero)
    return fx, fy


def divergence_patch(v1: torch.Tensor, v2: torch.Tensor, ph, pw) -> torch.Tensor:
    """Backward-difference divergence with Chambolle BCs at the valid-box
    edges (utils.cpp:63-112).  Values outside the box are zero."""
    rows, cols = grid_ids(v1)
    ph, pw = _box(ph, v1), _box(pw, v1)
    left = torch.cat([v1[..., :, :1], v1[..., :, :-1]], dim=-1)
    up = torch.cat([v2[..., :1, :], v2[..., :-1, :]], dim=-2)
    dx = torch.where(cols == 0, v1, torch.where(cols == pw - 1, -left, v1 - left))
    dy = torch.where(rows == 0, v2, torch.where(rows == ph - 1, -up, v2 - up))
    inside = (rows < ph) & (cols < pw)
    return torch.where(inside, dx + dy, torch.zeros((), dtype=v1.dtype,
                                                     device=v1.device))

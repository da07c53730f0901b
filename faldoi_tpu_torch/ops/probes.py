"""The Pallas probe kernels P1-P3 of ``scripts/`` and their plain twins.

The JAX package's last three Pallas kernels lie on no path of the pipeline:
they are the probes that measured whether a Pallas kernel compiles on the
TPU (P1), whether the sweep's patch PD loop fits the "PD-kernel shape" of
(11, 11, 128) blocks (P2) and how fast a per-lane aligned warp-window fetch
is (P3).  On the card the same two questions (the canvas in registers or in
shared memory; the bytes of one window fetch) decide the design of K1, the
fused patch sweep, so the port keeps them as Hopper kernels
(``csrc/probes.cu``) behind an entry point of their own,
``cli/kernel_probe.py``.

* P1 ``probe_axpy``: ``2x + y`` (``scripts/tpu_pallas_probe.py:23``).
* P2 ``probe_roll4``: four times ``acc = acc + roll(acc, 1, axis=0) * 0.25``
  on an (11, 11, L) array, L a multiple of 128
  (``scripts/tpu_pallas_probe.py:47``).
* P3 ``probe_window_fetch``: per lane k, ``out[k, :] = sum(planes[:,
  oy8[k]:oy8[k]+40, cb[k]:cb[k]+128]) * 1e-6`` over 128 output lanes, with
  oy8 a multiple of 8 and cb a multiple of 128 inside the planes
  (``scripts/tpu_pallas_gather_probe.py:76``).

A CPU tensor goes to the twin; a CUDA tensor launches the kernel or the
wrapper raises.  Each wrapper counts its launches in ``.launches``.  P1 and
P2 equal their twins bit for bit; P3 sums in another order (relative 1e-5).

P3's kernel shares the work between the lanes: the aligned windows are made
of 8-row x 128-column bands, so it sums every band of the planes once (the
band table) and adds five band sums a lane.
``probe_window_fetch_bands_plain`` is that decomposition in PyTorch.
"""

from __future__ import annotations

import torch

from faldoi_tpu_torch.kernels import build as kb

ROLL_ROWS = 11           # P2's block rows and columns (a patch canvas)
ROLL_LANES = 128         # P2's block width (the TPU's lane count)
WIN_ROWS, WIN_COLS = 40, 128   # P3's window
WIN_ROW_ALIGN = 8              # P3's origin alignment (the TPU's sublanes)


def probe_axpy_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1."""
    return 2 * x + y


def probe_axpy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """P1: ``2x + y`` of two float32 tensors of one shape (one launch,
    whatever the size and alignment)."""
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    if x.device.type == "cpu":
        return probe_axpy_plain(x, y)
    kb.require_cuda_tensor(x, "x", torch.float32)
    kb.require_cuda_tensor(y, "y", torch.float32, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    code = kb.library().faldoi_probe_axpy(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        kb.stream_ptr(x.device))
    kb.check(code, "probe_axpy")
    probe_axpy.launches += 1
    return out


probe_axpy.launches = 0


def probe_roll4_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of P2."""
    acc = x
    for _ in range(4):
        acc = acc + torch.roll(acc, 1, 0) * 0.25
    return acc


def _check_roll_shape(x):
    if (x.dim() != 3 or x.shape[0] != ROLL_ROWS or x.shape[1] != ROLL_ROWS
            or x.shape[2] % ROLL_LANES):
        raise ValueError(f"x must be ({ROLL_ROWS}, {ROLL_ROWS}, L) with L a "
                         f"multiple of {ROLL_LANES}, got {tuple(x.shape)}")


def probe_roll4(x: torch.Tensor) -> torch.Tensor:
    """P2 on an (11, 11, L) float32 array, L a multiple of 128."""
    _check_roll_shape(x)
    if x.device.type == "cpu":
        return probe_roll4_plain(x)
    kb.require_cuda_tensor(x, "x", torch.float32)
    out = torch.empty_like(x)
    code = kb.library().faldoi_probe_roll4(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], x.shape[2],
        kb.stream_ptr(x.device))
    kb.check(code, "probe_roll4")
    probe_roll4.launches += 1
    return out


probe_roll4.launches = 0


def check_window_origins(planes: torch.Tensor, oy8: torch.Tensor,
                         cb: torch.Tensor) -> None:
    """Raise unless every origin is aligned (oy8 % 8, cb % 128) and its
    window lies inside the (C, H, W) planes."""
    if planes.dim() != 3:
        raise ValueError(f"planes must be (C, H, W), got {tuple(planes.shape)}")
    if oy8.dim() != 1 or oy8.shape != cb.shape:
        raise ValueError("oy8 and cb must be (B,) vectors of one length")
    _, h, w = planes.shape
    if oy8.numel() == 0:
        return
    misaligned = ((oy8 % WIN_ROW_ALIGN != 0) | (cb % WIN_COLS != 0)).any()
    outside = ((oy8 < 0) | (oy8 > h - WIN_ROWS) | (cb < 0)
               | (cb > w - WIN_COLS)).any()
    misaligned, outside = torch.stack([misaligned, outside]).tolist()  # 1 sync
    if misaligned:
        raise ValueError(f"window origins must be aligned: oy8 to "
                         f"{WIN_ROW_ALIGN} rows, cb to {WIN_COLS} columns")
    if outside:
        raise ValueError(f"a ({WIN_ROWS}, {WIN_COLS}) window leaves the "
                         f"{h}x{w} planes")


def probe_window_fetch_plain(planes: torch.Tensor, oy8: torch.Tensor,
                             cb: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Plain twin of P3: per lane ``planes[:, oy:oy+40, cb:cb+128].sum() *
    1e-6``, broadcast to (B, 128); gathered ``chunk`` lanes at a time."""
    dev = planes.device
    rows = torch.arange(WIN_ROWS, device=dev)
    cols = torch.arange(WIN_COLS, device=dev)
    sums = []
    for k0 in range(0, oy8.shape[0], chunk):
        oy = oy8[k0:k0 + chunk].to(torch.int64)
        c0 = cb[k0:k0 + chunk].to(torch.int64)
        win = planes[:, (oy[:, None] + rows)[:, :, None],
                     (c0[:, None] + cols)[:, None, :]]       # (C, b, 40, 128)
        sums.append(win.sum(dim=(0, 2, 3)) * 1e-6)
    s = torch.cat(sums) if sums else planes.new_zeros((0,))
    return s[:, None].expand(-1, WIN_COLS).contiguous()


def band_table_plain(planes: torch.Tensor) -> torch.Tensor:
    """The sums over C and over every aligned band of 8 rows x 128 columns
    of the (C, H, W) planes: (ceil(H / 8), W // 128); a last partial band
    sums the rows that exist."""
    c, h, w = planes.shape
    nby, nbx = -(-h // WIN_ROW_ALIGN), w // WIN_COLS
    rows = planes[:, :, :nbx * WIN_COLS].reshape(c, h, nbx, WIN_COLS).sum(dim=(0, 3))
    pad = rows.new_zeros((nby * WIN_ROW_ALIGN - h, nbx))
    return torch.cat([rows, pad]).reshape(nby, WIN_ROW_ALIGN, nbx).sum(dim=1)


def probe_window_fetch_bands_plain(planes: torch.Tensor, oy8: torch.Tensor,
                                   cb: torch.Tensor) -> torch.Tensor:
    """P3 as its kernel decomposes it: the band table, then per lane its five
    band sums added top to bottom, times 1e-6, broadcast to (B, 128)."""
    table = band_table_plain(planes)
    by = oy8.to(torch.int64) // WIN_ROW_ALIGN
    bx = cb.to(torch.int64) // WIN_COLS
    s = planes.new_zeros((oy8.shape[0],))
    for m in range(WIN_ROWS // WIN_ROW_ALIGN):
        s = s + table[by + m, bx]
    return (s * 1e-6)[:, None].expand(-1, WIN_COLS).contiguous()


def probe_window_fetch(planes: torch.Tensor, oy8: torch.Tensor,
                       cb: torch.Tensor) -> torch.Tensor:
    """P3: (C, H, W) float32 planes, (B,) int32 aligned origins -> (B, 128).
    Checking the origins reads one flag back from the card (a sync)."""
    check_window_origins(planes, oy8, cb)
    if planes.device.type == "cpu":
        return probe_window_fetch_plain(planes, oy8, cb)
    kb.require_cuda_tensor(planes, "planes", torch.float32)
    kb.require_cuda_tensor(oy8, "oy8", torch.int32, planes.device)
    kb.require_cuda_tensor(cb, "cb", torch.int32, planes.device)
    w = planes.shape[2]
    if w % 4 or planes.data_ptr() % 16:
        raise ValueError(f"planes must start 16-byte aligned with a width "
                         f"({w}) that is a multiple of 4: the kernel's rows "
                         "are float4 loads")
    return launch_window_fetch(planes, oy8, cb)


def launch_window_fetch(planes, oy8, cb) -> torch.Tensor:
    """P3's launch alone (band table and lane pass), for origins that
    ``probe_window_fetch`` has checked (it times the kernel without the
    check's sync)."""
    c, h, w = planes.shape
    b = oy8.shape[0]
    out = torch.empty((b, WIN_COLS), dtype=torch.float32, device=planes.device)
    if b == 0:
        return out
    table = torch.empty(-(-h // WIN_ROW_ALIGN) * (w // WIN_COLS),
                        dtype=torch.float32, device=planes.device)
    code = kb.library().faldoi_probe_window_fetch(
        planes.data_ptr(), oy8.data_ptr(), cb.data_ptr(), table.data_ptr(),
        out.data_ptr(), c, h, w, b, kb.stream_ptr(planes.device))
    kb.check(code, "probe_window_fetch")
    probe_window_fetch.launches += 1
    return out


probe_window_fetch.launches = 0

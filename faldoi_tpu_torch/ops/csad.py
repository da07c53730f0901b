"""CSAD data-term pieces, whole-image and per patch, with kernel K8 for the
v-step.

Port of the CSAD halves of ``faldoi_tpu/core/global_step_csad.py``
(``_csad_setup``, ``_csad_b``, ``_csad_vstep``) and of
``faldoi_tpu/core/functionals.py`` (``_csad_masks``, ``_csad_b``,
``_csad_vstep``).  The "centralized sum of absolute differences" compares
each pixel with the 48 neighbours of its 7x7 window (``DT_R`` 3, dy outer,
dx inner, the centre skipped); a neighbour counts where it lies inside the
image (whole-image form) or inside the canvas's valid box (patch form,
where a cell outside the box has none).  Both forms stack the 48 neighbour
quantities on a leading axis: (48, h, w) or (48, B, P, P).

The v-step is the exact prox of the CSAD data term: the median of 2n + 1
breakpoints, with the reference's index ``it/2 + 1`` (one past the median;
global_faldoi.cpp:1567).  ``csad_vstep`` is kernel K8 (``csrc/csad.cu``) on
CUDA tensors and its plain twin ``csad_vstep_plain``, a sort of the 97
entries, on CPU tensors.  ``csad_patch_loop`` (the K8 loop, the same source)
runs one warp's whole inert-TV patch PD loop of methods 4 and 5 in one
launch; its twin ``csad_patch_loop_plain`` is that loop in plain ops.
"""

from __future__ import annotations

import numpy as np
import torch

from faldoi_tpu_torch.kernels import build as kb
from faldoi_tpu_torch.ops.nonlocal_ops import neighbor_offsets, valid_mask
from faldoi_tpu_torch.ops.stencils import canvas_ids, canvas_sum
from faldoi_tpu_torch.params import DT_R

# the 48 (dy, dx) offsets of the CSAD window, in the reference's order
CSAD_OFFS = tuple(neighbor_offsets(DT_R))
N_D = len(CSAD_OFFS)


def image_masks(h: int, w: int, device):
    """(48, h, w) bool: neighbour j of the pixel lies inside the image; and
    ``ncount`` (h, w) float32, their number (``_csad_setup``)."""
    m = np.stack([valid_mask(h, w, dy, dx) for dy, dx in CSAD_OFFS])
    return (torch.as_tensor(m, device=device),
            torch.as_tensor(m.sum(axis=0).astype(np.float32), device=device))


def canvas_masks(ph, pw, p: int):
    """(48, B, P, P) bool: the cell lies inside its canvas's box [0, ph) x
    [0, pw) and so does its neighbour j (``_csad_masks & inbox``); and
    ``ncount`` (B, P, P) float32, their number.  ph, pw: (B,) int tensors."""
    rows, cols = canvas_ids(p, ph.device)
    ph3, pw3 = ph[:, None, None], pw[:, None, None]
    inbox = (rows < ph3) & (cols < pw3)
    dy, dx = (torch.tensor([o[k] for o in CSAD_OFFS], device=ph.device)
              .view(-1, 1, 1, 1) for k in (0, 1))
    nr, nc = rows + dy, cols + dx
    masks = inbox & (nr >= 0) & (nr < ph3) & (nc >= 0) & (nc < pw3)
    return masks, masks.sum(dim=0).to(torch.float32)


def neighbour_stack(x):
    """(48, ...) stack of x shifted by each offset as ``shift_pull`` shifts
    it (zero off the plane), from one padded copy."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (DT_R,) * 4)
    return torch.stack([xp[..., DT_R + dy:DT_R + dy + h, DT_R + dx:DT_R + dx + w]
                        for dy, dx in CSAD_OFFS])


def csad_b(i0, i1w, i1wx, i1wy, u1, u2, denom, masks):
    """The 48 breakpoint planes b_j = (I0 - I0_j - I1w + I1w_j + I1wx u1 +
    I1wy u2) / denom where neighbour j counts, else 0 (tvcsad_model.cpp:374+,
    global_faldoi.cpp:1530-1531).  The planes are (h, w) or (B, P, P)
    canvases; neighbours off the plane read 0 (they are masked)."""
    base = i0 - i1w + i1wx * u1 + i1wy * u2
    i0n, i1wn = neighbour_stack(i0), neighbour_stack(i1w)
    zero = torch.zeros((), dtype=base.dtype, device=base.device)
    return torch.where(masks, (base - i0n + i1wn) / denom, zero).contiguous()


def csad_vstep_plain(u1, u2, b, i1wx, i1wy, denom, l_t, masks, ncount):
    """Plain twin of K8: the entries ``-(b_j - dot)`` (``inf`` where neighbour
    j does not count) and ``(n - 2j) l_t denom`` for j = 0..n (``inf``
    beyond), sorted along the entry axis (NaN last, as ``jnp.sort``); the
    entry of index n + 1 is ``med``.  Returns ``(u1 - i1wx med / denom,
    u2 - i1wy med / denom)``.  ``l_t``: a float, a 0-d tensor, or one value a
    cell."""
    dot = (i1wx * u1 + i1wy * u2) / denom
    inf = torch.full((), float("inf"), dtype=u1.dtype, device=u1.device)
    part1 = torch.where(masks, -(b - dot), inf)
    jidx = torch.arange(N_D + 1, dtype=u1.dtype, device=u1.device)
    jidx = jidx.view((-1,) + (1,) * u1.dim())
    part2 = torch.where(jidx <= ncount, (ncount - 2.0 * jidx) * (l_t * denom), inf)
    ba = torch.sort(torch.cat([part1, part2]), dim=0, stable=True).values
    med = ba.gather(0, (ncount + 1.0).to(torch.int64)[None])[0]
    return u1 - i1wx * med / denom, u2 - i1wy * med / denom


INF_KEY = 0x7f800000


def order_key(x):
    """int32 keys of float32 ``x`` whose signed order is ``torch.sort``'s:
    -0 equal to +0, every NaN equal and after +inf (``csad_select.cuh``)."""
    i = x.contiguous().view(torch.int32)
    k = torch.where(i < 0, i ^ 0x7fffffff, i)
    k = torch.where(x == 0, torch.zeros_like(k), k)
    return torch.where(torch.isnan(x), torch.full_like(k, 0x7fffffff), k)


def _ranked(b, masks):
    """Each cell's b in descending order (ascending ``order_key(-b)``, ties
    by j, the masked ones last): the rank axis first."""
    key = torch.where(masks, order_key(-b),
                      torch.full_like(b, 0, dtype=torch.int32) + INF_KEY)
    return b.gather(0, torch.sort(key, dim=0, stable=True).indices)


def _merge_search(a_at, n, ltg, dot):
    """The merge-path search of six probes for the entry at position n + 1
    of A u B, A[i] = ``a_at(i)`` (the b of rank i, recomputed as -(b - dot),
    +inf from n on), each probe recomputed as the twin computes it."""
    inf = torch.full((), float("inf"), dtype=ltg.dtype)
    sg = torch.where(ltg > 0, 1, -1)
    m = n + 2

    def b_at(i):        # B[n + 1 - i] in B's stable order
        return torch.where(i >= 1, (sg * (m - 2 * i)).to(ltg.dtype) * ltg, inf)

    lo = (m - (N_D + 1)).clamp(min=0)
    size = torch.minimum(m, torch.full_like(m, N_D)) - lo
    for _ in range(6):   # the first i in [lo, hi) with A[i] > B[n + 1 - i]
        half = size // 2
        mid = lo + half
        q = a_at(mid) <= b_at(mid)
        go = size > 0
        lo = torch.where(go & q, mid + 1, lo)
        size = torch.where(go, torch.where(q, size - half - 1, half), size)
    a, bb = a_at(lo - 1), b_at(lo)
    return torch.where(lo == 0, bb, torch.where(lo == m, a, torch.where(a > bb, a, bb)))


def csad_ranked_select_plain(b, masks, ncount, l_t, denom, dots,
                             zero_fallback=False):
    """Plain model of the loop kernels' ranked selection (``csrc/csad.cu``,
    its header): once, the inside b of each cell ranked in descending order
    (ascending ``order_key(-b)``, ties by j, the masked ones last); then for
    each ``dot`` of ``dots`` (one a PD iteration) the merge-path search of
    six probes for the entry at position n + 1 of A u B, each probe
    recomputed as the twin computes it.  Cells whose dot, l_t denom or an
    inside b is not finite take the twin's sort instead, and with
    ``zero_fallback`` (a rule the kernels do not need) those whose found
    value is a zero.  Returns [(med, fallback)] a dot:
    med as the rule gives it, fallback the bool cells that took the sort.
    For the tests only."""
    n = ncount.to(torch.int64)
    ranked = _ranked(b, masks)
    ltg = l_t * denom
    inf = torch.full((), float("inf"), dtype=b.dtype)
    bfin = (torch.isfinite(b) | ~masks).all(dim=0) & torch.isfinite(ltg)
    out = []
    for dot in dots:
        def a_at(i, dot=dot):   # A[i]: the b of rank i, +inf from n on
            v = -(ranked.gather(0, i.clamp(0, N_D - 1)[None])[0] - dot)
            return torch.where(i < n, v, inf)

        med = _merge_search(a_at, n, torch.as_tensor(ltg, dtype=b.dtype)
                            .expand(n.shape), dot)
        fb = ~(bfin & torch.isfinite(dot))
        if zero_fallback:
            fb = fb | (med == 0)
        want = _sorted_med(b, masks, ncount, dot, ltg)
        out.append((torch.where(fb, want, med), fb))
    return out


# the whole-image loops' layouts of the ranked b (``csrc/csad_select.cuh``):
# pixel `cell`'s rank i at col(cell) + i * stride in a flat buffer
IMAGE_LAYOUTS = {"pixel": (lambda cell, hw: cell * N_D, lambda hw: 1),
                 "plane": (lambda cell, hw: cell, lambda hw: hw)}


def csad_rank_image_plain(b, masks, l_t, denom, layout="pixel"):
    """Plain model of the whole-image loops' rank launch (K14, K15,
    ``csrc/csad_global.cu``): each pixel's inside b (b (48, h, w)) in
    descending order, ties by j, at rank i of its column in a flat buffer of
    48 floats a pixel laid out as ``layout`` ("pixel": (h w, 48); "plane":
    (48, h, w)), NaN past the pixel's n (the kernel leaves those unwritten);
    and ``ok`` (h, w) bool: every inside b and l_t denom finite.  For the
    tests only."""
    n = masks.sum(dim=0)
    ranked = torch.where(torch.arange(N_D).view(-1, 1, 1) < n, _ranked(b, masks),
                         torch.full((), float("nan")))
    col, stride = IMAGE_LAYOUTS[layout]
    hw = ranked[0].numel()
    cells = torch.arange(hw)
    idx = col(cells, hw)[None] + torch.arange(N_D)[:, None] * stride(hw)
    rb = torch.empty(hw * N_D, dtype=b.dtype)
    rb[idx.reshape(-1)] = ranked.reshape(N_D, hw).reshape(-1)
    ok = (torch.isfinite(b) | ~masks).all(dim=0) & torch.isfinite(l_t * denom)
    return rb, ok


def csad_ranked_image_select_plain(rb, ok, b, masks, ncount, l_t, denom, dot,
                                   layout="pixel"):
    """Plain model of one PD iteration's selection in the whole-image loops
    (``csrc/csad_select.cuh``, ``image_select``): where ``ok`` and dot are
    finite, the merge-path search over the pixel's column of ``rb`` (from
    ``csad_rank_image_plain``, read at the kernel's flat indices), else the
    twin's sort (the kernels' counting path).  Returns (med, fallback).  For
    the tests only."""
    n = ncount.to(torch.int64).reshape(-1)
    hw = n.numel()
    col, stride = IMAGE_LAYOUTS[layout]
    base = col(torch.arange(hw), hw)
    ltg = (l_t * denom).reshape(-1)
    inf = torch.full((), float("inf"), dtype=rb.dtype)
    d = dot.reshape(-1)

    def a_at(i):   # read only for i in [0, n), as the kernel reads
        at = base + i.clamp(0, N_D - 1) * stride(hw)
        return torch.where((i >= 0) & (i < n), -(rb[at] - d), inf)

    med = _merge_search(a_at, n, ltg, d).view(dot.shape)
    fb = ~(ok & torch.isfinite(dot))
    want = _sorted_med(b, masks, ncount, dot, l_t * denom)
    return torch.where(fb, want, med), fb


def _sorted_med(b, masks, ncount, dot, ltg):
    """The twin's selection (``csad_vstep_plain``): entry n + 1 of the 97
    entries sorted."""
    inf = torch.full((), float("inf"), dtype=b.dtype)
    part1 = torch.where(masks, -(b - dot), inf)
    jidx = torch.arange(N_D + 1, dtype=b.dtype).view((-1,) + (1,) * dot.dim())
    part2 = torch.where(jidx <= ncount, (ncount - 2.0 * jidx) * ltg, inf)
    ba = torch.sort(torch.cat([part1, part2]), dim=0, stable=True).values
    return ba.gather(0, (ncount + 1.0).to(torch.int64)[None])[0]


def csad_vstep(u1, u2, b, i1wx, i1wy, denom, l_t, masks, ncount, ph=None,
               pw=None):
    """K8: the CSAD v-step of every cell.  Whole-image form: u1, u2, i1wx,
    i1wy, denom (h, w) float32, b (48, h, w), ``ph`` and ``pw`` None.  Patch
    form: the planes (B, P, P) canvases, b (48, B, P, P), ph, pw (B,) int32
    boxes.  ``l_t``: a float, a 0-d tensor, or a plane of one value a cell.
    ``masks``, ``ncount``: ``image_masks`` or ``canvas_masks`` of the same
    geometry (the twin reads them; the kernel derives them from the
    geometry).  Returns (v1, v2).

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise).  ``launches`` counts launches."""
    patch = ph is not None
    if u1.dim() != (3 if patch else 2):
        raise ValueError(f"u1 {tuple(u1.shape)}: expected "
                         f"{'(B, P, P)' if patch else '(h, w)'}")
    if u1.device.type == "cpu":
        return csad_vstep_plain(u1, u2, b, i1wx, i1wy, denom, l_t, masks, ncount)
    dev, shape = u1.device, tuple(u1.shape)
    if not patch and min(shape) < 3:
        # below 3 px image_masks, as JAX's valid_mask, wraps a negative slice
        # end and counts neighbours past the far edge; the kernel does not
        raise ValueError(f"u1 {shape}: the whole-image form takes 3 x 3 and up")
    for name, t in (("u1", u1), ("u2", u2), ("i1wx", i1wx), ("i1wy", i1wy),
                    ("denom", denom)):
        kb.require_cuda_tensor(t, name, torch.float32, dev, shape)
    kb.require_cuda_tensor(b, "b", torch.float32, dev, (N_D,) + shape)
    lt_ptr, lt_val, lt_cells = None, 0.0, 0
    if isinstance(l_t, torch.Tensor):
        lt_cells = int(l_t.dim() != 0)
        kb.require_cuda_tensor(l_t, "l_t", torch.float32, dev,
                               shape if lt_cells else ())
        lt_ptr = l_t.data_ptr()
    else:
        lt_val = float(np.float32(l_t))
    v1, v2 = torch.empty_like(u1), torch.empty_like(u2)
    if u1.numel() == 0:
        return v1, v2
    lib = kb.library()
    args = (u1, u2, b, i1wx, i1wy, denom)
    if patch:
        for name, t in (("ph", ph), ("pw", pw)):
            kb.require_cuda_tensor(t, name, torch.int32, dev, shape[:1])
        code = lib.faldoi_csad_vstep_patch(
            *(t.data_ptr() for t in args), lt_ptr, lt_val, lt_cells,
            ph.data_ptr(), pw.data_ptr(), v1.data_ptr(), v2.data_ptr(),
            shape[0], shape[1], kb.stream_ptr(dev))
    else:
        code = lib.faldoi_csad_vstep_global(
            *(t.data_ptr() for t in args), lt_ptr, lt_val, lt_cells,
            v1.data_ptr(), v2.data_ptr(), shape[0], shape[1], kb.stream_ptr(dev))
    kb.check(code, "csad_vstep")
    csad_vstep.launches += 1
    return v1, v2


csad_vstep.launches = 0   # K8 launches (both forms), raised after a launch


def csad_patch_loop_plain(u1, u2, v1, v2, b, i1wx, i1wy, denom, l_t, masks,
                          ncount, ph, pw, theta, tau, tol2, max_iters: int):
    """Plain twin of the K8 loop: the masked unroll of one warp's PD loop of
    the inert-TV CSAD solve (methods 4, 5; JAX's ``_bounded_pd_loop`` of
    ``_solve_csad_family``) on B (P, P) canvases.  Per step, while a
    canvas's err > tol2 (err starts at +inf) and its count < max_iters: the
    v-step (``csad_vstep_plain``), ``u = u - tau ((u - v) / theta)`` (the
    duals stay 0), err = the in-box mean squared update.  Returns (u1, u2,
    v1, v2, iterations (B,) int32)."""
    dev = u1.device
    rows, cols = canvas_ids(u1.shape[-1], dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    npx = (ph * pw).to(u1.dtype)
    err = torch.full(u1.shape[:1], float("inf"), dtype=u1.dtype, device=dev)
    n = torch.zeros(u1.shape[:1], dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        run = (err > tol2) & (n < max_iters)
        if not bool(run.any()):
            break
        nv1, nv2 = csad_vstep_plain(u1, u2, b, i1wx, i1wy, denom, l_t, masks,
                                    ncount)
        nu1 = u1 - tau * ((u1 - nv1) / theta)
        nu2 = u2 - tau * ((u2 - nv2) / theta)
        e1, e2 = nu1 - u1, nu2 - u2
        nerr = canvas_sum(torch.where(inbox, e1 * e1 + e2 * e2, zero)) / npx
        lane = run.view(-1, 1, 1)
        u1, u2, v1, v2 = (torch.where(lane, nw, a) for a, nw in
                          zip((u1, u2, v1, v2), (nu1, nu2, nv1, nv2)))
        err = torch.where(run, nerr, err)
        n = torch.where(run, n + 1, n)
    return u1, u2, v1, v2, n


def csad_patch_loop(u1, u2, v1, v2, b, i1wx, i1wy, denom, l_t, masks, ncount,
                    ph, pw, theta, tau, tol2, max_iters: int):
    """The K8 loop: one warp's inert-TV PD loop of the m4 / m5 patch solve
    on B (P, P) float32 canvases u1, u2, v1, v2 (v: the last warp's, kept
    where a canvas takes no step), the warp's b (48, B, P, P), i1wx, i1wy and
    denom (grad); l_t a 0-d tensor or a (B, P, P) canvas (method 5); masks,
    ncount from ``canvas_masks`` (the twin reads them; the kernel derives
    them from the boxes); ph, pw (B,) int32; theta, tau, tol2 0-d float32
    tensors.  Returns new (u1, u2, v1, v2, iterations (B,) int32); the inputs
    are not changed.

    CPU tensors go to the plain twin; CUDA tensors launch the kernel (or
    raise), one launch for the whole loop.  ``launches`` counts launches."""
    if u1.dim() != 3 or u1.shape[1] != u1.shape[2]:
        raise ValueError(f"u1 must be (B, P, P), got {tuple(u1.shape)}")
    nb, p = u1.shape[0], u1.shape[1]
    kb.check_canvas_side(p, "csad_patch_loop")
    if u1.device.type == "cpu":
        return csad_patch_loop_plain(u1, u2, v1, v2, b, i1wx, i1wy, denom, l_t,
                                     masks, ncount, ph, pw, theta, tau, tol2,
                                     max_iters)
    dev, shape = u1.device, tuple(u1.shape)
    for name, t in (("u1", u1), ("u2", u2), ("v1", v1), ("v2", v2),
                    ("i1wx", i1wx), ("i1wy", i1wy), ("denom", denom)):
        kb.require_cuda_tensor(t, name, torch.float32, dev, shape)
    kb.require_cuda_tensor(b, "b", torch.float32, dev, (N_D,) + shape)
    lt_cells = l_t.dim() != 0
    kb.require_cuda_tensor(l_t, "l_t", torch.float32, dev,
                           shape if lt_cells else ())
    for name, t in (("ph", ph), ("pw", pw)):
        kb.require_cuda_tensor(t, name, torch.int32, dev, (nb,))
    scal = torch.stack([theta, tau, tol2]).to(torch.float32).contiguous()
    kb.require_cuda_tensor(scal, "theta, tau, tol2", torch.float32, dev, (3,))
    outs = [torch.empty_like(u1) for _ in range(4)]
    iters = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return (*outs, iters)
    code = kb.library().faldoi_csad_patch_loop(
        *(t.data_ptr() for t in (u1, u2, v1, v2, b, i1wx, i1wy, denom, l_t,
                                 scal, ph, pw)),
        *(t.data_ptr() for t in outs), iters.data_ptr(), nb, p, int(lt_cells),
        int(max_iters), kb.stream_ptr(dev))
    kb.check(code, "csad_patch_loop")
    csad_patch_loop.launches += 1
    return (*outs, iters)


csad_patch_loop.launches = 0   # K8 loop launches, raised after a launch

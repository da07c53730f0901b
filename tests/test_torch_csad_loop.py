"""The K8 loop (``ops.csad.csad_patch_loop``, the inert-TV patch PD loop of
methods 4 and 5) and K8's selection by counting, on the CPU.

* A numpy model of the kernels' selection (``csrc/csad.cu``: integer order
  keys, the 1128 pair counts of the A entries, the binary searches over the
  monotone B list, the B entry by its rank, the slow path for a non-finite
  l_t denom) is held to a stable numpy sort of the 97 entries and to
  ``csad_vstep_plain``, bit for bit, on adversarial cells: equal entries,
  entries equal to a B value, +-0, +-inf, NaN, every n from 0 to 48, l_t
  negative, -0, 0, huge (B overflows), inf and NaN.  So the rule is checked
  before the card runs it.
* The CSAD solvers of methods 4 and 5 give the same bits through the loop's
  twin as through a copy of the inline loop they ran before (the witness),
  over two warps at P 11 and 3.
* The wrapper on CPU tensors takes the twin; its tol gate and iteration
  counts.

No JAX here: ``tests/test_torch_csad.py`` holds the twin to JAX's solve."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

N_D = 48
NAN_KEY = 0x7FFFFFFF
INF_KEY = 0x7F800000
F32 = np.float32


def order_key(a):
    """csad.cu's order_key on a float32 array: int64 keys."""
    a = np.asarray(a, dtype=F32)
    i = a.view(np.int32).astype(np.int64)
    k = np.where(i < 0, i ^ 0x7FFFFFFF, i)
    k = np.where(a == 0, 0, k)
    return np.where(np.isnan(a), NAN_KEY, k)


def key_value(k):
    k = np.asarray(k, dtype=np.int64)
    return np.where(k < 0, k ^ 0x7FFFFFFF, k).astype(np.int32).view(F32)


def b_entry(n, j, ltg):
    return (n - 2 * j).astype(F32) * ltg


def b_keys(n, ltg):
    """(49, N) keys of B_0..B_48 (+inf beyond n)."""
    j = np.arange(N_D + 1)[:, None]
    return np.where(j <= n, order_key(b_entry(n, j, ltg)), INF_KEY)


def model_select(a, n, ltg):
    """The kernels' selection, cell by cell as numpy vectors: a (48, N)
    float32 entries (+inf where masked), n (N,), ltg (N,) float32 -> med."""
    key = order_key(a)
    pos = np.zeros(key.shape, dtype=np.int64)
    for k in range(N_D):
        for m in range(N_D):
            if m < k:
                pos[k] += key[m] <= key[k]
            elif m > k:
                pos[k] += key[m] < key[k]
    fin = np.isfinite(ltg)
    dec = ~(ltg < 0)
    bk = b_keys(n, ltg)
    for k in range(N_D):
        x = key_value(key[k])
        lo, ln = np.zeros_like(n), n + 1
        for _ in range(6):
            half = ln >> 1
            mid = lo + half
            q = (b_entry(n, mid, ltg) < x) == dec
            act = ln > 0
            lo = np.where(act & ~q, mid + 1, lo)
            ln = np.where(act, np.where(q, half, ln - half - 1), 0)
        fast = np.where(key[k] == NAN_KEY, N_D + 1, np.where(dec, n + 1 - lo, lo))
        slow = (bk < key[k]).sum(axis=0)
        pos[k] += np.where(fin, fast, slow)
    hit = pos == n + 1
    assert (hit.sum(axis=0) <= 1).all()
    win = np.where(hit.any(axis=0), hit.argmax(axis=0), -1)
    r = n + 1 - (pos <= n).sum(axis=0)
    jsel = np.clip(np.where(ltg > 0, n - r, r), 0, N_D)
    fast_b = np.where(r > n, F32(np.inf), b_entry(n, jsel, ltg))
    # slow path: the B entry of rank r in B's stable order
    bpos = np.zeros(bk.shape, dtype=np.int64)
    for j in range(N_D + 1):
        for i in range(N_D + 1):
            if i < j:
                bpos[j] += bk[i] <= bk[j]
            elif i > j:
                bpos[j] += bk[i] < bk[j]
    ball = np.where(np.arange(N_D + 1)[:, None] <= n,
                    b_entry(n, np.arange(N_D + 1)[:, None], ltg), F32(np.inf))
    slow_b = np.take_along_axis(ball, (bpos == r).argmax(axis=0)[None], 0)[0]
    bmed = np.where(fin, fast_b, slow_b)
    return np.where(win >= 0, np.take_along_axis(a, np.maximum(win, 0)[None], 0)[0],
                    bmed).astype(F32)


def sort_select(a, n, ltg):
    """The oracle: a stable numpy sort of the 97 entries (NaN last, -0 equal
    to +0), the entry at n + 1."""
    j = np.arange(N_D + 1)[:, None]
    ent = np.concatenate([a, np.where(j <= n, b_entry(n, j, ltg), F32(np.inf))])
    order = np.argsort(ent, axis=0, kind="stable")
    return np.take_along_axis(ent, order, 0)[n + 1, np.arange(len(n))]


def same(x, y):
    x, y = np.asarray(x, F32), np.asarray(y, F32)
    return bool(((x.view(np.int32) == y.view(np.int32))
                 | (np.isnan(x) & np.isnan(y))).all())


# case -> (values the in-box b entries are drawn from, l_t values)
CASES = {
    "ties-with-b": ([-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0], [0.25, 0.5]),
    "signed-zeros": ([0.0, -0.0, 0.25, -0.25], [0.0, -0.0, 0.25, -0.25]),
    "infinities": ([np.inf, -np.inf, 0.0, 1.5, -2.0], [0.3, -0.3]),
    "nans": ([np.nan, 0.5, -0.5, np.inf, -0.0], [0.3, 0.0]),
    "random": (None, [0.255, 1e-3, -0.7]),
    "b-overflow": ([1e38, -1e38, 0.0, 3e38, -np.inf], [1e37, -1e37, 3e38]),
    "lt-inf": ([0.0, 1.0, -1.0, np.inf, np.nan], [np.inf, -np.inf]),
    "lt-nan": ([0.0, 1.0, -1.0, np.inf, np.nan], [np.nan]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_counting_model_matches_sort_and_twin(case):
    """Every n from 0 to 48 (random masks of that size), 12 cells each;
    b drawn from the case's values, so entries tie within A and with B."""
    from faldoi_tpu_torch.ops.csad import csad_vstep_plain

    pool, lts = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    n = np.repeat(np.arange(N_D + 1), 12)
    cells = len(n)
    masks = np.zeros((N_D, cells), dtype=bool)
    for c in range(cells):
        masks[rng.choice(N_D, n[c], replace=False), c] = True
    if pool is None:
        b = rng.normal(0, 1, (N_D, cells)).astype(F32)
    else:
        b = np.asarray(pool, dtype=F32)[rng.integers(0, len(pool), (N_D, cells))]
    b = np.where(masks, b, F32(0))
    lt = np.asarray(lts, dtype=F32)[rng.integers(0, len(lts), cells)]
    u1 = np.zeros(cells, F32)
    gx, gy, den = np.ones(cells, F32), -np.ones(cells, F32), np.ones(cells, F32)
    with np.errstate(all="ignore"):
        dot = (gx * u1 + gy * u1) / den
        a = np.where(masks, -(b - dot), F32(np.inf)).astype(F32)
        ltg = (lt * den).astype(F32)
        med = model_select(a, n, ltg)
        want = sort_select(a, n, ltg)
        assert same(med, want), case
        v1 = u1 - (gx * med) / den
        v2 = u1 - (gy * med) / den
    T = torch.as_tensor
    w1, w2 = csad_vstep_plain(T(u1), T(u1), T(b), T(gx), T(gy), T(den), T(lt),
                              T(masks), T(n.astype(F32)))
    assert same(v1, w1.numpy()) and same(v2, w2.numpy())
    if case == "signed-zeros":        # a selected zero of either sign
        assert (med.view(np.int32) == np.int32(0)).any()
        assert (med.view(np.int32) == np.float32(-0.0).view(np.int32)).any()


@pytest.fixture(scope="module")
def pair_consts():
    """The port's forward consts of methods 4 and 5 on a 36x52 synthetic
    pair, and the pair's known flow."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    i0, i1, gf, _ = syn.make_pair(36, 52, seed=91)
    a, b = prepare_pair(i0, i1, device="cpu")
    return {m: make_solver_consts(a, b, *method_local_params(m, 5), 0.01, 11, m)
            for m in (P.M_TVCSAD, P.M_TVCSAD_W)}, gf


def _geometry(p, nb, seed, h=36, w=52):
    """nb patch boxes (the image corners first, clipped at the edge) and
    init canvases of the known flow's mean plus 0.3 px."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.choice(h * w, nb, replace=False))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])
    geo = patch_geometry(idx, h, w, p // 2)
    u0 = torch.as_tensor(rng.normal(2.6, 0.3, (nb, p, p)).astype(F32))
    v0 = torch.as_tensor(rng.normal(-1.4, 0.3, (nb, p, p)).astype(F32))
    return geo, u0, v0


def _inline_inert_solve(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps, max_iters,
                        weighted):
    """The witness: ``_solve_csad_family``'s inert-TV path as it ran before
    the K8 loop, the per-iteration v-step and the masked updates inline."""
    from faldoi_tpu_torch.core.functionals import _weight2d
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import (
        canvas_masks, csad_b, csad_vstep, neighbour_stack,
    )
    from faldoi_tpu_torch.ops.nonlocal_ops import ordered_sum
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids, canvas_sum

    dev = u1.device
    rows, cols = canvas_ids(p, dev)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    zero = torch.zeros((), dtype=u1.dtype, device=dev)
    oy32, ox32 = oy.to(torch.int32).contiguous(), ox.to(torch.int32).contiguous()
    ph32, pw32 = ph.to(torch.int32).contiguous(), pw.to(torch.int32).contiguous()
    box = (oy32, ox32, ph32, pw32)
    i0_patch = gather_patches(sc.i0pad[:, :, None], oy32, ox32, p)[:, :, 0, :]
    i0_patch = i0_patch.permute(2, 0, 1)
    masks, ncount = canvas_masks(ph32, pw32, p)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        w2d = _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)
        l_t = (l_t * w2d).contiguous()
    tol2 = sc.tol * sc.tol
    npx = (ph * pw).to(u1.dtype)
    u1, u2 = u1.contiguous(), u2.contiguous()
    v1, v2 = u1, u2
    for _ in range(warps):
        i1w, i1wx, i1wy = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 3)
        grad = hypot(i1wx * i1wx + i1wy * i1wy, 0.01)
        b = csad_b(i0_patch, i1w, i1wx, i1wy, u1, u2, grad, masks)
        st = (u1, u2, u1, u2, (), v1, v2,
              torch.full(u1.shape[:1], float("inf"), dtype=u1.dtype, device=dev),
              torch.zeros(u1.shape[:1], dtype=torch.int32, device=dev))
        for _ in range(max_iters):
            c1, c2, c1_, c2_, rg, _, _, err, n = st
            nv1, nv2 = csad_vstep(c1, c2, b, i1wx, i1wy, grad, l_t, masks,
                                  ncount, ph32, pw32)
            nu1 = c1 - sc.tau * ((c1 - nv1) / sc.theta)
            nu2 = c2 - sc.tau * ((c2 - nv2) / sc.theta)
            e1, e2 = nu1 - c1, nu2 - c2
            nerr = canvas_sum(torch.where(inbox, e1 * e1 + e2 * e2, zero)) / npx
            run = (err > tol2) & (n < max_iters)
            lane = run.view(-1, 1, 1)
            new = (nu1, nu2, 2 * nu1 - c1, 2 * nu2 - c2, nv1, nv2)
            old = st[:4] + st[5:7]
            u1, u2, u1b, u2b, v1, v2 = (torch.where(lane, nw, a)
                                        for a, nw in zip(old, new))
            st = (u1, u2, u1b, u2b, rg, v1, v2, torch.where(run, nerr, err),
                  torch.where(run, n + 1, n))
        u1, u2, v1, v2 = st[0], st[1], st[5], st[6]
    u1 = torch.where(inbox, u1, zero)
    u2 = torch.where(inbox, u2, zero)
    v1 = torch.where(inbox, v1, zero)
    v2 = torch.where(inbox, v2, zero)
    i1w = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 1)[0]
    i0n, i1wn = neighbour_stack(i0_patch), neighbour_stack(i1w)
    dt = ordered_sum(torch.where(masks, (i0_patch - i0n - i1w + i1wn).abs(), zero))
    dt = dt * sc.lambda_
    if weighted:
        dt = dt * w2d
    e1 = u1 - v1
    e2 = u2 - v2
    dc = (1.0 / (2.0 * sc.theta)) * (e1 * e1 + e2 * e2)
    ener = canvas_sum(torch.where(inbox, dc + dt + zero, zero)) / (ph * pw).to(u1.dtype)
    return u1, u2, ener


@pytest.mark.parametrize("method,p", [(P.M_TVCSAD, 11), (P.M_TVCSAD, 3),
                                      (P.M_TVCSAD_W, 11), (P.M_TVCSAD_W, 3)],
                         ids=["m4-p11", "m4-p3", "m5-p11", "m5-p3"])
def test_solver_through_loop_twin_equals_inline_loop(pair_consts, method, p):
    """solve_tvcsad / solve_tvcsad_w through the loop's twin against the
    inline loop they ran before, bit for bit (two warps, four iterations)."""
    from faldoi_tpu_torch.core.functionals import solver_for
    from faldoi_tpu_torch.ops.csad import csad_patch_loop

    scs, _ = pair_consts
    geo, u0, v0 = _geometry(p, 40, 92 + p + method)
    before = csad_patch_loop.launches
    got = solver_for(method)(scs[method], *geo, u0, v0, p, 2, 4)
    assert csad_patch_loop.launches == before           # the twin ran
    want = _inline_inert_solve(scs[method], *geo, u0, v0, p, 2, 4,
                               method == P.M_TVCSAD_W)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert float((got[0] - u0).abs().max()) > 1e-3


def _loop_args(sc, p, nb, seed, weighted=False):
    """The K8 loop's arguments for one warp of the m4 (m5) solve."""
    from faldoi_tpu_torch.core.functionals import _weight2d
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    (ci, cj, oy, ox, ph, pw), u1, u2 = _geometry(p, nb, seed)
    oy, ox, ph, pw = (x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw))
    i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, oy, ox, ph, pw, u1, u2, 3)
    i0p = gather_patches(sc.i0pad[:, :, None], oy, ox, p)[:, :, 0, :].permute(2, 0, 1)
    grad = hypot(gx * gx + gy * gy, 0.01)
    m, n = canvas_masks(ph, pw, p)
    l_t = sc.lambda_ * sc.theta
    if weighted:
        rows, cols = canvas_ids(p, "cpu")
        l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy.long(), ox.long(), cj, ci,
                               p // 2)).contiguous()
    return [u1, u2, u1, u2, csad_b(i0p, i1w, gx, gy, u1, u2, grad, m), gx, gy,
            grad, l_t, m, n, ph, pw, sc.theta, sc.tau, sc.tol * sc.tol]


def test_patch_loop_wrapper_cpu_gate_and_counts(pair_consts):
    """On CPU tensors the wrapper is the twin; a large tol stops every
    canvas after one step (v is that step's v-step), max_iters 0 returns the
    inputs, and the iteration counts stay within max_iters."""
    from faldoi_tpu_torch.ops.csad import (
        csad_patch_loop, csad_patch_loop_plain, csad_vstep_plain,
    )

    scs, _ = pair_consts
    args = _loop_args(scs[P.M_TVCSAD_W], 11, 24, 95, weighted=True)
    before = csad_patch_loop.launches
    got = csad_patch_loop(*args, 4)
    assert csad_patch_loop.launches == before
    want = csad_patch_loop_plain(*args, 4)
    for x, y in zip(got, want):
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
    assert ((got[4] >= 1) & (got[4] <= 4)).all()
    big = list(args)
    big[15] = torch.tensor(1e10, dtype=torch.float32)
    one = csad_patch_loop(*big, 4)
    assert (one[4] == 1).all()
    nv = csad_vstep_plain(*args[:2], *args[4:11])
    assert torch.equal(one[2].nan_to_num(7.0), nv[0].nan_to_num(7.0))
    zero = csad_patch_loop(*args, 0)
    assert (zero[4] == 0).all() and torch.equal(zero[0], args[0])
    with pytest.raises(ValueError, match="P\\*P"):
        csad_patch_loop(*[torch.zeros(2, 33, 33)] * 4, *args[4:], 4)

"""The plain twins of the main path's patch kernels against faldoi_tpu's
functions on the CPU: K13's ``poisson_fill_canvas_plain`` against JAX's
vmapped ``poisson_fill_canvas``, K12's ``_solve_tvl1_family_plain`` against
JAX's ``solve_tvl1`` / ``solve_tvl1_w``, and the two wrappers on CPU
tensors (they take the twins and launch nothing; they refuse canvases past
32 x 32).

The same numpy inputs (from ``default_rng``) go through both.  JAX runs in
the repo's exact configuration (``FALDOI_TOPK=exact FALDOI_WSCATTER=exact
FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0 FALDOI_WARP_PREC=highest``, set for
the module before its first JAX trace) on 35x49 and 29x37 frames, which no
other test traces.  Tolerance: 1e-5 abs in float32, as each kernel's
function is held to JAX; from a solve's second warp on, each cell within
1e-5 or its own spread in JAX, the largest change over eight 1e-6 relative
perturbations of I1 (``_held``), as ``tests/test_torch_parallel.py`` holds
the warps after the first."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op threads
# would oversubscribe them
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
SHAPES = ((35, 49), (29, 37))   # the frames of the cases, of the lanes


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _edge_boxes(rng, b, p, h, w):
    """Boxes of B patches of side p centred on random pixels of an h x w
    image, the four corners and two edges first (JAX's ``_patch_geometry``:
    the box clamps at the image edge, ph, pw < p there)."""
    from faldoi_tpu.core.local_step import _patch_geometry

    idx = rng.choice(h * w, b, replace=False)
    idx[:6] = [0, w - 1, h * w - 1, (h - 1) * w, w // 2, (h // 2) * w]
    return [np.asarray(x) for x in _patch_geometry(jnp.asarray(idx), h, w,
                                                   p // 2)]


def _canvases(rng, kind, b, p, ph, pw):
    """Fill inputs: ``holes`` random cells missing (70%), ``all_hole`` every
    cell missing, ``centre`` only the centre cell known (the seed
    insertion's), ``full`` no hole; NaN and +inf both count as holes."""
    x = rng.uniform(-3, 3, (b, p, p)).astype(np.float32)
    if kind == "holes":
        x[rng.random(x.shape) < 0.7] = np.nan
        x[0, 0, 0] = np.inf
    elif kind == "all_hole":
        x[:] = np.nan
    elif kind == "centre":
        c = x[np.arange(b), np.minimum(p // 2, ph - 1), np.minimum(p // 2, pw - 1)]
        x[:] = np.nan
        x[np.arange(b), np.minimum(p // 2, ph - 1), np.minimum(p // 2, pw - 1)] = c
    return x


@pytest.mark.parametrize("kind", ["holes", "all_hole", "centre", "full"])
@pytest.mark.parametrize("exact", [False, True], ids=["red-black", "exact"])
@pytest.mark.parametrize("p", [3, 11])
def test_fill_twin_matches_jax(p, exact, kind):
    """K13's twin against JAX's vmapped ``poisson_fill_canvas`` on boxes
    clamped at the image edge (ragged ph, pw), both relaxation modes."""
    from faldoi_tpu.ops.poisson import poisson_fill_canvas as jfill
    from faldoi_tpu_torch.ops.poisson import poisson_fill_canvas_plain

    rng = np.random.default_rng(400 + p + exact)
    h, w = SHAPES[0]
    b = 40
    _, _, _, _, ph, pw = _edge_boxes(rng, b, p, h, w)
    assert (ph < p).any() and (pw < p).any()
    x = _canvases(rng, kind, b, p, ph, pw)
    want = jax.vmap(lambda c, a, d: jfill(c, a, d, exact=exact))(
        jnp.asarray(x), ph, pw)
    got = poisson_fill_canvas_plain(T(x), T(ph), T(pw), exact=exact)
    assert bool(torch.isfinite(got).all())
    close(got, want)
    if kind == "all_hole":
        np.testing.assert_array_equal(got.numpy(), 0.0)


def _consts(method, shape, seed, jax_side):
    """A synthetic pair's solver consts (p 11, wr 5): JAX's (when
    ``jax_side``) or the port's, carried over from JAX's arrays."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import solver_consts_from_numpy
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    i0, i1, _, _ = syn.make_pair(*shape, seed=seed, full_shape=(70, 90))
    a, b = (jnp.asarray(x.numpy()) for x in prepare_pair(i0, i1, device="cpu"))
    lam, theta, tau = method_local_params(method, 5)
    jsc = jconsts(method, pad_for_crops(a, 11), b, *centered_gradient(b), lam,
                  theta, tau, 0.01, wr=5, p=11)
    return jsc if jax_side else solver_consts_from_numpy(jsc, "cpu")


def _patches(rng, b, p, shape):
    h, w = shape
    i, j, oy, ox, ph, pw = _edge_boxes(rng, b, p, h, w)
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0, v0 = (np.where(inbox, m + rng.normal(0, 1.0, (b, p, p)), 0)
              .astype(np.float32) for m in (2.6, -1.4))
    return [i, j, oy, ox, ph, pw], u0, v0


# (method, warps, max_iters, tol): tol "freeze" stops every canvas after one
# PD iteration of each warp
SOLVE_CASES = [(m, wa, it, "0.01") for m in (0, 1)
               for wa, it in ((1, 1), (2, 1), (2, 4), (1, 4))] + [
    (m, 2, 4, "freeze") for m in (0, 1)]
SOLVE_SIZES = ((11, 64), (3, 24))   # (P, B): the sweep's, the seed insertion's
FREEZE_TOL = 1e3


def _solve_case(case, jax_side):
    """The consts and the (P, geometry, u0, v0) batches of one case."""
    method, warps, max_iters, tol = case
    sc = _consts(method, SHAPES[0], 410 + method, jax_side)
    if tol == "freeze":
        sc = sc._replace(tol=jnp.float32(FREEZE_TOL) if jax_side else
                         torch.tensor(FREEZE_TOL, dtype=torch.float32))
    rng = np.random.default_rng(420 + 8 * method + 2 * warps + max_iters)
    return sc, [(p, *_patches(rng, b, p, SHAPES[0])) for p, b in SOLVE_SIZES]


def _lanes_case(method, jax_side):
    """Two lanes' consts (two 29x37 pairs), B 48 patches at P 11 and their
    lane index."""
    scs = [_consts(method, SHAPES[1], 430 + 2 * method + k, jax_side)
           for k in (0, 1)]
    rng = np.random.default_rng(440 + method)
    geo, u0, v0 = _patches(rng, 48, 11, SHAPES[1])
    return scs, geo, u0, v0, rng.integers(0, 2, 48)


def _jax_solve_raw(jsc, method, geo, u0, v0, p, warps, max_iters):
    from faldoi_tpu.core.functionals import solve_tvl1, solve_tvl1_w

    solve = solve_tvl1_w if method == 1 else solve_tvl1

    def one(i_, j_, oy_, ox_, ph_, pw_, a_, b_):
        return solve(jsc, i_, j_, oy_, ox_, ph_, pw_, a_, b_,
                     jnp.zeros_like(a_), p, warps, max_iters, p // 2)

    ju, jv, _, je = jax.vmap(one)(*map(jnp.asarray, (*geo, u0, v0)))
    return ju, jv, je


def _jax_solve(jsc, method, geo, u0, v0, p, warps, max_iters):
    return [np.asarray(x) for x in _jax_solve_raw(jsc, method, geo, u0, v0, p,
                                                  warps, max_iters)]


SPREAD_DRAWS = 8   # perturbations a cell's spread is the largest change over


def _jax_spread(jsc, method, geo, u0, v0, p, warps, max_iters, want, seed):
    """Each cell's (and each patch energy's) spread in JAX: the largest
    change of JAX's (u1, u2, ener) over ``SPREAD_DRAWS`` perturbations of
    I1 and its derivatives, each times (1 + 1e-6 noise)
    (tests/test_torch_parallel.py), solved in one vmap over the draws."""
    rng = np.random.default_rng(seed)
    st = np.asarray(jsc.i1_stack)
    sts = (st * (1 + 1e-6 * rng.standard_normal((SPREAD_DRAWS,) + st.shape))
           ).astype(np.float32)

    def run(stk):
        sc = jsc._replace(i1=stk[0], i1x=stk[1], i1y=stk[2], i1_stack=stk)
        return _jax_solve_raw(sc, method, geo, u0, v0, p, warps, max_iters)

    outs = jax.vmap(run)(jnp.asarray(sts))
    return [np.abs(np.asarray(o) - w[None]).max(axis=0)
            for o, w in zip(outs, want)]


def _held(got, jsc, method, geo, u0, v0, p, warps, max_iters, seed):
    """Hold the twin's (u1, u2, ener) to JAX's: within 1e-5 at one warp;
    from the second warp on, cell by cell (and patch by patch for the
    energy), within 1e-5 or that cell's own spread in JAX (``_jax_spread``),
    whichever is larger: the threshold step divides by |grad I1w|^2, which
    the second warp samples at a flow that already differs by ulps (XLA
    contracts multiply-adds into FMAs, the twin and K12 round each
    operation), and a cell where it is small turns that into more than
    1e-5 (1.3e-5 seen here, at P 3, where that cell's spread over eight
    draws reaches 1.6e-5)."""
    want = _jax_solve(jsc, method, geo, u0, v0, p, warps, max_iters)
    if warps > 1:
        spread = _jax_spread(jsc, method, geo, u0, v0, p, warps, max_iters,
                             want, seed)
    for x, y, k in zip(got, want, range(3)):
        if warps == 1:
            close(x, y)
            continue
        x = np.asarray(x)
        atol = np.maximum(ATOL, spread[k])
        bad = ~((np.abs(x - y) <= atol) | (np.isnan(x) & np.isnan(y)))
        assert not bad.any(), (
            f"output {k}: {int(bad.sum())} of {bad.size} cells off JAX by "
            f"more than max(1e-5, their spread); worst "
            f"{float(np.nanmax(np.abs(x - y)[bad])):.3e}")


@pytest.mark.parametrize("n", range(len(SOLVE_CASES)), ids=[
    f"m{m}-warps{wa}-iters{it}-tol{tol}" for m, wa, it, tol in SOLVE_CASES])
def test_solve_twin_matches_jax(n):
    """K12's twin against JAX's ``solve_tvl1`` / ``solve_tvl1_w`` (``_held``),
    vmapped over B 64 patches at P 11 and 24 at P 3 (the seed insertion's),
    boxes clamped at the image edge.  Method 0 at one warp of 4 iterations
    is also ``tests/test_torch_local.py``'s case, on other frames; under the
    freezing tol the result is that of one PD iteration a warp."""
    from faldoi_tpu_torch.core.functionals import _solve_tvl1_family_plain

    method, warps, max_iters, tol = SOLVE_CASES[n]
    jsc, jbatches = _solve_case(SOLVE_CASES[n], True)
    sc, batches = _solve_case(SOLVE_CASES[n], False)
    for (p, geo, u0, v0), (_, jgeo, ju0, jv0) in zip(batches, jbatches):
        got = _solve_tvl1_family_plain(
            sc, *map(T, geo), T(u0), T(v0), p, warps, max_iters, method == 1)
        _held(got, jsc, method, jgeo, ju0, jv0, p, warps, max_iters, 460 + n)
        if tol == "freeze":
            once = _solve_tvl1_family_plain(
                sc, *map(T, geo), T(u0), T(v0), p, warps, 1, method == 1)
            for x, y in zip(once, got):
                assert torch.equal(x, y)


@pytest.mark.parametrize("method", [0, 1])
def test_solve_twin_lanes_match_jax(method):
    """K12's twin on a lane-stacked batch of two lanes (the consts of two
    29x37 pairs, ``stack_solver_consts``), two warps of 4 PD iterations,
    against JAX solving each lane's patches with that lane's consts
    (``_held``)."""
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, stack_solver_consts,
    )

    scs, geo, u0, v0, lane = _lanes_case(method, False)
    jscs = _lanes_case(method, True)[0]
    got = _solve_tvl1_family_plain(
        stack_solver_consts(scs), *map(T, geo), T(u0), T(v0), 11, 2, 4,
        method == 1, T(lane))
    for k, jsc in enumerate(jscs):
        m = lane == k
        _held([x[T(m)] for x in got], jsc, method, [g[m] for g in geo], u0[m],
              v0[m], 11, 2, 4, 470 + 2 * method + k)


def test_wrappers_take_the_twins_on_cpu():
    """On CPU tensors K12's and K13's wrappers return their twins' results
    and launch nothing; the fill of two planes is the twin's of their
    concatenation."""
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, make_solver_consts, solve_tvl1,
        tvl1_patch_solve,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops.poisson import (
        poisson_fill_canvas, poisson_fill_canvas_plain, poisson_fill_planes,
    )

    rng = np.random.default_rng(450)
    h, w = SHAPES[1]
    _, _, _, _, ph, pw = _edge_boxes(rng, 30, 11, h, w)
    u, v = (T(_canvases(rng, "holes", 30, 11, ph, pw)) for _ in range(2))
    ph, pw = T(ph), T(pw)
    fills, solves = poisson_fill_planes.launches, tvl1_patch_solve.launches
    got = poisson_fill_planes((u, v), ph, pw, exact=False)
    want = poisson_fill_canvas_plain(torch.cat([u, v]), torch.cat([ph, ph]),
                                     torch.cat([pw, pw]), exact=False)
    assert torch.equal(torch.cat(got), want)
    assert torch.equal(poisson_fill_canvas(u, ph, pw), poisson_fill_canvas_plain(
        u, ph, pw))
    i0, i1, gf, _ = syn.make_pair(h, w, seed=451)
    a, b = prepare_pair(i0, i1, device="cpu")
    sc = make_solver_consts(a, b, 0.25, 0.3, 0.125, 0.01, 11, 0)
    geo, u0, v0 = _patches(rng, 30, 11, SHAPES[1])
    args = (*map(T, geo), T(u0), T(v0), 11, 1, 4)
    for x, y in zip(solve_tvl1(sc, *args), _solve_tvl1_family_plain(
            sc, *args, False)):
        assert torch.equal(x, y)
    assert (poisson_fill_planes.launches, tvl1_patch_solve.launches) == (
        fills, solves)


def test_wrappers_refuse_canvases_past_32():
    """P * P > 1024 does not fit a block: both wrappers raise, on the CPU
    too, before they launch or run anything."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts, tvl1_patch_solve
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops.poisson import poisson_fill_canvas, poisson_fill_planes

    x = torch.zeros((2, 33, 33))
    box = torch.full((2,), 33)
    with pytest.raises(ValueError, match="P\\*P <= 1024"):
        poisson_fill_canvas(x, box, box)
    with pytest.raises(ValueError, match="one or two"):
        poisson_fill_planes((x, x, x), box, box)
    i0, i1, _, _ = syn.make_pair(40, 48, seed=452)
    a, b = prepare_pair(i0, i1, device="cpu")
    sc = make_solver_consts(a, b, 0.25, 0.3, 0.125, 0.01, 33, 0)
    with pytest.raises(ValueError, match="P\\*P <= 1024"):
        tvl1_patch_solve(sc, box, box, box * 0, box * 0, box, box, x, x, 33, 1,
                         4, False)
    # the largest canvas, 32 x 32, is taken
    assert poisson_fill_canvas(x[:, :32, :32], box - 1, box - 1).shape == (2, 32, 32)

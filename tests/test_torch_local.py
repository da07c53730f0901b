"""The port's local step against faldoi_tpu's: the batched m0 patch solver,
the payload scatters, seed insertion, the warm requeue and ONE strict-mode
sweep from an identical mid-growth state.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; the frame shape 38x54 is traced by no other test, so no jit cache
built under other settings is reused).  The sweep is called with an explicit
``dials`` tuple.  Tolerance: 1e-5 abs in float32; ``fixed`` exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
DIALS = (0, "0", 0.0, 0, "exact", "", 5, "exact", 24)
H, W = 38, 54
BSZ = 64


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


@pytest.fixture(scope="module")
def setup(exact_env):
    """Frames, both directions' consts (JAX and port), seeds."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import solver_consts_from_numpy
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=21, full_shape=(70, 90))
    a, b = (x.numpy() for x in prepare_pair(i0, i1, device="cpu"))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jbx, jby = centered_gradient(jb)
    jsc = jconsts(0, pad_for_crops(ja, 11), jb, jbx, jby, 40.0, 0.3, 0.125,
                  0.01, wr=5, p=11)
    assert jsc.i1_blk is None and jsc.i0_blk is None
    rng = np.random.default_rng(22)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    return dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"), seeds=seeds,
                gf=gf)


@pytest.mark.parametrize("p", [11, 3])
def test_patch_solver_matches_jax(setup, p):
    from faldoi_tpu.core.functionals import solve_tvl1 as jsolve
    from faldoi_tpu.core.local_step import _patch_geometry
    from faldoi_tpu_torch.core.functionals import solve_tvl1

    wr = p // 2
    rng = np.random.default_rng(23 + p)
    b = 96
    idx = rng.choice(H * W, b, replace=False)
    idx[:4] = [0, W - 1, H * W - 1, (H - 1) * W]          # image corners
    i, j, oy, ox, ph, pw = (np.asarray(x) for x in _patch_geometry(
        jnp.asarray(idx), H, W, wr))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0 = np.where(inbox, 2.6 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)
    v0 = np.where(inbox, -1.4 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)

    def one(i_, j_, oy_, ox_, ph_, pw_, a_, b_):
        return jsolve(setup["jsc"], i_, j_, oy_, ox_, ph_, pw_, a_, b_,
                      jnp.zeros_like(a_), p, 1, 4, wr)

    ju, jv, _, je = jax.vmap(one)(*map(jnp.asarray, (i, j, oy, ox, ph, pw, u0, v0)))
    su, sv, ener = solve_tvl1(setup["sc"], *map(T, (i, j, oy, ox, ph, pw)),
                              T(u0), T(v0), p, 1, 4)
    close(su, ju)
    close(sv, jv)
    close(ener, je)


def test_scatter_payloads_match_jax():
    """Duplicate targets and exact key ties: the port's winner rule (last
    update in order) equals XLA's sequential CPU scatter."""
    from faldoi_tpu.core.local_step import _scatter_max_payload, _scatter_min_payload
    from faldoi_tpu_torch.core.local_step import (
        scatter_max_payload, scatter_min_payload,
    )

    rng = np.random.default_rng(24)
    n, m = 50, 400
    q = rng.integers(0, n, m).astype(np.int32)
    e = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), m)     # many ties
    u = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(m).astype(np.float32)
    ok = rng.random(m) < 0.7
    te = rng.choice(np.float32([0.75, 1.25, np.inf]), n + 1)
    tu = rng.standard_normal(n + 1).astype(np.float32)
    tv = rng.standard_normal(n + 1).astype(np.float32)
    je, ju, jv, _ = _scatter_min_payload(*map(jnp.asarray, (te, tu, tv)), None,
                                         *map(jnp.asarray, (q, e, u, v)), None,
                                         jnp.asarray(ok), n)
    pe, pu, pv = scatter_min_payload(*map(T, (te, tu, tv)),
                                     T(q.astype(np.int64)), *map(T, (e, u, v)),
                                     T(ok), n)
    for x, y in ((pe, je), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(x.numpy()[:n], np.asarray(y)[:n])
    kb = np.full(n + 1, -np.inf, np.float32)
    jk, ju, jv, _ = _scatter_max_payload(*map(jnp.asarray, (kb, tu, tv)), None,
                                         *map(jnp.asarray, (q, e, u, v)), None,
                                         jnp.asarray(ok), n, exact=True)
    pk, pu, pv = scatter_max_payload(*map(T, (kb, tu, tv)),
                                     T(q.astype(np.int64)), *map(T, (e, u, v)),
                                     T(ok), n)
    for x, y in ((pk, jk), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(x.numpy()[:n], np.asarray(y)[:n])


def _compare_states(port_state, jax_state, n):
    from faldoi_tpu_torch.core.local_step import GrowState, state_to_numpy

    got = state_to_numpy(port_state)
    for k in GrowState._fields:
        a, b = got[k][:n], np.asarray(getattr(jax_state, k))[:n]
        if k == "fixed":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
            close(a[fin], b[fin])


@pytest.fixture(scope="module")
def seeded(setup):
    """Seed insertion by both implementations, in chunks of 16 seeds."""
    from faldoi_tpu.core.functionals import solve_tvl1 as jsolve
    from faldoi_tpu.core.local_step import LocalSolver, init_state as jinit
    from faldoi_tpu_torch.core.local_step import init_state, insert_seeds

    sal = np.ones(H * W + 1, np.float32)
    ls = LocalSolver(H, W, wr=5, bsz=BSZ, solver=jsolve, warps=1, max_iters=4,
                     seed_bsz=16, with_chi=False)
    jst = ls.insert_seeds(jinit(H, W), setup["seeds"], setup["jsc"],
                          jnp.asarray(sal))
    pst = insert_seeds(init_state(H, W, "cpu"), setup["seeds"], setup["sc"],
                       T(sal), 1, 4, seed_bsz=16)
    return jst, pst, sal


def test_seed_insertion_matches_jax(seeded):
    jst, pst, _ = seeded
    _compare_states(pst, jst, H * W)
    assert int(pst.fixed.sum()) == 30


@functools.partial(jax.jit, static_argnames=("h", "w", "bsz"))
def _jax_sweep(state, sc, trust2d, sal, it, fs, h, w, bsz):
    from faldoi_tpu.core.functionals import solve_tvl1
    from faldoi_tpu.core.local_step import _sweep_body

    return _sweep_body(state, solve_tvl1, sc, trust2d, sal, it, h, w, 5, bsz,
                       1, 4, delta=0.05, fill="patch_rb", floor=4096,
                       relax=False, delta_rel=0.5, floor_scale=fs, block=0,
                       with_chi=False, dials=DIALS)


@pytest.fixture(scope="module")
def mid_growth(setup, seeded):
    """A JAX state a few sweeps into iteration 0."""
    jst, _, sal = seeded
    tr = jnp.ones((H, W), jnp.float32)
    for _ in range(5):
        jst, _ = _jax_sweep(jst, setup["jsc"], tr, jnp.asarray(sal),
                            jnp.int32(0), jnp.int32(64), H, W, BSZ)
    return jst


@pytest.mark.parametrize("iteration", [0, 1])
def test_single_sweep_matches_jax(setup, seeded, mid_growth, iteration):
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    _, _, sal = seeded
    n = H * W
    trust = np.ones((H, W), np.float32)
    if iteration:
        trust[10:16, 20:30] = 0.0                # a pruned hole
    jnp_state = jax.tree.map(np.asarray, mid_growth)
    assert 0.05 < jnp_state.fixed[:n].mean() < 0.9
    fs = 64 if iteration == 0 else 16
    jnew, jacc = _jax_sweep(mid_growth, setup["jsc"], jnp.asarray(trust),
                            jnp.asarray(sal), jnp.int32(iteration),
                            jnp.int32(fs), H, W, BSZ)
    pnew, pacc = sweep_body(state_from_numpy(jnp_state, "cpu"), setup["sc"],
                            T(trust), T(sal), iteration, H, W, 5, BSZ, 1, 4,
                            fs)
    assert pacc == int(jacc) > 0
    _compare_states(pnew, jnew, n)


def test_warm_requeue_matches_jax(seeded):
    from faldoi_tpu.core.match_growing import _warm_requeue
    from faldoi_tpu_torch.core.local_step import state_from_numpy
    from faldoi_tpu_torch.core.match_growing import warm_requeue

    jst = seeded[0]
    rng = np.random.default_rng(25)
    n = H * W
    trust = np.ones(n + 1, np.int32)
    trust[:n][rng.random(n) < 0.01] = 0
    trust[5] = 0                                 # near the top edge
    jout = _warm_requeue(jst, jnp.asarray(trust), n, H, W, 10)
    pout = warm_requeue(state_from_numpy(jax.tree.map(np.asarray, jst), "cpu"),
                        T(trust), H, W, 10)
    _compare_states(pout, jout, n)


def test_state_numpy_round_trip(seeded):
    from faldoi_tpu_torch.core.local_step import state_from_numpy, state_to_numpy

    pst = seeded[1]
    again = state_from_numpy(state_to_numpy(pst), "cpu")
    for a, b in zip(again, pst):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert a.dtype == b.dtype


def test_match_growing_is_method_0_only(setup):
    from faldoi_tpu import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing

    prm = P.Parameters()
    prm.val_method = P.M_NLTVL1
    z = torch.zeros((H, W))
    with pytest.raises(NotImplementedError, match="method 2 not ported yet"):
        match_growing(setup["seeds"], setup["seeds"], z, z, prm)

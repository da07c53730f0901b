"""Method 1 (Gaussian-weighted TV-L1), uniformity pruning, the cold requeue
and the partial-results snapshots of the port, against faldoi_tpu.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; the frame shapes 34x50 and 44x60 are traced by no other test file).
Modules are held within 1e-5 abs in float32 (``fixed`` and the pruning masks
exactly); the cold-requeue m1 slice by EPE against JAX (rg <= 0.05 px,
var <= 0.01 px, 100% fill in both).  Each JAX growing runs once, in a
module-scoped fixture."""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import params as P
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
H, W = 34, 50            # module tests
SH, SW = 44, 60          # the growing runs (slice and snapshots)
BSZ = 64
PBSZ = 16                # the snapshot runs: drains longer than 64 sweeps


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
    """Frames and method-1 consts of the forward direction (JAX and port),
    and seeds."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.models import method_local_params as jparams
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, solver_consts_from_numpy,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=31, full_shape=(70, 90))
    a, b = prepare_pair(i0, i1, device="cpu")
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jbx, jby = centered_gradient(jb)
    lam, theta, tau = jparams(P.M_TVL1_W, 5)
    jsc = jconsts(P.M_TVL1_W, pad_for_crops(ja, 11), jb, jbx, jby, lam, theta,
                  tau, 0.01, wr=5, p=11)
    assert jsc.i1_blk is None and jsc.i0_blk is None and jsc.w1d is not None
    rng = np.random.default_rng(32)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    own = make_solver_consts(a, b, lam, theta, tau, 0.01, 11, P.M_TVL1_W)
    return dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"), own=own,
                seeds=seeds, a=a, b=b, gf=gf, gb=gb)


def test_consts_carry_the_window(setup):
    """make_solver_consts(method=1) builds JAX's w1d; the carried consts
    hold it too; method 0 consts have none."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts

    close(setup["own"].w1d, setup["jsc"].w1d, 0)
    close(setup["sc"].w1d, setup["jsc"].w1d, 0)
    for got, want in zip(setup["own"][:8], setup["sc"][:8]):
        close(got, want)
    assert make_solver_consts(setup["a"], setup["b"], 40.0, 0.3, 0.125, 0.01,
                              11).w1d is None
    with pytest.raises(NotImplementedError, match="method 2 not ported yet"):
        make_solver_consts(setup["a"], setup["b"], 40.0, 0.3, 0.125, 0.01, 11, 2)


def _patches(p, b, seed):
    """B patch geometries of radius p // 2 including the four image corners
    and every edge (clamped boxes), and init canvases."""
    from faldoi_tpu.core.local_step import _patch_geometry

    wr = p // 2
    rng = np.random.default_rng(seed)
    idx = rng.choice(H * W, b, replace=False)
    idx[:8] = [0, W - 1, H * W - 1, (H - 1) * W,              # corners
               3, 2 * W, 3 * W - 1, (H - 1) * W + 7]          # the four edges
    i, j, oy, ox, ph, pw = (np.asarray(x) for x in _patch_geometry(
        jnp.asarray(idx), H, W, wr))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0 = np.where(inbox, 2.6 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)
    v0 = np.where(inbox, -1.4 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)
    assert (ph < p).any() and (pw < p).any()
    return (i, j, oy, ox, ph, pw), u0, v0


@pytest.mark.parametrize("p", [11, 3])
def test_weight2d_matches_jax(setup, p):
    from faldoi_tpu.core.functionals import _weight2d as jweight
    from faldoi_tpu_torch.core.functionals import _weight2d
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    (i, j, oy, ox, _, _), _, _ = _patches(p, 64, 33)
    wr = p // 2
    jrows, jcols = jnp.arange(p)[:, None], jnp.arange(p)[None, :]
    want = jax.vmap(lambda oy_, ox_, cj, ci: jweight(
        setup["jsc"].w1d, jrows, jcols, oy_, ox_, cj, ci, wr))(
        *map(jnp.asarray, (oy, ox, j, i)))
    rows, cols = canvas_ids(p, "cpu")
    got = _weight2d(setup["sc"].w1d, rows, cols, *map(T, (oy, ox, j, i)), wr)
    close(got, want, 0)


@pytest.mark.parametrize("p", [11, 3])
def test_weighted_patch_solver_matches_jax(setup, p):
    from faldoi_tpu.core.functionals import solve_tvl1_w as jsolve
    from faldoi_tpu_torch.core.functionals import solve_tvl1_w

    geo, u0, v0 = _patches(p, 96, 34 + p)
    wr = p // 2

    def one(i_, j_, oy_, ox_, ph_, pw_, a_, b_):
        return jsolve(setup["jsc"], i_, j_, oy_, ox_, ph_, pw_, a_, b_,
                      jnp.zeros_like(a_), p, 1, 4, wr)

    ju, jv, _, je = jax.vmap(one)(*map(jnp.asarray, geo + (u0, v0)))
    su, sv, ener = solve_tvl1_w(setup["sc"], *map(T, geo), T(u0), T(v0), p, 1, 4)
    close(su, ju)
    close(sv, jv)
    close(ener, je)


def test_unported_methods_raise():
    from faldoi_tpu_torch.core.functionals import solver_for, solve_tvl1, solve_tvl1_w

    assert solver_for(0) is solve_tvl1 and solver_for(1) is solve_tvl1_w
    for m in range(2, 9):
        with pytest.raises(NotImplementedError, match=f"method {m} not ported"):
            solver_for(m)


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
    """Method-1 seed insertion by both implementations, chunks of 16."""
    from faldoi_tpu.core.functionals import solve_tvl1_w as jsolve
    from faldoi_tpu.core.local_step import LocalSolver, init_state as jinit
    from faldoi_tpu_torch.core.local_step import init_state, insert_seeds

    sal = np.ones(H * W + 1, np.float32)
    ls = LocalSolver(H, W, wr=5, bsz=BSZ, solver=jsolve, warps=1, max_iters=4,
                     seed_bsz=16, with_chi=False)
    jst = ls.insert_seeds(jinit(H, W), setup["seeds"], setup["jsc"],
                          jnp.asarray(sal))
    pst = insert_seeds(init_state(H, W, "cpu"), setup["seeds"], setup["sc"],
                       T(sal), 1, 4, seed_bsz=16, method=P.M_TVL1_W)
    return jst, pst, sal


def test_weighted_seed_insertion_matches_jax(seeded):
    jst, pst, _ = seeded
    _compare_states(pst, jst, H * W)
    assert int(pst.fixed.sum()) == 30


@functools.partial(jax.jit, static_argnames=("h", "w", "bsz"))
def _jax_sweep(state, sc, trust2d, sal, it, fs, h, w, bsz):
    from faldoi_tpu.core.functionals import solve_tvl1_w
    from faldoi_tpu.core.local_step import _sweep_body

    return _sweep_body(state, solve_tvl1_w, sc, trust2d, sal, it, h, w, 5,
                       bsz, 1, 4, delta=0.05, fill="patch_rb", floor=4096,
                       relax=False, delta_rel=0.5, floor_scale=fs, block=0,
                       with_chi=False, dials=DIALS)


@pytest.fixture(scope="module")
def mid_growth(setup, seeded):
    """A JAX method-1 state a few sweeps into iteration 0."""
    jst, _, sal = seeded
    tr = jnp.ones((H, W), jnp.float32)
    for _ in range(5):
        jst, _ = _jax_sweep(jst, setup["jsc"], tr, jnp.asarray(sal),
                            jnp.int32(0), jnp.int32(64), H, W, BSZ)
    return jst


@pytest.mark.parametrize("iteration", [0, 1])
def test_weighted_sweep_matches_jax(setup, seeded, mid_growth, iteration):
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    _, _, sal = seeded
    n = H * W
    trust = np.ones((H, W), np.float32)
    if iteration:
        trust[8:14, 18:28] = 0.0                 # a pruned hole
    jnp_state = jax.tree.map(np.asarray, mid_growth)
    assert 0.05 < jnp_state.fixed[:n].mean() < 0.9
    fs = 64 if iteration == 0 else 16
    jnew, jacc = _jax_sweep(mid_growth, setup["jsc"], jnp.asarray(trust),
                            jnp.asarray(sal), jnp.int32(iteration),
                            jnp.int32(fs), H, W, BSZ)
    pnew, pacc = sweep_body(state_from_numpy(jnp_state, "cpu"), setup["sc"],
                            T(trust), T(sal), iteration, H, W, 5, BSZ, 1, 4,
                            fs, method=P.M_TVL1_W)
    assert pacc == int(jacc) > 0
    _compare_states(pnew, jnew, n)


def _test_flows(seed):
    """Smooth fwd/bwd flows with a few NaN pixels (unfilled growing)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    fwd = np.stack([2.6 + 2 * np.sin(xx / 7.0) + rng.normal(0, 0.3, (H, W)),
                    -1.4 + 2 * np.cos(yy / 5.0) + rng.normal(0, 0.3, (H, W))], -1)
    bwd = -fwd + rng.normal(0, 1.5, fwd.shape)
    fwd[rng.random((H, W)) < 0.02] = np.nan
    return fwd.astype(np.float32), bwd.astype(np.float32)


@pytest.mark.parametrize("tol", [0.01, 0.05])
def test_uniformity_pruning_matches_jax(setup, tol):
    from faldoi_tpu.core.pruning import prune as jprune, too_uniform_areas as jtu
    from faldoi_tpu_torch.core.pruning import prune, too_uniform_areas

    a, b = setup["a"].clone(), setup["b"].clone()
    a[5:15, 10:25] = 0.5                         # flat areas: uniform for sure
    b[20:30, 30:45] = 0.25
    fwd, bwd = _test_flows(35)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    want = np.asarray(jtu(ja, jb, jnp.asarray(fwd[..., 0]),
                          jnp.asarray(fwd[..., 1]), tol))
    got = too_uniform_areas(a, b, T(fwd[..., 0]), T(fwd[..., 1]), tol).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got == 0).mean() < 0.95       # both outcomes occur
    for use_fb in (True, False):
        jg, jb_ = jprune(ja, jb, jnp.asarray(fwd), jnp.asarray(bwd), 2.0,
                         use_fb=use_fb, use_tu=True, tu_tol=tol)
        pg, pb = prune(a, b, T(fwd), T(bwd), 2.0, use_fb=use_fb, use_tu=True,
                       tu_tol=tol)
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb_))
    pg, pb = prune(a, b, T(fwd), T(bwd), 2.0, use_fb=False)
    assert (pg == 1).all() and (pb == 1).all()


def test_cold_requeue_matches_jax(seeded, mid_growth):
    """delete_untrusted and insert_potential, alone and composed, equal
    JAX's _delete_untrusted / _insert_potential."""
    from faldoi_tpu.core.match_growing import _delete_untrusted, _insert_potential
    from faldoi_tpu_torch.core.local_step import state_from_numpy
    from faldoi_tpu_torch.core.match_growing import (
        delete_untrusted, insert_potential,
    )

    n = H * W
    rng = np.random.default_rng(36)
    trust = np.ones(n + 1, np.int32)
    trust[:n][rng.random(n) < 0.1] = 0
    jst = mid_growth
    pst = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    jdel = _delete_untrusted(jst, jnp.asarray(trust), n)
    pdel = delete_untrusted(pst, T(trust))
    _compare_states(pdel, jdel, n)
    _compare_states(insert_potential(pdel), _insert_potential(jdel, n), n)
    _compare_states(insert_potential(pst), _insert_potential(jst, n), n)


def _slice_pair():
    i0, i1, gf, gb = syn.make_pair(SH, SW, seed=37)
    rng = np.random.default_rng(38)
    go = syn.make_seeds(gf, syn.random_seed_positions(SH, SW, 40, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(SH, SW, 40, rng), rng)
    return i0, i1, go, ba, gf


def _m1_params(mod):
    prm = mod.Parameters()
    prm.val_method = mod.M_TVL1_W
    return prm


@pytest.fixture(scope="module")
def jax_cold_slice(exact_env):
    """JAX's m1 slice with the cold requeue (FALDOI_GROW_WARM_BAND=0)."""
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair
    from faldoi_tpu.models import global_refine

    i0, i1, go, ba, _ = _slice_pair()
    a, b = prepare_pair(i0, i1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FALDOI_GROW_WARM_BAND", "0")
        flow, _, _ = match_growing(go, ba, a, b, _m1_params(JP), bsz=256,
                                   mode="fused")
    u1, u2, _ = global_refine(JP.M_TVL1_W, a, b, b, jnp.asarray(flow[..., 0]),
                              jnp.asarray(flow[..., 1]), JP.Parameters())
    return flow, np.stack([np.asarray(u1), np.asarray(u2)], -1)


def test_cold_m1_slice_matches_jax(jax_cold_slice):
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import global_refine

    i0, i1, go, ba, gf = _slice_pair()
    a, b = prepare_pair(i0, i1, device="cpu")
    stats = {}
    flow, _ = match_growing(go, ba, a, b, _m1_params(P), bsz=256, stats=stats,
                            warm_band=0)
    u1, u2 = global_refine(P.M_TVL1_W, a, b, flow[..., 0].contiguous(),
                           flow[..., 1].contiguous(), P.Parameters())
    prg, pvar = flow.numpy(), torch.stack([u1, u2], -1).numpy()
    jrg, jvar = jax_cold_slice
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()    # 100% fill
    assert syn.epe(prg, jrg) <= 0.05
    assert syn.epe(pvar, jvar) <= 0.01
    assert syn.epe(pvar, gf) < 1.5 and syn.epe(jvar, gf) < 1.5
    assert len(stats["sweeps"]) == 7


def test_method_global_params_match_jax():
    from faldoi_tpu import params as JP
    from faldoi_tpu.models import method_global_params as jgp
    from faldoi_tpu_torch.models import global_refine, method_global_params

    prm = P.Parameters()
    prm.lambda_, prm.theta, prm.tau = 12.0, 0.2, 0.1
    jprm = JP.Parameters(**vars(prm))
    for m in range(9):
        assert method_global_params(m, prm) == jgp(m, jprm)
    z = torch.zeros((8, 8))
    with pytest.raises(NotImplementedError, match="method 4 not ported yet"):
        global_refine(4, z, z, z, z, prm)


def _snapshot_fills(d):
    """{file name: finite fraction of its flow}."""
    from faldoi_tpu_torch.io.flo import read_flo

    return {f: float(np.isfinite(read_flo(os.path.join(d, f))).all(-1).mean())
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def jax_snapshots(exact_env, tmp_path_factory):
    """JAX's match_growing with part_res=1 (m1, warm requeue, bsz 16): its
    snapshots land in ./partial_results."""
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair

    i0, i1, go, ba, _ = _slice_pair()
    a, b = prepare_pair(i0, i1)
    prm = _m1_params(JP)
    prm.part_res = 1
    cwd = tmp_path_factory.mktemp("jax_partial")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        match_growing(go, ba, a, b, prm, bsz=PBSZ, mode="fused")
    return _snapshot_fills(os.path.join(cwd, "partial_results"))


def test_partial_results_snapshots(jax_snapshots, tmp_path, monkeypatch):
    """-partial_res: the port writes the snapshot files JAX writes, each
    with at least its threshold's fill, some of them mid-drain."""
    from faldoi_tpu_torch.cli import local_faldoi
    from faldoi_tpu_torch.io.flo import write_flo

    i0, i1, go, ba, _ = _slice_pair()
    frames = []
    for k, im in enumerate((i0, i1)):
        frames.append(str(tmp_path / f"f{k}.npy"))
        np.save(frames[-1], im.transpose(1, 2, 0))
    (tmp_path / "ims.txt").write_text("\n".join(frames) + "\n")
    write_flo(str(tmp_path / "go.flo"), go)
    write_flo(str(tmp_path / "ba.flo"), ba)
    monkeypatch.chdir(tmp_path)
    # the CLI's growing runs at match_growing's default bsz (4096); drive
    # the library at JAX's bsz for the comparison, and the CLI for the flag
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    a, b = prepare_pair(i0, i1, device="cpu")
    match_growing(go, ba, a, b, _m1_params(P), bsz=PBSZ,
                  snapshot_dir=str(tmp_path / "lib"))
    got = _snapshot_fills(str(tmp_path / "lib"))
    assert sorted(got) == sorted(jax_snapshots)
    assert len(got) == 16           # 4 thresholds x (3 iterations + final)
    for fills in (got, jax_snapshots):
        for name, fill in fills.items():
            assert fill * 100 >= int(name.split("_")[2]), name
        assert min(fills.values()) < 1.0        # a snapshot taken mid-drain
    assert local_faldoi.main(["ims.txt", "go.flo", "ba.flo", "rg.flo",
                              "sim.tiff", "-m", "1", "-partial_res", "1",
                              "-device", "cpu"]) == 0
    cli = _snapshot_fills(str(tmp_path / "partial_results"))
    assert sorted(cli) == sorted(got)

"""The growing's throttles of the port against faldoi_tpu's: ONE strict-mode
sweep from an identical mid-growth state with each throttle at a value off
its default, and one m0 growing with several of them off their defaults and
the warm requeue at band 5 (its cold twin is ``test_torch_throttles_cold.py``,
a file of its own so that xdist runs the two JAX growings side by side).

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 36x52 and 35x49 are traced by no other test file).  JAX's sweep takes
the throttles as arguments; its growing takes them as arguments too, and
reads ``FALDOI_GROW_FS_LATE`` and ``FALDOI_GROW_WARM_BAND`` from its
environment, where the port takes ``floor_scale_late`` and ``warm_band``.
Each throttle must change the sweep (or the growing) in both packages, so a
knob that does not bite cannot pass.  Tolerance: 1e-5 abs in float32 for the
m0 sweeps; ``fixed`` exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
DIALS = (0, "0", 0.0, 0, "exact", "", 5, "exact", 24)
H, W = 36, 52            # the sweeps
GH, GW = 35, 49          # the growing
BSZ = 64
DEFAULTS = dict(delta=0.05, delta_rel=0.5, floor=4096, floor_scale=64,
                floor_scale_hi=0, queue_hi=1 << 30, block=0, fill="patch")
# each case: a base (tightened where the defaults accept the whole batch
# from the test's state, so that the knob can bite), the throttle off its
# default on top of it, and the method
TIGHT = dict(delta=0.0, delta_rel=0.0)
CASES = {
    "delta": ({}, dict(delta=0.001), 0),
    "delta_rel": (dict(delta=0.001), dict(delta_rel=3.0), 0),
    "floor": (dict(TIGHT, floor_scale=1), dict(floor=5), 0),
    "floor_scale": (TIGHT, dict(floor_scale=8), 0),
    "floor_scale_hi": (TIGHT, dict(floor_scale_hi=4, queue_hi=8), 0),
    "block": (dict(delta=0.0, delta_rel=0.1), dict(block=4), 0),
    "fill_patch_exact": ({}, dict(fill="patch_exact"), 0),
    "fill_patch_rb": ({}, dict(fill="patch_rb"), P.M_TVCSAD),
}


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def _compare_states(port_state, jax_state, n, atol):
    """Equal states: ``fixed`` exactly, the same NaN and finite cells, the
    finite values within ``atol`` (None: within a mean of 1e-5 and 3e-3 at
    the worst cell)."""
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
            d = np.abs(a[fin] - b[fin])
            if atol is None:
                assert d.mean() <= ATOL and d.max() <= 3e-3, k
            else:
                np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=atol,
                                           err_msg=k)


def _differs(s1, s2, n):
    from faldoi_tpu_torch.core.local_step import state_to_numpy

    a, b = state_to_numpy(s1), state_to_numpy(s2)
    return any(not np.array_equal(np.nan_to_num(a[k][:n], nan=7.0),
                                  np.nan_to_num(b[k][:n], nan=7.0)) for k in a)


@pytest.fixture(scope="module")
def setup(exact_env):
    """Frames, the m0 and m4 consts (JAX and port), a mid-growth JAX state
    of each: 30 seeds inserted, then 4 sweeps at the defaults."""
    from faldoi_tpu.core.functionals import SOLVERS as JSOLVERS
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.local_step import LocalSolver, init_state as jinit
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.models import method_local_params as jparams
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import solver_consts_from_numpy
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(H, W, seed=101, full_shape=(70, 90))
    a, b = (x.numpy() for x in prepare_pair(i0, i1, device="cpu"))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jbx, jby = centered_gradient(jb)
    rng = np.random.default_rng(102)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    sal = np.ones(H * W + 1, np.float32)
    tr = jnp.ones((H, W), jnp.float32)
    out = {}
    for m in (0, P.M_TVCSAD):
        jsc = jconsts(m, pad_for_crops(ja, 11), jb, jbx, jby, *jparams(m, 5),
                      0.01, wr=5, p=11)
        ls = LocalSolver(H, W, wr=5, bsz=BSZ, solver=JSOLVERS[m], warps=1,
                         max_iters=4, seed_bsz=16, with_chi=False)
        jst = ls.insert_seeds(jinit(H, W), seeds, jsc, jnp.asarray(sal))
        for _ in range(4):
            jst, _ = _jax_sweep(jst, jsc, tr, jnp.asarray(sal), jnp.int32(0), m,
                                tuple(sorted(DEFAULTS.items())))
        out[m] = dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"), jst=jst)
    out["sal"] = sal
    return out


@functools.partial(jax.jit, static_argnames=("method", "throttles"))
def _jax_sweep(state, sc, trust2d, sal, it, method, throttles):
    from faldoi_tpu.core.functionals import SOLVERS as JSOLVERS
    from faldoi_tpu.core.local_step import _sweep_body

    th = dict(throttles)
    # JAX's match_growing resolves "patch" per method, "patch_exact" to its
    # "patch" (the exact raster fill), before the sweep sees it
    fill = th.pop("fill")
    if fill == "patch" and method not in (4, 5, 6, 7):
        fill = "patch_rb"
    elif fill == "patch_exact":
        fill = "patch"
    return _sweep_body(state, JSOLVERS[method], sc, trust2d, sal, it, H, W, 5,
                       BSZ, 1, 4, fill=fill, relax=False, with_chi=False,
                       dials=DIALS, **th)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_throttle_matches_jax(setup, case):
    """One iteration-1 sweep (a pruned hole in the trust map) with the
    throttle off its default: the port's state equals JAX's, and differs
    from the port's sweep without that throttle (its case's base: the
    defaults, tightened where they accept the whole batch from this
    state).  The m4 case (the red-black fill, where m4's default is the
    exact one) holds ``fixed`` exactly and the other planes within a mean
    of 1e-5 and 3e-3 at the worst cell: the CSAD solve amplifies XLA's FMA
    roundings ~1e4-fold (``test_torch_csad.py``); measured, one working-flow
    cell of 1697 off by 1.7e-3, every other within 1e-4."""
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    base, th, m = CASES[case]
    c = setup[m]
    sal = setup["sal"]
    n = H * W
    trust = np.ones((H, W), np.float32)
    trust[10:16, 20:30] = 0.0
    jnp_state = jax.tree.map(np.asarray, c["jst"])
    assert 0.02 < jnp_state.fixed[:n].mean() < 0.9
    args = dict(DEFAULTS, **base, **th)
    jnew, jacc = _jax_sweep(c["jst"], c["jsc"], jnp.asarray(trust),
                            jnp.asarray(sal), jnp.int32(1), m,
                            tuple(sorted(args.items())))

    def port(kw):
        kw = dict(kw)
        return sweep_body(state_from_numpy(jnp_state, "cpu"), c["sc"], T(trust),
                          T(sal), 1, H, W, 5, BSZ, 1, 4, kw.pop("floor_scale"), m,
                          **kw)

    pnew, pacc = port(args)
    assert pacc == int(jacc) > 0
    _compare_states(pnew, jnew, n, ATOL if m == 0 else None)
    bnew, bacc = port(dict(DEFAULTS, **base))
    assert _differs(pnew, bnew, n)


def test_sweep_refuses_the_dense_fill(setup):
    """The fills' resolution; since the dense fill is ported (K10) it is
    taken and is no patch fill (``test_torch_ordering.py`` holds its sweep
    against JAX's); an unknown fill is refused."""
    from faldoi_tpu_torch.core.local_step import exact_fill

    assert exact_fill("patch", 0) is False and exact_fill("patch", 4) is True
    assert exact_fill("patch_exact", 1) is True
    assert exact_fill("patch_rb", 7) is False
    assert exact_fill("dense", 0) is False and exact_fill("dense", 4) is False
    with pytest.raises(ValueError, match="fill"):
        exact_fill("raster", 0)


# the growing's throttles off their defaults (floor_scale 8 makes JAX's late
# scale min(8, 16) = 8)
GROW = dict(delta=0.1, delta_rel=0.4, floor=256, floor_scale=8,
            floor_scale_hi=4, queue_hi=400, block=16)


def growing_case(warm_band, fs_late):
    """The m0 growing at GH x GW, one outer iteration, by JAX (fused) with
    ``GROW`` as arguments and FALDOI_GROW_WARM_BAND / FALDOI_GROW_FS_LATE
    in its environment, and by the port with the same values as arguments
    and with its defaults.  Returns (JAX's, the port's, the port's default)
    flows and the port's stats."""
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(GH, GW, seed=103)
    rng = np.random.default_rng(104)
    go = syn.make_seeds(gf, syn.random_seed_positions(GH, GW, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(GH, GW, 30, rng), rng)

    def prm(mod):
        p = mod.Parameters()
        p.iterations_of = 1
        return p

    ja, jb = jprepare(i0, i1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FALDOI_GROW_WARM_BAND", str(warm_band))
        if fs_late is not None:
            mp.setenv("FALDOI_GROW_FS_LATE", str(fs_late))
        jrg, _, _ = jmatch(go, ba, ja, jb, prm(JP), bsz=BSZ, mode="fused",
                           **GROW)
    a, b = prepare_pair(i0, i1, device="cpu")
    stats = {}
    rg, _, _ = match_growing(go, ba, a, b, prm(P), bsz=BSZ, stats=stats,
                             warm_band=warm_band, floor_scale_late=fs_late,
                             **GROW)
    dflt, _, _ = match_growing(go, ba, a, b, prm(P), bsz=BSZ)
    return jrg, rg.numpy(), dflt.numpy(), stats


def check_growing(jrg, prg, dflt, stats):
    """The port's throttled growing equals JAX's (rg EPE <= 0.05 px, 100%
    fill) and moves away from the port's default growing by more."""
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()
    gap = syn.epe(prg, jrg)
    assert gap <= 0.05
    assert syn.epe(prg, dflt) > max(gap, 1e-3)
    assert syn.epe(jrg, dflt) > max(gap, 1e-3)
    assert [(s["it"], s["lane"]) for s in stats["sweeps"]] == [
        (0, "fwd"), (0, "bwd"), (1, "fwd")]


def test_growing_throttles_match_jax_warm():
    """Warm requeue at band 5, the late floor scale at its default (JAX's
    min(floor_scale, 16) = 8)."""
    check_growing(*growing_case(5, None))

"""The growing's ordering modes of the port against faldoi_tpu's, sweep by
sweep: ONE sweep (``local_step.sweep_body``) from an identical mid-growth
state against JAX's ``_sweep_body`` under label-correcting relax, the exact
window-min acceptance (bands 0, 1 and 2; odd and even windows), the
contested-accept deferral and the dense fill, each alone and some together;
and one ``polish_lanes`` pass against JAX's ``polish_all``.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module), and its sweep gets
the ordering dials as an explicit ``dials`` tuple: its growings read them
from the environment once, at trace time.  39x53 is traced by no other test
file.  Each mode must change the sweep, so a dial that does not bite cannot
pass.  Tolerance: 1e-5 abs in float32; ``fixed`` exactly."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 39, 53
BSZ = 64
STRICT = dict(delta=0.05, delta_rel=0.5, floor=4096, floor_scale=64)


def dials(exactmin=0, band="0", defer=0.0, defer_win=0):
    """JAX's ``ordering_dials()`` tuple in the exact configuration."""
    return (exactmin, band, defer, defer_win, "exact", "", 5, "exact", 24)


# name: (the state to start from, the iteration, the sweep's throttles and
# modes as the port takes them; the case without the mode is the same with
# relax, exactmin, defer and fill at their defaults)
CASES = {
    "relax": ("relax", 1, dict(relax=True, floor=BSZ)),
    # a batch wide enough to reach the re-claims behind the frontier
    "relax_reclaims": ("relax", 1, dict(relax=True, floor=1024, bsz=1024,
                                        floor_scale=1)),
    "exactmin_11_band0": ("strict", 1, dict(exactmin=11)),
    "exactmin_6_band0": ("strict", 1, dict(exactmin=6)),
    "exactmin_10_band1": ("strict", 1, dict(exactmin=10, exactmin_band="1")),
    "exactmin_11_band2": ("strict", 1, dict(exactmin=11, exactmin_band="2",
                                            floor_scale=8)),
    "exactmin_7_relax": ("relax", 1, dict(relax=True, floor=BSZ, exactmin=7)),
    # the deferral on a sweep that accepts the whole batch (floor scale 1)
    "defer_win21": ("strict", 1, dict(defer=0.01, defer_win=21,
                                      floor_scale=1)),
    "defer_win0": ("strict", 1, dict(defer=0.003, floor_scale=1)),
    "defer_relax": ("relax", 1, dict(relax=True, floor=BSZ, defer=0.02,
                                     defer_win=12, floor_scale=1)),
    "dense_it0": ("strict", 0, dict(fill="dense")),
    "dense_it1": ("strict", 1, dict(fill="dense")),
    "dense_relax": ("relax", 1, dict(relax=True, floor=BSZ, fill="dense")),
}


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def compare_states(port_state, jax_state, n, wide=False):
    """Equal states: ``fixed`` exactly, the same NaN and finite cells, the
    finite values within ``ATOL`` (``wide``: within a mean of 1e-6 and 1e-4
    at the worst cell)."""
    from faldoi_tpu_torch.core.local_step import GrowState, state_to_numpy

    got = state_to_numpy(port_state)
    for k in GrowState._fields:
        a, b = got[k][:n], np.asarray(getattr(jax_state, k))[:n]
        if k == "fixed":
            np.testing.assert_array_equal(a, b)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        d = np.abs(a[fin] - b[fin])
        if wide and d.size:
            assert d.mean() <= 1e-6 and d.max() <= 1e-4, (k, d.mean(), d.max())
        else:
            assert d.max(initial=0.0) <= ATOL, (k, d.max())


def differs(s1, s2, n):
    from faldoi_tpu_torch.core.local_step import state_to_numpy

    a, b = state_to_numpy(s1), state_to_numpy(s2)
    return any(not np.array_equal(np.nan_to_num(a[k][:n], nan=7.0),
                                  np.nan_to_num(b[k][:n], nan=7.0)) for k in a)


@functools.partial(jax.jit, static_argnames=("kw", "dl", "bsz"))
def _jax_sweep(state, sc, trust2d, sal, it, kw, dl, bsz):
    from faldoi_tpu.core.functionals import solve_tvl1
    from faldoi_tpu.core.local_step import _sweep_body

    kw = dict(kw)
    fill = kw.pop("fill", "patch_rb")
    return _sweep_body(state, solve_tvl1, sc, trust2d, sal, it, H, W, 5, bsz,
                       1, 4, fill=fill, with_chi=False, dials=dl, **kw)


def jax_args(kw):
    """The port's sweep keywords as JAX's ``_sweep_body`` arguments and
    dials: relax and the throttles are arguments, exactmin and defer dials;
    "patch" is JAX's "patch_rb" for method 0; the batch size apart."""
    kw = dict(STRICT, **kw)
    bsz = kw.pop("bsz", BSZ)
    dl = dials(kw.pop("exactmin", 0), kw.pop("exactmin_band", "0"),
               kw.pop("defer", 0.0), kw.pop("defer_win", 0))
    kw.setdefault("relax", False)
    kw["fill"] = {"patch": "patch_rb"}.get(kw.get("fill", "patch"),
                                           kw.get("fill", "patch"))
    return tuple(sorted(kw.items())), dl, bsz


@pytest.fixture(scope="module")
def setup(exact_env):
    """Frames, the m0 consts (JAX and port), and two mid-growth JAX states:
    40 seeds inserted, then 5 strict sweeps, or 8 relax sweeps accepting
    the whole top-k batch (which leaves fixed pixels with lower claims)."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.functionals import solve_tvl1
    from faldoi_tpu.core.local_step import LocalSolver, init_state as jinit
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.models import method_local_params as jparams
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import solver_consts_from_numpy
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(H, W, seed=131, full_shape=(80, 100))
    a, b = (x.numpy() for x in prepare_pair(i0, i1, device="cpu"))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jbx, jby = centered_gradient(jb)
    rng = np.random.default_rng(132)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(H, W, 40, rng), rng)
    sal = np.ones(H * W + 1, np.float32)
    jsal = jnp.asarray(sal)
    tr = jnp.ones((H, W), jnp.float32)
    jsc = jconsts(0, pad_for_crops(ja, 11), jb, jbx, jby, *jparams(0, 5), 0.01,
                  wr=5, p=11)
    ls = LocalSolver(H, W, wr=5, bsz=BSZ, solver=solve_tvl1, warps=1,
                     max_iters=4, seed_bsz=16, with_chi=False)
    seeded = ls.insert_seeds(jinit(H, W), seeds, jsc, jsal)
    states = {}
    for name, steps, kw in (("strict", 5, {}),
                            ("relax", 8, dict(relax=True, floor=BSZ))):
        st = seeded
        args = jax_args(kw)
        for _ in range(steps):
            st, _ = _jax_sweep(st, jsc, tr, jsal, jnp.int32(0), *args)
        states[name] = jax.tree.map(np.asarray, st)
    trust = np.ones((H, W), np.float32)
    trust[12:19, 22:33] = 0.0
    return dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"),
                states=states, sal=sal, trust=trust)


def test_relax_state_has_reclaims(setup):
    """The relax state holds fixed pixels whose candidate beats their
    energy (what a relax sweep pops again), the strict state none."""
    n = H * W
    for name, want in (("relax", True), ("strict", False)):
        st = setup["states"][name]
        fixed = st.fixed[:n]
        better = st.cand_e[:n] < st.ene[:n] * np.float32(0.95) - np.float32(1e-6)
        assert bool((fixed & better).any()) is want, name
        assert 0.05 < fixed.mean() < 0.9


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_mode_matches_jax(setup, case):
    """One sweep with the mode on: the port's state equals JAX's, accepts as
    many, and differs from the port's sweep without the mode."""
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    start, it, kw = CASES[case]
    jst = setup["states"][start]
    n = H * W
    trust, sal = setup["trust"], setup["sal"]
    jnew, jacc = _jax_sweep(jax.tree.map(jnp.asarray, jst), setup["jsc"],
                            jnp.asarray(trust), jnp.asarray(sal),
                            jnp.int32(it), *jax_args(kw))

    def port(extra):
        args = dict(STRICT, **extra)
        return sweep_body(state_from_numpy(jst, "cpu"), setup["sc"], T(trust),
                          T(sal), it, H, W, 5, args.pop("bsz", BSZ), 1, 4,
                          args.pop("floor_scale"), 0, **args)

    pnew, pacc = port(kw)
    assert pacc == int(jacc) > 0
    # a batch of 1024 patch solves: a few cells move by more than 1e-5 under
    # XLA's FMA contractions (measured: one candidate 1.3e-5 px off)
    compare_states(pnew, jnew, n, wide=kw.get("bsz", BSZ) > BSZ)
    off = {k: v for k, v in kw.items()
           if k not in ("exactmin", "exactmin_band", "defer", "defer_win",
                        "fill", "relax", "bsz")}
    if "relax" in kw and any(k in kw for k in ("exactmin", "defer", "fill")):
        off["relax"] = True     # the mode on top of relax
    bnew, _ = port(off)
    assert differs(pnew, bnew, n)


def test_relax_pops_reclaims(setup):
    """The relax sweep of ``relax_reclaims`` fixes pixels again: some that
    were fixed before it take a lower energy, the unbiased cand_e that
    popped them."""
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    jst = setup["states"]["relax"]
    n = H * W
    st, _ = sweep_body(state_from_numpy(jst, "cpu"), setup["sc"],
                       T(setup["trust"]), T(setup["sal"]), 1, H, W, 5, 1024, 1,
                       4, 1, 0, relax=True, floor=1024)
    was = jst.fixed[:n]
    claim = jst.cand_e[:n] < jst.ene[:n] * np.float32(0.95) - np.float32(1e-6)
    ene = st.ene[:n].numpy()
    repop = was & claim & (ene < jst.ene[:n])
    assert repop.any()
    # each re-popped pixel's energy is its claim or a later improvement
    assert (ene[repop] <= jst.cand_e[:n][repop]).all()


def test_window_reduce_pads_as_xla_same():
    """``_window_reduce`` against ``lax.reduce_window(..., "SAME")`` for odd
    and even windows, min and max, with infinities."""
    from faldoi_tpu_torch.core.local_step import _window_reduce

    rng = np.random.default_rng(133)
    x = rng.normal(size=(2, 9, 13)).astype(np.float32)
    x[0, 2, 3] = np.inf
    x[1, 5, :] = -np.inf
    for k in (1, 2, 4, 5, 10, 11):
        for op, init, fn in (("min", jnp.inf, jax.lax.min),
                             ("max", -jnp.inf, jax.lax.max)):
            want = jax.lax.reduce_window(
                jax.lax.reduce_window(jnp.asarray(x), init, fn, (1, 1, k),
                                      (1, 1, 1), "SAME"),
                init, fn, (1, k, 1), (1, 1, 1), "SAME")
            got = _window_reduce(torch.as_tensor(x), k, op)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sweep_refuses_bad_band(setup):
    from faldoi_tpu_torch.core.local_step import state_from_numpy, sweep_body

    with pytest.raises(ValueError, match="exactmin_band"):
        sweep_body(state_from_numpy(setup["states"]["strict"], "cpu"),
                   setup["sc"], T(setup["trust"]), T(setup["sal"]), 1, H, W, 5,
                   BSZ, 1, 4, 64, 0, exactmin=5, exactmin_band="3")


def test_polish_matches_jax(setup):
    """One polish pass from a fully grown state (every pixel fixed, the
    strict state drained by the port) against JAX's ``polish_all``, and from
    the mid-growth state (unfixed pixels keep theirs).  A pass re-solves
    every fixed pixel's patch (4 PD iterations), where XLA's FMA
    contractions move a few cells' results by more than 1e-5 (measured: 5
    cells of 2067 off by up to 2.9e-5 px, energies by 1.6e-5), so the
    states are held within a mean of 1e-6 and 1e-4 at the worst cell."""
    from faldoi_tpu.core.functionals import solve_tvl1
    from faldoi_tpu.core.local_step import polish_all
    from faldoi_tpu_torch.core.local_step import (
        drain, lane_state, polish_lanes, state_from_numpy, state_to_numpy,
        stack_states,
    )

    n = H * W
    start = state_from_numpy(setup["states"]["strict"], "cpu")
    full, _ = drain(start, setup["sc"], torch.ones((H, W)), T(setup["sal"]), 0,
                    H, W, 5, BSZ, 1, 4, 64, 0)
    assert bool(full.fixed[:n].all())
    sal = setup["sal"].copy()
    sal[:n] = np.linspace(0.8, 1.2, n, dtype=np.float32)
    for st in (full, start):
        jst = jax.tree.map(jnp.asarray, state_to_numpy(st))
        from faldoi_tpu.core.local_step import GrowState as JState

        want = polish_all(JState(**jst), setup["jsc"], jnp.asarray(sal),
                          solve_tvl1, H, W, 5, 256, 1, 4)
        got = lane_state(polish_lanes(stack_states([st]), setup["sc"],
                                      T(sal)[None], H, W, 5, 256, 1, 4, 0), 0)
        compare_states(got, want, n, wide=True)
        assert differs(got, st, n)

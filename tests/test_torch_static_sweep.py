"""The drains' fixed-shape sweep and drain of methods 0 and 1
(``local_step.sweep_static``, ``drain_lanes``), which read nothing back a
sweep, against JAX's ``_sweep_body`` and against the port's sweep with a
batch of the accepted candidates only (``sweep_lanes``, one host read a
sweep).

* One sweep of m0 and m1, one and two lanes, outer iterations 0 and 1 (a
  pruned hole in the trust map), from a mid-growth state carried into both
  packages (``state_from_numpy`` / JAX's ``GrowState``), against JAX's
  ``_sweep_body`` lane by lane: the accepted counts and ``fixed`` exactly,
  NaN where NaN, the other planes within 1e-5 abs (the patch solve's float
  arithmetic is not JAX's: XLA contracts a*b+c into FMAs on the CPU; the
  selection and the scatters are held bit for bit in
  test_torch_select_scatter.py).
* The same sweeps and the ordering modes (relax, block-local bands,
  exactmin, defer, a lane subset) against ``sweep_lanes``: bit for bit on
  every lane's h*w cells (tolerance 0: the same kernels' twins on the same
  accepted canvases; the dump slots left out, their content is
  unspecified).
* Whole drains against the sweep-by-sweep drain that left drained lanes
  out: the states bit for bit, each lane's sweep count, the partial-results
  snapshots (``on_chunk``) where they fell, and the host reads: at most
  ceil(sweeps / SYNC_SWEEPS) + 1 a drain.

JAX runs under the repo's exact dials (module-scoped environment) at a
frame shape no other test traces (36x46)."""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import synthetic as syn

torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
DIALS = (0, "0", 0.0, 0, "exact", "", 5, "exact", 24)
H, W = 36, 46
BSZ = 64
# the drains run on a smaller crop of the same pair
DH, DW = 24, 30


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def grow(method, h, w, sweeps, seed=31):
    """Both lanes (fwd, bwd) of a synthetic pair, method 0 or 1: JAX's and
    the port's consts, and the port's state after seed insertion and
    ``sweeps`` sweeps of iteration 0."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import (
        solver_consts_from_numpy, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, stack_states, sweep_lanes,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(h, w, seed=seed, full_shape=(70, 90))
    a, b = (x.numpy() for x in prepare_pair(i0, i1, device="cpu"))
    rng = np.random.default_rng(seed + 1)
    jscs, scs, sts = [], [], []
    sal = torch.ones(h * w + 1)
    for src, dst, g, cnt in ((a, b, gf, 14), (b, a, gb, 11)):
        jd = jnp.asarray(dst)
        jdx, jdy = centered_gradient(jd)
        jsc = jconsts(method, pad_for_crops(jnp.asarray(src), 11), jd, jdx, jdy,
                      40.0, 0.3, 0.125, 0.01, wr=5, p=11)
        sc = solver_consts_from_numpy(jsc, "cpu")
        seeds = syn.make_seeds(g, syn.random_seed_positions(h, w, cnt, rng), rng)
        jscs.append(jsc)
        scs.append(sc)
        sts.append(insert_seeds(init_state(h, w, "cpu"), seeds, sc, sal, 1, 4,
                                seed_bsz=16, method=method))
    sc2 = stack_solver_consts(scs)
    st = stack_states(sts)
    ones = torch.ones((2, h, w))
    sal2 = torch.ones((2, h * w + 1))
    for _ in range(sweeps):
        st, _ = sweep_lanes(st, sc2, ones, sal2, 0, h, w, 5, BSZ, 1, 4, 64,
                            method)
    return dict(jscs=jscs, scs=scs, sc2=sc2, state=st, sal=sal2)


@pytest.fixture(scope="module", params=[0, 1])
def mid(request):
    g = grow(request.param, H, W, 5)
    fixed = g["state"].fixed[:, :H * W].float().mean(1)
    assert ((0.05 < fixed) & (fixed < 0.9)).all()
    g["method"] = request.param
    return g


@functools.partial(jax.jit, static_argnames=("method", "h", "w", "bsz"))
def _jax_sweep(state, sc, trust2d, sal, it, fs, method, h, w, bsz):
    from faldoi_tpu.core.functionals import solve_tvl1, solve_tvl1_w
    from faldoi_tpu.core.local_step import _sweep_body

    return _sweep_body(state, (solve_tvl1, solve_tvl1_w)[method], sc, trust2d,
                       sal, it, h, w, 5, bsz, 1, 4, delta=0.05,
                       fill="patch_rb", floor=4096, relax=False,
                       delta_rel=0.5, floor_scale=fs, block=0,
                       with_chi=False, dials=DIALS)


def trust_map(iteration, lanes):
    tr = torch.ones((lanes, H, W))
    if iteration:
        tr[:, 10:16, 20:30] = 0.0                # a pruned hole
    return tr


def sub_state(st, lanes):
    from faldoi_tpu_torch.core.local_step import GrowState

    return GrowState(*(t[:lanes].clone() for t in st))


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("iteration", [0, 1])
def test_static_sweep_matches_jax(mid, lanes, iteration):
    from faldoi_tpu.core.local_step import GrowState as JState
    from faldoi_tpu_torch.core.local_step import (
        GrowState, lane_state, state_to_numpy, sweep_static,
    )

    n = H * W
    fs = 64 if iteration == 0 else 16
    st = sub_state(mid["state"], lanes)
    sc = mid["sc2"] if lanes == 2 else mid["scs"][0]
    tr = trust_map(iteration, lanes)
    new, counts = sweep_static(st, sc, tr, mid["sal"][:lanes], iteration, H, W,
                               5, BSZ, 1, 4, fs, mid["method"])
    assert isinstance(counts, torch.Tensor) and tuple(counts.shape) == (lanes,)
    for ln in range(lanes):
        jst = JState(**{k: jnp.asarray(v) for k, v in
                        state_to_numpy(lane_state(st, ln)).items()})
        jnew, jacc = _jax_sweep(jst, mid["jscs"][ln], jnp.asarray(tr[ln].numpy()),
                                jnp.asarray(mid["sal"][ln].numpy()),
                                jnp.int32(iteration), jnp.int32(fs),
                                mid["method"], H, W, BSZ)
        assert int(counts[ln]) == int(jacc) > 0
        got = state_to_numpy(lane_state(new, ln))
        for k in GrowState._fields:
            a, b = got[k][:n], np.asarray(getattr(jnew, k))[:n]
            if k == "fixed":
                np.testing.assert_array_equal(a, b)
                continue
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=ATOL,
                                       err_msg=k)


def same_cells(a, b, n):
    """Two lane-stacked states equal bit for bit on every lane's h*w cells."""
    for x, y in zip(a, b):
        x, y = x[:, :n].contiguous(), y[:, :n].contiguous()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


MODES = {
    "it0": (0, {}),
    "it1_hole": (1, {}),
    "relax": (1, dict(relax=True, floor=BSZ)),
    "block": (0, dict(block=8)),
    "exactmin": (0, dict(exactmin=11, exactmin_band="2")),
    "defer": (0, dict(defer=0.25, defer_win=7)),
    "lane1": (0, dict(lanes=[1])),
    "staged": (0, dict(floor=16, floor_scale_hi=4, queue_hi=50)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_static_sweep_equals_sweep_lanes(mid, mode):
    from faldoi_tpu_torch.core.local_step import sweep_lanes, sweep_static

    iteration, kw = MODES[mode]
    n = H * W
    st = mid["state"]
    args = (mid["sc2"], trust_map(iteration, 2), mid["sal"], iteration, H, W,
            5, BSZ, 1, 4, 16, mid["method"])
    want, wcounts = sweep_lanes(st, *args, **kw)
    got, counts = sweep_static(st, *args, **kw)
    assert counts.tolist() == wcounts and sum(wcounts) > 0
    same_cells(got, want, n)


def sweep_by_sweep(state, sc, trust, sal, method, lanes, on_chunk, chunk,
                   **kw):
    """The drain as the port ran it before the fixed-shape sweep: a sweep of
    the lanes still active, its counts read back, a drained lane left out
    after its first empty sweep."""
    from faldoi_tpu_torch.core.local_step import lane_state, sweep_lanes

    order = list(range(state.fixed.shape[0])) if lanes is None else list(lanes)
    sweeps = dict.fromkeys(order, 0)
    active = order
    while active:
        state, counts = sweep_lanes(state, sc, trust, sal, 0, DH, DW, 5, BSZ,
                                    1, 4, 64, method, lanes=active, **kw)
        for lane in active:
            sweeps[lane] += 1
        if 0 in active and (counts[active.index(0)] == 0
                            or sweeps[0] % chunk == 0):
            on_chunk(lane_state(state, 0))
        active = [lane for lane, c in zip(active, counts) if c > 0]
    return state, [sweeps[lane] for lane in order]


@pytest.mark.parametrize("sync,chunk,lanes,method,kw", [
    (8, 64, None, 0, {}),
    (2, 8, None, 0, {}),
    (4, 8, [0], 1, {}),
    (4, 16, None, 0, dict(relax=True, floor=BSZ)),
])
def test_static_drain_equals_sweep_by_sweep(monkeypatch, sync, chunk, lanes,
                                            method, kw):
    from faldoi_tpu_torch.core import local_step

    monkeypatch.setattr(local_step, "SYNC_SWEEPS", sync)
    monkeypatch.setattr(local_step, "CHUNK", chunk)
    g = grow(method, DH, DW, 0, seed=37)
    n = DH * DW
    trust = torch.ones((2, DH, DW))
    snaps = {"static": [], "ref": []}

    def keep(key):
        return lambda st: snaps[key].append(st.out_u[:n].clone())

    want, wsweeps = sweep_by_sweep(g["state"], g["sc2"], trust, g["sal"],
                                   method, lanes, keep("ref"), chunk, **kw)
    drained = []
    got, sweeps = local_step.drain_lanes(
        g["state"], g["sc2"], trust, g["sal"], 0, DH, DW, 5, BSZ, 1, 4, 64,
        method, lanes=lanes, on_chunk=keep("static"), reads=drained, **kw)
    assert sweeps == wsweeps and max(sweeps) > 2 * sync
    same_cells(got, want, n)
    assert len(snaps["static"]) == len(snaps["ref"]) >= 1
    for a, b in zip(snaps["static"], snaps["ref"]):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    (ran, reads), = drained
    assert max(sweeps) <= ran < max(sweeps) + sync
    assert reads <= math.ceil(max(sweeps) / sync) + 1


def test_one_lane_drain_is_static_for_m0_and_m1_only():
    """``drain`` (one lane) takes the fixed-shape drain for methods 0 and 1
    under the patch fills, and ``sweep_static`` refuses the others."""
    from faldoi_tpu_torch.core import local_step

    g = grow(1, DH, DW, 0, seed=41)
    one = local_step.lane_state(g["state"], 0)
    drained = []
    st, k = local_step.drain(one, g["scs"][0], torch.ones((DH, DW)),
                             g["sal"][0], 0, DH, DW, 5, BSZ, 1, 4, 64, 1,
                             reads=drained)
    assert len(drained) == 1 and k > 1
    ref, wk = sweep_by_sweep(g["state"], g["sc2"], torch.ones((2, DH, DW)),
                             g["sal"], 1, [0], lambda s: None, 64)
    assert k == wk[0]
    n = DH * DW
    for x, y in zip(st, local_step.lane_state(ref, 0)):
        x, y = x[:n].contiguous(), y[:n].contiguous()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        local_step.sweep_static(g["state"], g["sc2"], torch.ones((2, DH, DW)),
                                g["sal"], 0, DH, DW, 5, BSZ, 1, 4, 64, 2)
    with pytest.raises(ValueError):
        local_step.sweep_static(g["state"], g["sc2"], torch.ones((2, DH, DW)),
                                g["sal"], 0, DH, DW, 5, BSZ, 1, 4, 64, 0,
                                fill="dense")

"""The port's lane-batched growing against its one-lane form, on the CPU
(no JAX): the lane forms of K0's two twins and K4's patch twin equal their
per-lane calls bit for bit; ``sweep_lanes`` over two lanes (two frame pairs
with different seeds) equals two ``sweep_body`` calls bit for bit, sweep
after sweep, in iteration 0 and in iteration 1 under a trust map with a
pruned hole, for methods 0, 1, 2 and 4 (and m0 with the block-local band
and the staged floor divisor, which act per lane); and a sweep in which the
payload scatters' tie rule decides winners in one lane while the other
lane is busy.  Tolerance: none, bit for bit."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

H, W = 30, 40
BSZ = 48


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def lane_boxes(rng, lanes, b, hp, wp, p):
    """(lane, oy, ox) of b windows: every lane's four corners first (the
    clamped edge boxes, negative starts included), then random ones."""
    ln, oy, ox = [], [], []
    for lane in range(lanes):
        for y, x in ((0, 0), (hp - 1, wp - 1), (-1, 0), (hp - p + 2, -3)):
            ln.append(lane)
            oy.append(y)
            ox.append(x)
    k = b - len(ln)
    ln += rng.integers(0, lanes, k).tolist()
    oy += rng.integers(-p, hp + 1, k).tolist()
    ox += rng.integers(-p, wp + 1, k).tolist()
    return (torch.tensor(ln, dtype=torch.int64), torch.tensor(oy),
            torch.tensor(ox))


def test_k0_stack_lane_form_equals_per_lane_calls():
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    rng = np.random.default_rng(0)
    lanes, hp, wp, c, p = 3, 23, 31, 2, 11
    stack = torch.as_tensor(rng.standard_normal((lanes, hp, wp, c)),
                            dtype=torch.float32)
    ln, oy, ox = lane_boxes(rng, lanes, 29, hp, wp, p)
    oy, ox, ln = oy.to(torch.int32), ox.to(torch.int32), ln.to(torch.int32)
    got = gather_patches(stack, oy, ox, p, lane=ln)
    for lane in range(lanes):
        m = ln == lane
        assert same_bits(got[..., m], gather_patches(stack[lane], oy[m], ox[m], p))


def test_k0_planes_lane_form_equals_per_lane_calls():
    from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches

    rng = np.random.default_rng(1)
    lanes, h, w, p = 3, 19, 26, 11
    n = h * w
    flat = [torch.as_tensor(rng.standard_normal((lanes, n + 1)),
                            dtype=torch.float32) for _ in range(4)]
    trust = torch.as_tensor(rng.integers(0, 2, (lanes, h, w)), dtype=torch.int32)
    # a (L, 24, H', W') weight stack: each plane a lane-strided slice
    wp_pad = torch.as_tensor(rng.standard_normal((lanes, 24, h, w)),
                             dtype=torch.float32)
    ln, oy, ox = lane_boxes(rng, lanes, 31, h, w, p)
    for planes in (tuple(flat) + (trust,), wp_pad.unbind(1)):
        got = gather_plane_patches(planes, oy, ox, p, h, w, lane=ln)
        assert got.shape == (len(planes), 31, p, p)
        for lane in range(lanes):
            m = ln == lane
            one = gather_plane_patches(tuple(pl[lane] for pl in planes), oy[m],
                                       ox[m], p, h, w)
            assert same_bits(got[:, m], one)


def test_k4_patch_lane_form_equals_per_lane_calls():
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches

    rng = np.random.default_rng(2)
    lanes, h, w, p = 3, 21, 28, 11
    stack = torch.as_tensor(rng.standard_normal((lanes, 3, h, w)),
                            dtype=torch.float32)
    ln, oy, ox = lane_boxes(rng, lanes, 27, h - p, w - p, p)
    oy, ox = oy.clamp(0, h - 1), ox.clamp(0, w - 1)
    ph = torch.clamp(h - oy, max=p)
    pw = torch.clamp(w - ox, max=p)
    # flows that reach past every edge of the lane's frame
    u1 = torch.as_tensor(rng.uniform(-14, 14, (27, p, p)), dtype=torch.float32)
    u2 = torch.as_tensor(rng.uniform(-14, 14, (27, p, p)), dtype=torch.float32)
    args = [t.to(torch.int32) for t in (oy, ox, ph, pw)]
    got = bicubic_sample_patches(stack, *args, u1, u2, 3,
                                 lane=ln.to(torch.int32))
    for lane in range(lanes):
        m = ln == lane
        one = bicubic_sample_patches(stack[lane], *(a[m] for a in args), u1[m],
                                     u2[m], 3)
        assert same_bits(got[:, m], one)


def _lanes(method, seeds=(20, 35)):
    """Two lanes, two synthetic pairs with different seeds and seed counts:
    their consts, stacked consts, seeded states and saliency."""
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.local_step import init_state, insert_seeds
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    lam, theta, tau = method_local_params(method, 5)
    scs, states, sals = [], [], []
    for k, count in enumerate(seeds):
        i0, i1, gf, _ = syn.make_pair(H, W, seed=11 + k)
        a, b = prepare_pair(i0, i1, device="cpu")
        sc = make_solver_consts(a, b, lam, theta, tau, 0.01, 11, method,
                                i0_planes=i0)
        rng = np.random.default_rng(k)
        go = syn.make_seeds(gf, syn.random_seed_positions(H, W, count, rng), rng)
        sal = torch.ones(H * W + 1)
        scs.append(sc)
        sals.append(sal)
        states.append(insert_seeds(init_state(H, W, "cpu"), go, sc, sal, 1, 4,
                                   method=method))
    return scs, stack_solver_consts(scs), states, sals


def _trust():
    """Iteration 1's trust maps: a pruned hole in each lane, not the same."""
    tr = torch.ones((2, H, W), dtype=torch.int32)
    tr[0, 8:14, 18:28] = 0
    tr[1, 3:20, 5:9] = 0
    return tr


CASES = {"m0": (P.M_TVL1, {}), "m1": (P.M_TVL1_W, {}),
         "m2": (P.M_NLTVL1, {}), "m4": (P.M_TVCSAD, {}),
         "m0_block_fshi": (P.M_TVL1, dict(block=8, floor_scale_hi=4,
                                           queue_hi=40, delta_rel=0.1))}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_lanes_equals_one_lane_sweeps(case):
    from faldoi_tpu_torch.core.local_step import (
        lane_state, stack_states, state_to_numpy, sweep_body, sweep_lanes,
    )

    method, thr = CASES[case]
    scs, sc2, states, sals = _lanes(method)
    sal2 = torch.stack(sals)
    tr_ones = torch.ones((2, H, W))
    one = list(states)
    both = stack_states(states)
    schedule = [(0, tr_ones, 16)] * 3 + [(1, _trust(), 4)] * 2
    for it, tr, fs in schedule:
        ks = []
        for lane in range(2):
            one[lane], k = sweep_body(one[lane], scs[lane], tr[lane], sals[lane],
                                      it, H, W, 5, BSZ, 1, 4, fs, method, **thr)
            ks.append(k)
        both, counts = sweep_lanes(both, sc2, tr, sal2, it, H, W, 5, BSZ, 1, 4,
                                   fs, method, **thr)
        assert counts == ks and min(ks) > 0
        for lane in range(2):
            a = state_to_numpy(lane_state(both, lane))
            b = state_to_numpy(one[lane])
            for name in a:                      # the dump slot left out
                assert same_bits(a[name][:H * W], b[name][:H * W]), (it, lane, name)


def test_sweep_lanes_lane_subset_leaves_the_others():
    """``lanes=[1]`` sweeps lane 1 alone (lane index 1 into the stacked
    consts) and carries lane 0 untouched."""
    from faldoi_tpu_torch.core.local_step import (
        lane_state, stack_states, state_to_numpy, sweep_body, sweep_lanes,
    )

    scs, sc2, states, sals = _lanes(P.M_TVL1)
    both, counts = sweep_lanes(stack_states(states), sc2, torch.ones((2, H, W)),
                               torch.stack(sals), 0, H, W, 5, BSZ, 1, 4, 16,
                               lanes=[1])
    one, k = sweep_body(states[1], scs[1], torch.ones((H, W)), sals[1], 0, H, W,
                        5, BSZ, 1, 4, 16)
    assert counts == [k] and k > 0
    for name, a in state_to_numpy(lane_state(both, 1)).items():
        assert same_bits(a[:H * W], state_to_numpy(one)[name][:H * W])
        assert same_bits(state_to_numpy(lane_state(both, 0))[name],
                         state_to_numpy(states[0])[name])


def test_sweep_lanes_scatter_ties_within_a_busy_batch(monkeypatch):
    """A patch solver whose every energy ties (1.0) and whose flows differ
    from patch to patch: every working-flow cell that two accepted patches
    of a lane share, and every neighbour that two of them offer, is decided
    by the tie rule (the last update in a one-lane sweep's order wins).
    Lane 0 must come out as its one-lane sweep while lane 1 fills the rest
    of the batch."""
    from faldoi_tpu_torch.core import local_step as ls

    def tied(sc, ci, cj, oy, ox, ph, pw, u1, u2, p, warps, max_iters,
             lane=None):
        bump = (cj * 7 + ci * 3).to(u1.dtype)[:, None, None] * 0.01
        return u1 + bump, u2 - bump, torch.ones(u1.shape[0])

    monkeypatch.setattr(ls, "solver_for", lambda method: tied)
    scs, sc2, states, sals = _lanes(P.M_TVL1, seeds=(40, 60))
    sal2 = torch.stack(sals)
    tr = torch.ones((2, H, W))
    one = list(states)
    both = ls.stack_states(states)
    for _ in range(3):
        ks = []
        for lane in range(2):
            one[lane], k = ls.sweep_body(one[lane], scs[lane], tr[lane],
                                         sals[lane], 0, H, W, 5, BSZ, 1, 4, 16)
            ks.append(k)
        both, counts = ls.sweep_lanes(both, sc2, tr, sal2, 0, H, W, 5, BSZ, 1,
                                      4, 16)
        # several patches a lane: their 11x11 boxes overlap on 30x40
        assert counts == ks and min(ks) >= 2
        for lane in range(2):
            a = ls.state_to_numpy(ls.lane_state(both, lane))
            b = ls.state_to_numpy(one[lane])
            for name in a:
                assert same_bits(a[name][:H * W], b[name][:H * W]), (lane, name)
    # the ties were real: the tied energies reached the candidates
    cand_e = ls.state_to_numpy(ls.lane_state(both, 0))["cand_e"][:H * W]
    assert np.isfinite(cand_e).sum() >= 2


def test_drain_lanes_counts_each_lanes_sweeps():
    """Lanes of different sizes drain at different sweeps; each lane's count
    is its one-lane drain's (its first empty sweep included) and its state
    that drain's."""
    from faldoi_tpu_torch.core.local_step import (
        drain, drain_lanes, lane_state, stack_states, state_to_numpy,
    )

    scs, sc2, states, sals = _lanes(P.M_TVL1, seeds=(6, 45))
    both, sweeps = drain_lanes(stack_states(states), sc2, torch.ones((2, H, W)),
                               torch.stack(sals), 0, H, W, 5, BSZ, 1, 4, 64)
    for lane in range(2):
        st, k = drain(states[lane], scs[lane], torch.ones((H, W)), sals[lane], 0,
                      H, W, 5, BSZ, 1, 4, 64)
        assert sweeps[lane] == k
        for name, a in state_to_numpy(lane_state(both, lane)).items():
            assert same_bits(a[:H * W], state_to_numpy(st)[name][:H * W])
    assert sweeps[0] != sweeps[1]


def test_stack_solver_consts_refuses_mixed_parameters():
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, _, _ = syn.make_pair(H, W, seed=5)
    a, b = prepare_pair(i0, i1, device="cpu")
    sc = make_solver_consts(a, b, 0.25, 0.3, 0.125, 0.01, 11, 0)
    other = make_solver_consts(a, b, 0.5, 0.3, 0.125, 0.01, 11, 0)
    assert stack_solver_consts([sc, sc]).i1_stack.shape == (2, 3, H, W)
    with pytest.raises(ValueError, match="lambda_"):
        stack_solver_consts([sc, other])

"""The port's pairs mode, ``match_growing_pairs``, against each pair's own
``match_growing``, on the CPU (no JAX; JAX's pairs mode is held in
``test_torch_pairs_jax.py``): N = 1, 2 and 3 synthetic 32x40 pairs of method
0 whose lanes hold different seed counts, so that they drain at different
sweeps, and one pair of pairs each of methods 2 and 4.  Every pair's flow,
energy and occlusions must equal its single-pair run bit for bit, and every
lane's sweep counts its own.  Method 8 is refused; ``relax=True`` is taken
(the modes in pairs mode: ``test_torch_modes.py``)."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

H, W = 32, 40
BSZ = 64
# seeds a lane (fwd, bwd) of each pair
COUNTS = ((12, 30), (40, 9), (25, 55))


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def make_pairs():
    """Three synthetic pairs (seeds 21-23): frames (i0n, i1n), raw planes and
    seeds (go, ba) at random positions, from each pair's own known flows."""
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    pairs = []
    for k, (nf, nb) in enumerate(COUNTS):
        i0, i1, gf, gb = syn.make_pair(H, W, seed=21 + k)
        a, b = prepare_pair(i0, i1, device="cpu")
        rng = np.random.default_rng(k)
        go = syn.make_seeds(gf, syn.random_seed_positions(H, W, nf, rng), rng)
        ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, nb, rng), rng)
        pairs.append(dict(frames=(a, b), planes=(i0, i1), seeds=(go, ba)))
    return pairs


def prm_of(method, iterations=None):
    prm = P.Parameters()
    prm.val_method = method
    if iterations is not None:
        prm.iterations_of = iterations
    return prm


def single(pair, prm):
    from faldoi_tpu_torch.core.match_growing import match_growing

    st = {}
    out = match_growing(*pair["seeds"], *pair["frames"], prm, bsz=BSZ, stats=st,
                        i0_planes=pair["planes"][0], i1_planes=pair["planes"][1])
    return [t.numpy() for t in out], st["sweeps"]


def pairs_run(pairs, prm):
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs

    st = {}
    outs = match_growing_pairs([p["seeds"] for p in pairs],
                               [p["frames"] for p in pairs], prm, bsz=BSZ,
                               stats=st, planes_pairs=[p["planes"] for p in pairs])
    return [[t.numpy() for t in o] for o in outs], st["sweeps"]


def check(pairs, prm, singles):
    outs, sweeps = pairs_run(pairs, prm)
    assert len(outs) == len(pairs)
    for k, (got, (want, want_sweeps)) in enumerate(zip(outs, singles)):
        for a, b in zip(got, want):                  # flow, energy, occ
            assert same_bits(a, b), k
        assert np.isfinite(got[0]).all()             # 100% fill
        # this pair's lanes: the same sweeps, drain by drain, as alone
        mine = [(s["it"], s["lane"], s["sweeps"]) for s in sweeps
                if s.get("pair", 0) == k]
        assert mine == [(s["it"], s["lane"], s["sweeps"]) for s in want_sweeps]
    return sweeps


@pytest.fixture(scope="module")
def m0_pairs():
    pairs = make_pairs()
    return pairs, [single(p, prm_of(P.M_TVL1)) for p in pairs]


@pytest.mark.parametrize("npairs", [1, 2, 3])
def test_pairs_equal_single_pairs_m0(m0_pairs, npairs):
    pairs, singles = m0_pairs
    sweeps = check(pairs[:npairs], prm_of(P.M_TVL1), singles[:npairs])
    if npairs > 1:
        # the lanes drained at different sweeps within one drain
        first = [s["sweeps"] for s in sweeps if s["it"] == 0]
        assert len(set(first)) > 1


@pytest.mark.parametrize("method,iterations", [(P.M_NLTVL1, None),
                                               (P.M_TVCSAD, 1)])
def test_pairs_equal_single_pairs_nltv_csad(method, iterations):
    pairs = make_pairs()[1:]
    prm = prm_of(method, iterations)
    check(pairs, prm, [single(p, prm) for p in pairs])


def test_pairs_refuse_method_8_and_relax():
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs

    pair = make_pairs()[0]
    args = ([pair["seeds"]], [pair["frames"]])
    with pytest.raises(ValueError, match="method 8"):
        match_growing_pairs(*args, prm_of(P.M_TVL1_OCC))
    # relax is ported: taken, not refused
    (flow, _, _), = match_growing_pairs(*args, prm_of(P.M_TVL1, 1), bsz=BSZ,
                                        relax=True)
    assert np.isfinite(flow.numpy()).all()

"""The port's pairs mode against JAX's ``match_growing_pairs``, run live once.

N = 2 synthetic 32x40 pairs (seeds 41 and 42, 30 seeds a lane), method 0,
one outer iteration (``prm.iterations_of = 1``), bsz 256.  JAX runs in the
repo's exact configuration plus the pins of its own
``tests/test_pairs.py::test_pairs_equals_single`` (``FALDOI_GROW_LADDER=256``,
``FALDOI_GROW_LEAN=0``, ``FALDOI_GROW_PREWARM=0``): one rung, so its lanes
are independent.  JAX's chunked growing and the port's strict sweep differ
in the last bits, so each pair is held by EPE: rg <= 0.05 px, and both fill
100%.  That the port's pairs equal its single-pair growings bit for bit is
``test_torch_pairs.py``'s; this file runs only the JAX pairs program (mostly
compile: ~3 min on one CPU core), in a file of its own so that xdist gives
it a worker."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest", "FALDOI_GROW_LADDER": "256",
             "FALDOI_GROW_LEAN": "0", "FALDOI_GROW_PREWARM": "0"}
H, W = 32, 40
BSZ = 256
SEEDS = 30


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def pairs():
    out = []
    for k in range(2):
        i0, i1, gf, gb = syn.make_pair(H, W, seed=41 + k)
        rng = np.random.default_rng(41 + k)
        go = syn.make_seeds(gf, syn.random_seed_positions(H, W, SEEDS, rng), rng)
        ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, SEEDS, rng), rng)
        out.append((i0, i1, go, ba))
    return out


@pytest.fixture(scope="module")
def jax_pairs(exact_env, pairs):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing_pairs
    from faldoi_tpu.core.preprocess import prepare_pair

    prm = JP.Parameters()
    prm.val_method = JP.M_TVL1
    prm.iterations_of = 1
    frames = [prepare_pair(i0, i1) for i0, i1, _, _ in pairs]
    outs = match_growing_pairs([(go, ba) for _, _, go, ba in pairs], frames,
                               prm, bsz=BSZ)
    return [np.asarray(o[0]) for o in outs]


def test_pairs_match_jax_pairs(jax_pairs, pairs):
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    prm = P.Parameters()
    prm.val_method = P.M_TVL1
    prm.iterations_of = 1
    st = {}
    outs = match_growing_pairs(
        [(go, ba) for _, _, go, ba in pairs],
        [prepare_pair(i0, i1, device="cpu") for i0, i1, _, _ in pairs], prm,
        bsz=BSZ, stats=st)
    # fwd0, fwd1, bwd0, bwd1, then the final forward lanes
    assert [(s["it"], s["lane"], s["pair"]) for s in st["sweeps"]] == [
        (0, "fwd", 0), (0, "fwd", 1), (0, "bwd", 0), (0, "bwd", 1),
        (1, "fwd", 0), (1, "fwd", 1)]
    for k, (out, jflow) in enumerate(zip(outs, jax_pairs)):
        flow = out[0].numpy()
        assert np.isfinite(flow).all() and np.isfinite(jflow).all(), k
        assert syn.epe(flow, jflow) <= 0.05, k

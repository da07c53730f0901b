"""The port's growing with the bilateral pre-fill (``match_growing(
bilateral=True)``: K11's twin on the untrusted working flow after each prune
and requeue) against JAX's ``match_growing(bilateral=True)``, which takes
its sequential path (match_growing.py:912-944): a synthetic 43x59 pair, 30
seeds a lane, bsz 64, method 0, warm and cold requeue.  Held by EPE (rg <=
0.05 px, 100% fill).  The filter runs once a pair after each of the three
prunes and changes the working flow at the untrusted pixels; the flow does
not move, in JAX as in the port: every patch that covers an untrusted pixel
takes the Poisson fill, never the working flow, so the filtered values are
not read (checked here against the growing without it)."""

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
             "FALDOI_WARP_PREC": "highest"}
H, W = 43, 59
BSZ = 64


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.mark.parametrize("warm_band", [10, 0])
def test_bilateral_growing_matches_jax(exact_env, warm_band):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu_torch.core import bilateral, match_growing as mg
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=155)
    rng = np.random.default_rng(156)
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 30, rng), rng)
    ja, jb = jprepare(i0, i1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FALDOI_GROW_WARM_BAND", str(warm_band))
        jrg = np.asarray(jmatch(go, ba, ja, jb, JP.Parameters(), bsz=BSZ,
                                mode="fused", bilateral=True)[0])
    a, b = prepare_pair(i0, i1, device="cpu")
    calls = []
    inner = bilateral.bilateral_filter_flow

    def spy(i0n, u1, u2, trust, fixed, **kw):
        out = inner(i0n, u1, u2, trust, fixed, **kw)
        calls.append(bool((out[0] != u1).any() | (out[1] != u2).any()))
        assert torch.equal(i0n, a)          # both lanes weighted by I0
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mg, "bilateral_filter_flow", spy)
        rg = mg.match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ,
                              warm_band=warm_band, bilateral=True)[0].numpy()
    plain = mg.match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ,
                             warm_band=warm_band)[0].numpy()
    assert np.isfinite(rg).all() and np.isfinite(jrg).all()
    assert syn.epe(rg, jrg) <= 0.05
    assert calls == [True] * 3
    np.testing.assert_array_equal(rg, plain)

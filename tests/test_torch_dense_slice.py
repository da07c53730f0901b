"""The port's growing with the dense fill (``match_growing(fill="dense")``:
one whole-image nearest fill a sweep, K10's twin) against JAX's fused
``match_growing(fill="dense")``: a synthetic 42x58 pair, 30 seeds a lane,
bsz 64, method 0, the warm requeue.  Held by EPE (rg <= 0.05 px, 100%
fill); the dense fill must move the flow away from the patch fill by more
than the gap to JAX.  JAX runs in the repo's exact configuration; its
iterated program compiles for ~1.5 min on one core."""

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
H, W = 42, 58
BSZ = 64


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def test_dense_growing_matches_jax(exact_env):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops import poisson

    i0, i1, gf, gb = syn.make_pair(H, W, seed=153)
    rng = np.random.default_rng(154)
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 30, rng), rng)
    ja, jb = jprepare(i0, i1)
    jrg = np.asarray(jmatch(go, ba, ja, jb, JP.Parameters(), bsz=BSZ,
                            mode="fused", fill="dense")[0])
    a, b = prepare_pair(i0, i1, device="cpu")
    calls = []
    inner = poisson.nearest_fill_image

    def count(x, *args, **kw):
        calls.append(tuple(x.shape))
        return inner(x, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        from faldoi_tpu_torch.core import local_step

        mp.setattr(local_step, "nearest_fill_image", count)
        stats = {}
        rg = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ, stats=stats,
                           fill="dense")[0].numpy()
    patch = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ)[0].numpy()
    assert np.isfinite(rg).all() and np.isfinite(jrg).all()
    gap = syn.epe(rg, jrg)
    assert gap <= 0.05
    assert syn.epe(rg, patch) > max(gap, 1e-3)
    # one fill of u and v a non-empty sweep, of the lanes that swept
    sweeps = sum(s["sweeps"] - 1 for s in stats["sweeps"])
    assert len(calls) <= sweeps and len(calls) >= max(
        s["sweeps"] for s in stats["sweeps"]) - 1
    assert {c[1:] for c in calls} == {(2, H, W)}

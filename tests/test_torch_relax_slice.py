"""The port's growing in label-correcting relax mode (``match_growing(relax=
True)``) against JAX's fused ``match_growing(relax=True)``, then each one's
``tvl2_global``: a synthetic 41x57 pair, 30 seeds a lane, bsz 64, method 0,
the warm requeue.  Relax is held by EPE at the ROADMAP gates (rg <= 0.05 px,
var <= 0.01 px, 100% fill), and must move the flow away from the strict
growing by more than the gap to JAX.  JAX runs in the repo's exact
configuration; this file's one JAX growing compiles its iterated program
(~1.5 min on one core)."""

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
H, W = 41, 57
BSZ = 64


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def pair():
    i0, i1, gf, gb = syn.make_pair(H, W, seed=151)
    rng = np.random.default_rng(152)
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 30, rng), rng)
    return i0, i1, gf, go, ba


def test_relax_growing_matches_jax(exact_env, pair):
    import jax.numpy as jnp

    from faldoi_tpu import params as JP
    from faldoi_tpu.core.global_step import tvl2_global as jglobal
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, go, ba = pair
    ja, jb = jprepare(i0, i1)
    jrg, _, _ = jmatch(go, ba, ja, jb, JP.Parameters(), bsz=BSZ, mode="fused",
                       relax=True)
    jrg = np.asarray(jrg)
    ju1, ju2 = jglobal(ja, jb, jnp.asarray(jrg[..., 0]), jnp.asarray(jrg[..., 1]))
    jvar = np.stack([np.asarray(ju1), np.asarray(ju2)], -1)

    a, b = prepare_pair(i0, i1, device="cpu")
    stats = {}
    rg, _, _ = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ,
                             stats=stats, relax=True)
    u1, u2 = tvl2_global(a, b, rg[..., 0].contiguous(), rg[..., 1].contiguous())
    var = torch.stack([u1, u2], -1).numpy()
    rg = rg.numpy()
    strict, _, _ = match_growing(go, ba, a, b, P.Parameters(), bsz=BSZ)
    assert np.isfinite(rg).all() and np.isfinite(jrg).all()
    gap = syn.epe(rg, jrg)
    assert gap <= 0.05
    assert syn.epe(var, jvar) <= 0.01
    assert syn.epe(rg, strict.numpy()) > max(gap, 1e-3)
    assert [(s["it"], s["lane"]) for s in stats["sweeps"]] == [
        (it, lane) for it in range(3) for lane in ("fwd", "bwd")] + [(3, "fwd")]


def test_relax_floor_defaults_to_the_batch(pair):
    """Under relax the rank floor defaults to bsz (JAX's LocalSolver), not
    4096: with bsz 64 the explicit floor 64 gives the same growing, 4096
    another."""
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, _, go, ba = pair
    a, b = prepare_pair(i0, i1, device="cpu")
    prm = P.Parameters()
    prm.iterations_of = 1
    dflt = match_growing(go, ba, a, b, prm, bsz=BSZ, relax=True)[0]
    same = match_growing(go, ba, a, b, prm, bsz=BSZ, relax=True, floor=BSZ)[0]
    wide = match_growing(go, ba, a, b, prm, bsz=BSZ, relax=True, floor=4096,
                         floor_scale=1)[0]
    assert torch.equal(dflt, same)
    assert not torch.equal(dflt, wide)

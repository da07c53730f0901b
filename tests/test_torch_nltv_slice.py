"""The NLTV-L1 slice of the port against faldoi_tpu's fused run: seeds ->
``match_growing`` -> ``global_refine`` for method 2 with the warm requeue
and method 3 with the cold one, on a 33x45 crop of the synthetic pair.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 33x45 is traced by no other test file).  Each JAX run compiles its
whole iterated growing as one program, so the runs are cut to what keeps
that compile short: one outer iteration (one prune and requeue between the
drains) and a patch PD cap of 9 iterations, which JAX runs as a
``while_loop`` instead of the masked unroll it uses up to 8 (the same
values; the port runs the masked unroll either way, K7's twin here).  The
flows are held by EPE against JAX's (rg <= 0.05 px, var <= 0.01 px, 100%
fill in both) and the occlusion masks must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
SH, SW = 33, 45
BSZ = 128
LOC_IT = 1
PCH_IT = 9


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def _slice_pair():
    i0, i1, gf, gb = syn.make_pair(SH, SW, seed=71)
    rng = np.random.default_rng(72)
    go = syn.make_seeds(gf, syn.random_seed_positions(SH, SW, 30, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(SH, SW, 30, rng), rng)
    return i0, i1, go, ba, gf


def _params(mod, method):
    prm = mod.Parameters()
    prm.val_method = method
    prm.iterations_of = LOC_IT
    prm.max_iter_patch = PCH_IT
    return prm


@pytest.mark.parametrize("method,band", [(P.M_NLTVL1, 10), (P.M_NLTVL1_W, 0)],
                         ids=["m2-warm", "m3-cold"])
def test_nltv_slice_matches_jax(method, band):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu.models import global_refine as jrefine
    from faldoi_tpu_torch.core.functionals import nltv_patch_loop
    from faldoi_tpu_torch.core.global_step_nltv import nltv_global_loop
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import global_refine

    i0, i1, go, ba, gf = _slice_pair()
    ja, jb = jprepare(i0, i1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FALDOI_GROW_WARM_BAND", str(band))
        jrg, _, jocc = jmatch(go, ba, ja, jb, _params(JP, method), bsz=BSZ,
                              mode="fused", i0_planes=i0, i1_planes=i1)
    ju1, ju2, _ = jrefine(method, ja, jb, jb, jnp.asarray(jrg[..., 0]),
                          jnp.asarray(jrg[..., 1]), JP.Parameters(), i0_planes=i0)
    jvar = np.stack([np.asarray(ju1), np.asarray(ju2)], -1)

    a, b = prepare_pair(i0, i1, device="cpu")
    launches = (nltv_patch_loop.launches, nltv_global_loop.launches)
    stats = {}
    rg, _, occ = match_growing(go, ba, a, b, _params(P, method), bsz=BSZ,
                               stats=stats, warm_band=band, i0_planes=i0,
                               i1_planes=i1)
    u1, u2, _ = global_refine(method, a, b, rg[..., 0].contiguous(),
                              rg[..., 1].contiguous(), P.Parameters(),
                              stats=stats, i0_planes=i0)
    assert (nltv_patch_loop.launches, nltv_global_loop.launches) == launches
    prg, pvar = rg.numpy(), torch.stack([u1, u2], -1).numpy()
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()    # 100% fill
    assert syn.epe(prg, jrg) <= 0.05
    assert syn.epe(pvar, jvar) <= 0.01
    assert syn.epe(pvar, gf) < 1.5 and syn.epe(jvar, gf) < 1.5
    assert len(stats["sweeps"]) == 2 * LOC_IT + 1
    assert stats["global_iters"] == [400] * P.Parameters().warps
    assert 0 < occ.sum() < SH * SW
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))

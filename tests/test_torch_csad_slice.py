"""The TV-CSAD slice of the port against faldoi_tpu's fused run: seeds ->
``match_growing`` -> ``global_refine`` for method 4 (warm requeue), on a
20x28 crop of the synthetic pair.  Its NLTV-CSAD twin (method 6) is
``test_torch_csad_nltv_slice.py``, a file of its own so that xdist runs the
two JAX growings side by side.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 20x28 is traced by no other test file but the NLTV-CSAD slice, in the
same configuration).  JAX's CSAD growing sorts 97 entries a cell every PD
iteration of every lane of every sweep, which takes minutes on the CPU at
bsz 128, so the runs are cut: 20 seeds a direction, bsz 16, one outer
iteration, a patch PD cap of 2; the global step runs the global CLI's 5
warps.  Both fill every pixel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
BSZ = 16
LOC_IT = 1
PCH_IT = 2


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def _params(mod, method):
    prm = mod.Parameters()
    prm.val_method = method
    prm.iterations_of = LOC_IT
    prm.max_iter_patch = PCH_IT
    return prm


def csad_slice(method, sh, sw, seed, seed_noise=np.float32(0), jax_too=True):
    """JAX's and the port's slice of ``method`` on an sh x sw crop: (JAX's
    rg, var, occlusions; the port's rg, var, occlusions; its stats; the
    known flow; K8's launches during the port's run)."""
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import global_refine
    from faldoi_tpu_torch.ops.csad import csad_vstep

    i0, i1, gf, gb = syn.make_pair(sh, sw, seed=seed)
    rng = np.random.default_rng(seed + 1)
    go = syn.make_seeds(gf, syn.random_seed_positions(sh, sw, 20, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(sh, sw, 20, rng), rng)
    go, ba = go + seed_noise, ba - seed_noise
    if not jax_too:
        jrg = jvar = jocc = None
    else:
        jrg, jvar, jocc = _jax_slice(method, go, ba, i0, i1)
    a, b = prepare_pair(i0, i1, device="cpu")
    before = csad_vstep.launches
    stats = {}
    rg, _, occ = match_growing(go, ba, a, b, _params(P, method), bsz=BSZ,
                               stats=stats, i0_planes=i0, i1_planes=i1)
    prm = P.Parameters()
    prm.warps = P.PAR_DEFAULT_NWARPS_GLOBAL
    u1, u2, _ = global_refine(method, a, b, rg[..., 0].contiguous(),
                              rg[..., 1].contiguous(), prm, stats=stats,
                              i0_planes=i0)
    pvar = torch.stack([u1, u2], -1).numpy()
    return (jrg, jvar, jocc, rg.numpy(), pvar, occ.numpy(), stats, gf,
            csad_vstep.launches - before)


def _jax_slice(method, go, ba, i0, i1):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu.models import global_refine as jrefine

    ja, jb = jprepare(i0, i1)
    jrg, _, jocc = jmatch(go, ba, ja, jb, _params(JP, method), bsz=BSZ,
                          mode="fused", i0_planes=i0, i1_planes=i1)
    jprm = JP.Parameters()
    jprm.warps = P.PAR_DEFAULT_NWARPS_GLOBAL        # global_faldoi's -w
    ju1, ju2, _ = jrefine(method, ja, jb, jb, jnp.asarray(jrg[..., 0]),
                          jnp.asarray(jrg[..., 1]), jprm, i0_planes=i0)
    jvar = np.stack([np.asarray(ju1), np.asarray(ju2)], -1)
    return np.asarray(jrg), jvar, np.asarray(jocc)


def test_tvcsad_slice_matches_jax():
    """Method 4.  Its growing is chaotic in float32 on this pair: the
    port's own run moves by rg 0.067-0.147 px and var 0.079-0.117 px when
    the seeds move by +-1e-6 to 3e-5 px (the CSAD energies that order the
    candidates divide by grad, at its floor of 0.01, twice), where m0's
    moves by 0.020 / 0.002 (PARITY.md).  Against JAX, measured: rg 0.173
    px, var 0.095 px, 98% of the occlusion mask equal, and both as far from
    the known flow within 0.05 px (1.246 against 1.204).  So the gates are
    set at that chaos: rg <= 0.25 px, var <= 0.2 px, 95% of the mask, and
    each as close to the known flow as the other within 0.1 px."""
    jrg, jvar, jocc, prg, pvar, occ, stats, gf, k8 = csad_slice(
        P.M_TVCSAD, 20, 28, 111)
    assert k8 == 0                                   # the twin ran
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()    # 100% fill
    assert syn.epe(prg, jrg) <= 0.25
    assert np.isfinite(pvar).all()
    assert syn.epe(pvar, jvar) <= 0.2
    assert abs(syn.epe(pvar, gf) - syn.epe(jvar, gf)) <= 0.1
    assert (occ == jocc).mean() >= 0.95
    assert len(stats["sweeps"]) == 2 * LOC_IT + 1
    assert stats["global_iters"] == [P.MAX_ITERATIONS_GLOBAL] * 5

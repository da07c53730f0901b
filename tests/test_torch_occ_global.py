"""The global step of method 8 (``tvl2_occ_global``, K9's whole-image twin
inside) against faldoi_tpu's on a 40x56 crop of the synthetic four-frame
sequence, two warps of at most 15 PD iterations, with and without an input
occlusion mask; and ``global_refine(8, ...)``.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace).  40x56 has a side over 32, so JAX's warps take the dense whole-image
sampler (a side of at most 32 would take the windowed patch sampler).

Tolerances: a mean EPE of 1e-4 px and at most 0.5% of the pixels moved by
more than 1e-3 px (measured: mean 9.5e-7 / 1.1e-6 px, at most 7.2e-5 /
2.4e-4 px; chi is binary and feeds back into u, so XLA's FMA contractions
on the CPU can grow at some pixels); chi equal at every pixel (measured:
equal).  JAX's own run moves by a mean of 9.1e-6 px, and by up to 1.8e-3 px
at a pixel, when the initial flow moves by 1e-6 px
(``test_jax_global_spread``): the gates sit above that spread."""

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
H, W = 40, 56
WARPS, ITERS = 2, 15


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def case():
    i0, i1, i_1, _, gf, _, occ = syn.make_quad(H, W, seed=93, full_shape=(80, 100))
    rng = np.random.default_rng(94)
    u = (gf + rng.normal(0, 0.3, gf.shape)).astype(np.float32)
    occ0 = np.maximum(occ, rng.random((H, W)) < 0.1).astype(np.float32)
    return (i0, i1, i_1), u, occ0


def _jax(frames, u, occ_init):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.occlusion import tvl2_occ_global as jglobal
    from faldoi_tpu.core.preprocess import prepare_triple as jtriple

    prm = JP.init_params(None, JP.GLOBAL_STEP)
    prm.warps, prm.iterations_of = WARPS, ITERS
    u1, u2, chi = jglobal(*jtriple(*frames), jnp.asarray(u[..., 0]),
                          jnp.asarray(u[..., 1]), occ_init, prm)
    return np.stack([np.asarray(u1), np.asarray(u2)], -1), np.asarray(chi)


def _port(frames, u, occ_init, via_refine=False):
    from faldoi_tpu_torch.core.occlusion import occ_global_loop, tvl2_occ_global
    from faldoi_tpu_torch.core.preprocess import prepare_triple
    from faldoi_tpu_torch.models import global_refine

    prm = P.init_params(None, P.GLOBAL_STEP)
    prm.warps, prm.iterations_of = WARPS, ITERS
    a, b, c = prepare_triple(*frames, device="cpu")
    u1, u2 = (torch.as_tensor(np.ascontiguousarray(u[..., k])) for k in (0, 1))
    st = {}
    before = occ_global_loop.launches
    if via_refine:
        u1, u2, chi = global_refine(P.M_TVL1_OCC, a, b, u1, u2, prm, stats=st,
                                    i_1n=c, occ_init=occ_init)
    else:
        u1, u2, chi = tvl2_occ_global(a, b, c, u1, u2, occ_init, prm, stats=st)
    assert occ_global_loop.launches == before           # the twin ran
    return torch.stack([u1, u2], -1).numpy(), chi.numpy(), st["global_iters"]


@pytest.mark.parametrize("with_occ", [False, True], ids=["chi0", "occ_init"])
def test_occ_global_matches_jax(case, with_occ):
    frames, u, occ0 = case
    occ_init = occ0 if with_occ else None
    jflow, jchi = _jax(frames, u, occ_init)
    flow, chi, iters = _port(frames, u, occ_init)
    d = np.sqrt(((flow.astype(np.float64) - jflow) ** 2).sum(-1))
    assert d.mean() <= 1e-4 and (d > 1e-3).mean() <= 0.005
    assert np.array_equal(chi, jchi)
    assert set(np.unique(chi)) <= {0.0, 1.0} and 0 < chi.mean() < 0.5
    assert len(iters) == WARPS and all(0 < n <= ITERS for n in iters)


def test_global_refine_dispatches_method_8(case):
    """``global_refine(8, ...)`` is ``tvl2_occ_global`` (bit for bit), with
    chi returned; methods 0-7 return chi None."""
    from faldoi_tpu_torch.core.preprocess import prepare_triple
    from faldoi_tpu_torch.models import global_refine

    frames, u, occ0 = case
    flow, chi, iters = _port(frames, u, occ0)
    rflow, rchi, riters = _port(frames, u, occ0, via_refine=True)
    assert np.array_equal(flow, rflow) and np.array_equal(chi, rchi)
    assert iters == riters
    prm = P.init_params(None, P.GLOBAL_STEP)
    prm.warps, prm.iterations_of = 1, 2
    a, b, c = prepare_triple(*frames, device="cpu")
    u1, u2 = (torch.as_tensor(np.ascontiguousarray(u[..., k])) for k in (0, 1))
    out = global_refine(P.M_TVL1_OCC, a, b, u1, u2, prm, i_1n=c)
    assert len(out) == 3 and out[2].shape == u1.shape
    out = global_refine(P.M_TVL1, a, b, u1, u2, prm)
    assert len(out) == 3 and out[2] is None


def test_jax_global_spread(case):
    """JAX's own global step under 1e-6 px of flow noise: the scale the
    port's gates sit above (mean EPE measured 9.1e-6 px)."""
    frames, u, occ0 = case
    a, _ = _jax(frames, u, None)
    b, _ = _jax(frames, u + np.float32(1e-6), None)
    d = np.sqrt(((a.astype(np.float64) - b) ** 2).sum(-1))
    assert d.mean() < 1e-4

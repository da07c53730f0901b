"""TV-L1 with occlusions (method 8) of the port against faldoi_tpu: the
four-frame preprocessing, the weight g, the consts, the canvas solver (K9's
patch twin inside) on B canvases at P 11 with boxes clipped at the image
edge and at P 3, and K9's patch twin against the loop written per canvas.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 37x51 is traced by no other test file).  JAX's own m8 tests read the
absent example data, so the frames come from ``synthetic.make_quad``.  Its
warps at -u take the windowed block sampler (match_growing sets
``i_1_blk`` whatever FALDOI_BLOCKGATHER says), exact within its 29-px
spread budget, which the synthetic flows (|u| <= 8 px) keep.

Tolerances: the preprocessing, g and the consts within 1e-6 (the same
float32 operations); the canvas solves of three PD iterations, each with 24
xi and 24 eta / chi steps, within 1e-4 px in the box (measured 3.6e-6;
XLA may contract a*b+c into one FMA on the CPU, the port never does), chi
equal in every cell (measured: equal), the energies within 1e-5 relative
or absolute (measured 1.4e-6 absolute on energies of ~0.07: another
summation order).
JAX's own canvas solve moves by up to 8.2e-6 px when its init moves by
1e-6 px (measured, ``test_jax_canvas_spread``), below the gate."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 37, 51
ATOL_U = 1e-4


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.array(x))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def _occ_prm(prm):
    return (prm.alpha, prm.beta, prm.mu, prm.tau_u, prm.tau_eta, prm.tau_chi)


@pytest.fixture(scope="module")
def frames():
    """The four frames, JAX's and the port's preprocessing, JAX's m8 consts
    built as its match_growing builds them, and the port's."""
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.functionals import make_warp_blocks
    from faldoi_tpu.core.occlusion import init_weight as jweight
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.core.preprocess import prepare_quad as jquad
    from faldoi_tpu.models import method_local_params as jparams
    from faldoi_tpu.ops.blockgather import make_crop_blocks
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.preprocess import prepare_quad

    i0, i1, i_1, i2, gf, gb, occ = syn.make_quad(H, W, seed=91,
                                                 full_shape=(80, 100))
    ja = jquad(i0, i1, i_1, i2)
    ta = prepare_quad(i0, i1, i_1, i2, device="cpu")
    jprm = JP.Parameters()
    lam, theta, tau = jparams(8, 5)
    a, b, a_1, _ = ja
    ax, ay = centered_gradient(a)
    bx, by = centered_gradient(b)
    jsc = jconsts(8, pad_for_crops(a, 11), b, bx, by, lam, theta, tau,
                  jprm.tol_OF, wr=5, p=11)
    i_1x, i_1y = centered_gradient(a_1)
    gpad = pad_for_crops(jweight(ax, ay), 11)
    jsc = jsc._replace(
        i_1=a_1, i_1x=i_1x, i_1y=i_1y,
        i_1_blk=make_warp_blocks(jnp.stack([a_1, i_1x, i_1y])), gpad=gpad,
        g_blk=make_crop_blocks(gpad),
        occ_prm=jnp.asarray(_occ_prm(jprm), jnp.float32))
    sc = make_solver_consts(ta[0], ta[1], lam, theta, tau, jprm.tol_OF, 11, 8,
                            i_1=ta[2], occ_prm=_occ_prm(P.Parameters()))
    return dict(frames=(i0, i1, i_1, i2), gf=gf, occ=occ, ja=ja, ta=ta,
                jsc=jsc, sc=sc, g=jweight(ax, ay))


def test_normalization_4_and_prepare_quad_match_jax(frames):
    from faldoi_tpu.ops.normalize import image_normalization_4 as jnorm
    from faldoi_tpu_torch.ops.normalize import image_normalization_4

    rng = np.random.default_rng(92)
    ims = [rng.uniform(10, 240, (9, 13)).astype(np.float32) for _ in range(4)]
    ims[2][0, 0] = 3.0                 # I-1 holds the minimum
    ims[3][1, 1] = 251.0               # I2 the maximum
    for got, want in zip(image_normalization_4(*map(T, ims)), jnorm(*ims)):
        close(got, want, 1e-6)
    flat = image_normalization_4(*(T(np.full((4, 4), 7.0, np.float32))
                                   for _ in range(4)))
    assert all((f == 7.0).all() for f in flat)          # max == min: as is
    for got, want in zip(frames["ta"], frames["ja"]):
        close(got, want, 1e-6)
    assert frames["occ"].any() and frames["occ"].mean() < 0.1


def test_make_quad_moves_the_frames_by_the_flow():
    """I-1 and I2 are I0 moved by minus and by twice the two-layer flow:
    warped back by -u and 2u (K4's flow-form twin), each matches I0 in the
    background far better than unwarped; I0 and I1 are ``make_pair``'s, and
    the known occlusions are background pixels that the rectangle covers in
    I1."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_planes

    i0, i1, i_1, i2, gf, _, occ = syn.make_quad(60, 80, seed=3)
    p0, p1 = syn.make_pair(60, 80, 3)[:2]
    assert np.array_equal(i0, p0) and np.array_equal(i1, p1)
    bg = (gf == np.float32(syn.BG_FLOW)).all(-1)
    inner = np.zeros_like(bg)
    inner[8:-8, 8:-8] = True
    for frame, k in ((i_1, -1.0), (i2, 2.0)):
        u = torch.as_tensor(np.ascontiguousarray(k * gf[..., 0]))
        v = torch.as_tensor(np.ascontiguousarray(k * gf[..., 1]))
        back = bicubic_warp_planes(torch.as_tensor(frame), u, v, False).numpy()
        m = bg & inner
        moved = np.abs(back - i0)[:, m].mean()
        assert moved < np.abs(frame - i0)[:, m].mean() / 5
    assert occ.any() and (occ <= bg).all()
    assert gf[occ > 0].tolist() == [list(np.float32(syn.BG_FLOW))] * int(occ.sum())


def test_init_weight_and_consts_match_jax(frames):
    """g, the consts of method 8 (the I-1 stack, gpad, occ_prm) built by the
    port and carried from JAX, and the local scalars in float32."""
    from faldoi_tpu_torch.core.functionals import solver_consts_from_numpy
    from faldoi_tpu_torch.core.occlusion import SCALARS, init_weight, local_scalars
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    sc, jsc = frames["sc"], frames["jsc"]
    close(init_weight(*centered_gradient(frames["ta"][0])), frames["g"], 1e-6)
    close(sc.gpad, jsc.gpad, 1e-6)
    close(sc.i_1_stack, np.stack([jsc.i_1, jsc.i_1x, jsc.i_1y]), 1e-6)
    close(sc.occ_prm, jsc.occ_prm, 0)
    carried = solver_consts_from_numpy(jsc, "cpu")
    for name in ("i_1_stack", "gpad", "occ_prm", "i1_stack", "i0pad"):
        close(getattr(carried, name), getattr(sc, name), 1e-6)
    s = local_scalars(sc.lambda_, sc.theta, sc.occ_prm, sc.tol).numpy()
    f32 = np.float32
    al, be, mu, tu, te, tc = (f32(x) for x in _occ_prm(P.Parameters()))
    th, lam = f32(P.PAR_DEFAULT_THETA), f32(P.PAR_DEFAULT_LAMBDA)
    want = dict(lam=lam, theta=th, l_t=lam * th, alpha_i_occ=f32(1) / (f32(1) + al * th),
                mu_t_occ=lam * th / (f32(1) + al * th), theta_beta=th * be,
                tau_theta=tu / th, mu_tau_eta=mu * te, alpha_2=al / f32(2),
                tol2=f32(0.01) * f32(0.01), tau_chi=tc)
    for k, v in want.items():
        assert s[SCALARS.index(k)] == v, k


def _patches(p, b, seed):
    from faldoi_tpu.core.local_step import _patch_geometry

    rng = np.random.default_rng(seed)
    idx = rng.choice(H * W, b, replace=False)
    idx[:6] = [0, W - 1, H * W - 1, (H - 1) * W, 2, 3 * W - 1]
    i, j, oy, ox, ph, pw = (np.asarray(x) for x in _patch_geometry(
        jnp.asarray(idx), H, W, p // 2))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0 = np.where(inbox, 2.6 + rng.normal(0, 0.5, (b, p, p)), 0).astype(np.float32)
    v0 = np.where(inbox, -1.4 + rng.normal(0, 0.5, (b, p, p)), 0).astype(np.float32)
    c0 = np.where(inbox, rng.random((b, p, p)) < 0.3, 0).astype(np.float32)
    assert (ph < p).any() and (pw < p).any()
    return (i, j, oy, ox, ph, pw), u0, v0, c0, inbox


def _jax_solve(frames, geo, u0, v0, c0, p, warps, max_iters):
    from faldoi_tpu.core.functionals import SOLVERS

    jsc = frames["jsc"]
    f = jax.vmap(lambda *x: SOLVERS[8](jsc, *x, p, warps, max_iters, p // 2))
    return [np.asarray(x) for x in f(*map(jnp.asarray, (*geo, u0, v0, c0)))]


@pytest.mark.parametrize("p,b,warps", [(11, 40, 1), (3, 30, 1), (11, 12, 2)],
                         ids=["P11", "P3", "P11-2warps"])
def test_canvas_solver_matches_jax(frames, p, b, warps):
    """``solve_tvl1_occ`` (K0 crops, K4's patch form at u and -u, K9's
    twin, the energy) against JAX's ``SOLVERS[8]`` on B canvases with boxes
    clipped at the image edge, three PD iterations a warp; the port's
    canvases are zero outside the box, JAX's chi too."""
    from faldoi_tpu_torch.core.functionals import solve_tvl1_occ
    from faldoi_tpu_torch.core.occlusion import occ_patch_loop

    geo, u0, v0, c0, inbox = _patches(p, b, 93 + p + warps)
    ju, jv, jc, je = _jax_solve(frames, geo, u0, v0, c0, p, warps, 3)
    before = occ_patch_loop.launches
    pu, pv, pc, pe = solve_tvl1_occ(frames["sc"], *map(T, geo), T(u0), T(v0),
                                    p, warps, 3, chi=T(c0))
    assert occ_patch_loop.launches == before             # the twin ran
    close(pu.numpy()[inbox], ju[inbox], ATOL_U)
    close(pv.numpy()[inbox], jv[inbox], ATOL_U)
    assert np.array_equal(pc.numpy(), jc)
    assert (pu.numpy()[~inbox] == 0).all() and (pc.numpy()[~inbox] == 0).all()
    np.testing.assert_allclose(pe.numpy(), je, rtol=1e-5, atol=1e-5)
    assert pc.numpy().any() and not pc.numpy()[inbox].all()


def test_jax_canvas_spread(frames):
    """JAX's own canvas solve under 1e-6 px of init noise: the scale the
    port's gate of 1e-4 px sits above (measured 8.2e-6 px)."""
    geo, u0, v0, c0, inbox = _patches(11, 40, 104)
    a = _jax_solve(frames, geo, u0, v0, c0, 11, 1, 3)
    b = _jax_solve(frames, geo, u0 + np.float32(1e-6) * inbox, v0, c0, 11, 1, 3)
    spread = max(np.abs(a[k] - b[k])[inbox].max() for k in (0, 1))
    assert 0 < spread < ATOL_U


def _per_canvas_loop(st, wc, g, ph, pw, scal, max_iters):
    """The PD loop written canvas by canvas, as JAX's while_loop reads:
    step while err > tol^2 and n < max_iters."""
    from faldoi_tpu_torch.core.occlusion import SCALARS, occ_pd_step

    tol2 = float(scal[SCALARS.index("tol2")])
    outs, iters = [], []
    for k in range(st.shape[1]):
        s = st[:, k:k + 1]
        err, n = float("inf"), 0
        while err > tol2 and n < max_iters:
            s, e = occ_pd_step(s, wc[:, k:k + 1], g[k:k + 1], ph[k:k + 1],
                               pw[k:k + 1], scal)
            err, n = float(e[0]), n + 1
        outs.append(s)
        iters.append(n)
    return torch.cat(outs, dim=1), iters


@pytest.mark.parametrize("p,chi,tol2", [(11, "random", None), (3, "ones", None),
                                        (11, "zeros", 0.2)])
def test_patch_twin_matches_the_loop_canvas_by_canvas(p, chi, tol2):
    """K9's patch twin (the masked batch loop) equals the loop run canvas
    by canvas bit for bit, iteration counts included; with tol^2 0.2 some
    canvases stop before the cap and others run on."""
    from faldoi_tpu_torch.core.occlusion import (
        SCALARS, occ_patch_loop, occ_patch_loop_plain,
    )

    st, wc, g, ph, pw, scal = syn.occ_patch_inputs(9, p, 105 + p, "cpu", chi)
    if tol2 is not None:
        scal[SCALARS.index("tol2")] = tol2
    want, iters = _per_canvas_loop(st, wc, g, ph, pw, scal, 3)
    got, n = occ_patch_loop_plain(st, wc, g, ph, pw, scal, 3)
    assert torch.equal(got, want) and n.tolist() == iters
    assert torch.equal(occ_patch_loop(st, wc, g, ph, pw, scal, 3)[0], got)
    if tol2 is not None:
        assert 1 <= min(iters) < max(iters) == 3
    assert set(got[2].unique().tolist()) <= {0.0, 1.0}


def test_global_twin_is_the_step_on_one_canvas():
    """K9's whole-image twin, one PD iteration, is ``occ_pd_step`` on the
    image as one canvas with the box (h, w); the largest squared update
    that step reports is that of u."""
    from faldoi_tpu_torch.core.occlusion import occ_global_loop, occ_pd_step

    st, wc, g, scal = syn.occ_global_inputs(30, 41, 106, "cpu", True)
    got, n = occ_global_loop(st, wc, g, scal, 1)
    want, werr = occ_pd_step(st[:, None], wc[:, None], g[None],
                             torch.tensor([30]), torch.tensor([41]), scal)
    assert torch.equal(got, want[:, 0]) and int(n) == 1
    d = (got[0] - st[0]) ** 2 + (got[1] - st[1]) ** 2
    assert float(werr[0]) == float(d.max())


def _host_loop(st, wc, g, scal, max_iters):
    """The whole-image loop as ``tvl2_occ_global`` ran it before K9's
    whole-image form took the tol exit onto the card: ``occ_pd_step`` on the
    image as one canvas, the err read on the host after every PD
    iteration."""
    from faldoi_tpu_torch.core.occlusion import SCALARS, occ_pd_step

    h, w = g.shape
    box = torch.tensor([h]), torch.tensor([w])
    tol2 = float(scal[SCALARS.index("tol2")])
    err, n = float("inf"), 0
    while err > tol2 and n < max_iters:
        new, e = occ_pd_step(st[:, None], wc[:, None], g[None], *box, scal)
        st, err, n = new[:, 0], float(e[0]), n + 1
    return st, n


@pytest.mark.parametrize("occ_init,max_iters,tol2,nan", [
    (True, 3, None, False), (False, 3, None, False), (True, 5, 1e10, False),
    (True, 0, None, False), (False, 1, None, False), (True, 4, None, True)],
    ids=["chi-given", "chi0", "one-iteration", "max0", "max1", "nan-err"])
def test_global_loop_twin_matches_the_host_loop(occ_init, max_iters, tol2, nan):
    """``occ_global_loop_plain`` (what ``occ_global_loop`` runs on the CPU)
    equals the host loop it replaced bit for bit, state and count, at 40x56:
    chi given and 0, a tol^2 of 1e10 that stops after one PD iteration, caps
    of 0 and 1, and a NaN err (a NaN warp constant), which stops the loop
    after its first PD iteration (the synthetic inputs never meet the
    default tol within three)."""
    from faldoi_tpu_torch.core.occlusion import (
        SCALARS, occ_global_loop, occ_global_loop_plain,
    )

    st, wc, g, scal = syn.occ_global_inputs(40, 56, 108, "cpu", occ_init)
    if tol2 is not None:
        scal[SCALARS.index("tol2")] = tol2
    if nan:
        wc[:, 20, 30] = float("nan")
    want, wn = _host_loop(st, wc, g, scal, max_iters)
    got, n = occ_global_loop_plain(st, wc, g, scal, max_iters)
    assert got.view(torch.int32).equal(want.contiguous().view(torch.int32))
    assert n.dtype == torch.int32 and int(n) == wn
    again = occ_global_loop(st, wc, g, scal, max_iters)[0]
    assert again.view(torch.int32).equal(got.view(torch.int32))
    assert wn == (1 if nan or tol2 else min(max_iters, 3))
    assert bool(got.isnan().any()) == nan


def test_global_kernel_count_needs_the_card():
    """The count of the whole-image form's kernel launches is taken from a
    CUDA graph: CPU tensors, which have no kernels, are refused."""
    from faldoi_tpu_torch.core.occlusion import occ_global_loop_kernels

    st, wc, g, scal = syn.occ_global_inputs(5, 7, 107, "cpu", False)
    with pytest.raises(ValueError, match="CUDA device"):
        occ_global_loop_kernels(st, wc, g, scal)

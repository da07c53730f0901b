"""TV-CSAD and NLTV-CSAD (methods 4-7) of the port against faldoi_tpu: the
breakpoint planes and the v-step (K8's twin) in both forms, the four patch
solvers, the two global steps and the carried consts.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 33x47 and the global crops 40x56 and 30x40 are traced by no other
test file).  The breakpoints and the v-step agree within 1e-5 abs, and the
v-step's non-finite cells (the patch form's cells outside the box, where no
neighbour counts and the rank n + 1 entry is +inf) are equal, NaN included;
the patch solvers agree within 1e-5 abs (energies within a relative 1e-5);
NLTV-CSAD's global step and one iteration of TV-CSAD's hold a mean EPE of
1e-5 px; TV-CSAD's tolerance exit stops each warp at the iteration JAX's
does (read from JAX's own ``lax.while_loop`` as it runs, by a debug callback
on its counter in a fresh trace), and its whole run, which does not
converge, is held at the scale of its float32 chaos (see the test).  XLA may contract a*b+c into one FMA on the CPU, the port
never does."""

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

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 33, 47            # module tests
CSAD_METHODS = (P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD, P.M_NLTVCSAD_W)


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.array(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def frames():
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=81, full_shape=(80, 100))
    a, b = prepare_pair(i0, i1, device="cpu")
    return dict(i0=i0, i1=i1, a=a, b=b, gf=gf)


def test_offsets_and_image_masks_match_jax():
    from faldoi_tpu.core.global_step_csad import _csad_setup
    from faldoi_tpu_torch.ops.csad import CSAD_OFFS, image_masks

    offs, masks, ncount = _csad_setup(H, W)
    assert CSAD_OFFS == offs and len(offs) == 48
    m, n = image_masks(H, W, "cpu")
    assert np.array_equal(m.numpy(), np.asarray(masks))
    assert np.array_equal(n.numpy(), np.asarray(ncount))
    assert n[0, 0] == 15 and n[H // 2, W // 2] == 48      # corner, interior


def _global_inputs(frames, seed, ties=False):
    """Whole-image v-step inputs: a flow near the known one, the warp's
    derivatives and grad, the breakpoints.  ``ties``: b, u and l_t grad on a
    0.25 grid, so entries tie within and across the two lists."""
    rng = np.random.default_rng(seed)
    u1 = (frames["gf"][..., 0] + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    u2 = (frames["gf"][..., 1] + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    gx, gy = (rng.normal(0, 0.1, (2, H, W))).astype(np.float32)
    b = rng.normal(0, 1.0, (48, H, W)).astype(np.float32)
    grad = np.hypot(gx * gx + gy * gy, np.float32(0.01)).astype(np.float32)
    l_t = np.float32(0.85 * 0.3)
    if ties:
        u1 = np.zeros_like(u1)
        u2 = np.zeros_like(u2)
        b = np.round(b * 4) / 4
        grad = np.ones_like(grad)
        l_t = np.float32(0.25)
    return u1, u2, b, gx, gy, grad, l_t


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_vstep_global_matches_jax(frames, ties):
    from faldoi_tpu.core.global_step_csad import _csad_setup
    from faldoi_tpu.core.global_step_csad import _csad_vstep as jvstep
    from faldoi_tpu_torch.ops.csad import csad_vstep, csad_vstep_plain, image_masks

    u1, u2, b, gx, gy, grad, l_t = _global_inputs(frames, 82, ties)
    _, masks, ncount = _csad_setup(H, W)
    b = np.where(np.asarray(masks), b, 0).astype(np.float32)
    jv1, jv2 = jvstep(*map(jnp.asarray, (u1, u2, b, gx, gy, grad)), masks,
                      ncount, l_t * jnp.asarray(grad))
    m, n = image_masks(H, W, "cpu")
    before = csad_vstep.launches
    v1, v2 = csad_vstep(*map(T, (u1, u2, b, gx, gy, grad)), float(l_t), m, n)
    assert csad_vstep.launches == before                 # the twin ran
    close(v1, jv1)
    close(v2, jv2)
    assert np.isfinite(v1.numpy()).all()
    if ties:
        # exact on a grid: every selected entry is one of the tied values
        assert np.array_equal(v1.numpy(), np.asarray(jv1))
    else:
        # the edge and corner cells moved as well
        assert (v1[0] != T(u1)[0]).all() and v1[0, 0] != u1[0, 0]
    w1, _ = csad_vstep_plain(*map(T, (u1, u2, b, gx, gy, grad)), T(l_t), m, n)
    assert torch.equal(v1, w1)


def _patches(p, b, seed, noise=1.0):
    """B patch geometries of radius p // 2 with the four image corners and
    every edge (boxes clamped at the image edge), and init canvases: a
    constant flow plus ``noise`` px."""
    from faldoi_tpu.core.local_step import _patch_geometry

    rng = np.random.default_rng(seed)
    idx = rng.choice(H * W, b, replace=False)
    idx[:8] = [0, W - 1, H * W - 1, (H - 1) * W,
               3, 2 * W, 3 * W - 1, (H - 1) * W + 7]
    i, j, oy, ox, ph, pw = (np.asarray(x) for x in _patch_geometry(
        jnp.asarray(idx), H, W, p // 2))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0 = np.where(inbox, 2.6 + rng.normal(0, noise, (b, p, p)), 0).astype(np.float32)
    v0 = np.where(inbox, -1.4 + rng.normal(0, noise, (b, p, p)), 0).astype(np.float32)
    assert (ph < p).any() and (pw < p).any()
    return (i, j, oy, ox, ph, pw), u0, v0


def _jax_canvas(p, ph, pw):
    from faldoi_tpu.core.functionals import _csad_masks

    rows, cols = jnp.arange(p)[:, None], jnp.arange(p)[None, :]

    def one(ph_, pw_):
        inbox = (rows < ph_) & (cols < pw_)
        m = _csad_masks(rows, cols, ph_, pw_) & inbox[None]
        return m, m.sum(axis=0).astype(jnp.float32)

    return jax.vmap(one)(jnp.asarray(ph), jnp.asarray(pw))


@pytest.mark.parametrize("p", [11, 3])
def test_canvas_masks_and_b_match_jax(frames, p):
    from faldoi_tpu.core.functionals import _csad_b as jb
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b

    (_, _, _, _, ph, pw), u0, v0 = _patches(p, 48, 83 + p)
    rng = np.random.default_rng(84)
    i0p, i1w, gx, gy = rng.normal(0, 0.3, (4,) + u0.shape).astype(np.float32)
    grad = np.hypot(gx * gx + gy * gy, np.float32(0.01)).astype(np.float32)
    jm, jn = _jax_canvas(p, ph, pw)
    m, n = canvas_masks(T(ph).to(torch.int32), T(pw).to(torch.int32), p)
    assert np.array_equal(m.permute(1, 0, 2, 3).numpy(), np.asarray(jm))
    assert np.array_equal(n.numpy(), np.asarray(jn))
    want = jax.vmap(jb)(*map(jnp.asarray, (i0p, i1w, gx, gy, u0, v0, grad)), jm)
    got = csad_b(*map(T, (i0p, i1w, gx, gy, u0, v0, grad)), m)
    close(got.permute(1, 0, 2, 3), want)
    assert got.shape == (48, 48, p, p)


@pytest.mark.parametrize("weighted", [False, True], ids=["m4", "m5"])
def test_vstep_patch_matches_jax(frames, weighted):
    """The patch form on boxes clamped at the image edge, l_t one value or
    one a cell: in-box cells within 1e-5, the out-of-box cells' +-inf and
    NaN (where i1wx is 0) equal; the twin and the wrapper's CPU path agree
    bit for bit."""
    from faldoi_tpu.core.functionals import _csad_vstep as jvstep
    from faldoi_tpu_torch.ops.csad import (
        canvas_masks, csad_b, csad_vstep, csad_vstep_plain,
    )

    p = 11
    (_, _, _, _, ph, pw), u0, v0 = _patches(p, 64, 85)
    rng = np.random.default_rng(86 + weighted)
    i0p, i1w, gx, gy = rng.normal(0, 0.3, (4,) + u0.shape).astype(np.float32)
    gx[:, -1, :] = 0.0                 # NaN, not -inf, outside the box there
    grad = np.hypot(gx * gx + gy * gy, np.float32(0.01)).astype(np.float32)
    l_t = (np.float32(0.3) * rng.uniform(0.1, 1.0, u0.shape).astype(np.float32)
           if weighted else np.full(u0.shape, np.float32(0.85) * np.float32(0.3)))
    m, n = canvas_masks(T(ph).to(torch.int32), T(pw).to(torch.int32), p)
    b = csad_b(*map(T, (i0p, i1w, gx, gy, u0, v0, grad)), m)
    jm, jn = _jax_canvas(p, ph, pw)
    jv1, jv2 = jax.vmap(jvstep)(*map(jnp.asarray, (u0, v0)),
                                jnp.asarray(b.permute(1, 0, 2, 3).numpy()),
                                *map(jnp.asarray, (gx, gy, grad)), jm, jn,
                                jnp.asarray(l_t))
    lt = T(l_t) if weighted else T(l_t[0, 0, 0])
    box = (T(ph).to(torch.int32), T(pw).to(torch.int32))
    v1, v2 = csad_vstep(*map(T, (u0, v0)), b, *map(T, (gx, gy, grad)), lt, m,
                        n, *box)
    inbox = n.numpy() > 0
    assert (~inbox).any() and inbox.any()
    for got, want in ((v1, jv1), (v2, jv2)):
        got, want = got.numpy(), np.asarray(want)
        close(got[inbox], want[inbox])
        assert np.isfinite(got[inbox]).all()
        np.testing.assert_array_equal(got[~inbox], want[~inbox])   # NaN == NaN
    assert np.isnan(v1.numpy()[~inbox]).any() and np.isinf(v2.numpy()[~inbox]).any()
    w1, w2 = csad_vstep_plain(*map(T, (u0, v0)), b, *map(T, (gx, gy, grad)), lt,
                              m, n)
    assert torch.equal(w1.nan_to_num(7.0), v1.nan_to_num(7.0))
    assert torch.equal(w2.nan_to_num(7.0), v2.nan_to_num(7.0))


@pytest.fixture(scope="module")
def consts(frames):
    """The forward consts of methods 4-7, JAX's and the port's own."""
    from faldoi_tpu.core.functionals import make_solver_consts as jconsts
    from faldoi_tpu.core.patch_solver import pad_for_crops
    from faldoi_tpu.models import method_local_params as jparams
    from faldoi_tpu.ops.stencils import centered_gradient
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, solver_consts_from_numpy,
    )

    a, b = frames["a"], frames["b"]
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    jbx, jby = centered_gradient(jb)
    out = {}
    for m in CSAD_METHODS:
        lam, theta, tau = jparams(m, 5)
        jsc = jconsts(m, pad_for_crops(ja, 11), jb, jbx, jby, lam, theta, tau,
                      0.01, wr=5, i0_planes=frames["i0"], p=11)
        assert jsc.wp_blk is None and jsc.i1_blk is None
        own = make_solver_consts(a, b, lam, theta, tau, 0.01, 11, m,
                                 i0_planes=frames["i0"])
        out[m] = dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"), own=own)
    return out


def test_consts_from_numpy_for_m6(consts):
    """solver_consts_from_numpy carries JAX's m6 consts with the Lab weight
    planes; the port's own consts hold the same numbers, and the window
    only where the method is weighted."""
    c = consts[P.M_NLTVCSAD]
    assert tuple(c["sc"].wp_pad.shape) == (24, H + 11, W + 11)
    close(c["sc"].wp_pad, c["jsc"].wp_pad, 0)
    close(c["own"].wp_pad, c["jsc"].wp_pad, 0)
    for got, want in zip(c["own"][:9], c["sc"][:9]):
        close(got, want)
    for m, cm in consts.items():
        assert (cm["own"].w1d is None) == (m in (P.M_TVCSAD, P.M_NLTVCSAD))
        assert (cm["own"].wp_pad is None) == (m in (P.M_TVCSAD, P.M_TVCSAD_W))
        if cm["own"].w1d is not None:
            close(cm["own"].w1d, cm["jsc"].w1d, 0)


# (method, p, true_tv) -> the crops and JAX's one-warp solve of them
_JAX_SOLVES = {}


def _jax_patch_solve(consts, method, p, true_tv):
    """JAX's vmapped CSAD patch solver (one warp, four PD iterations, JAX's
    window radius p // 2) on 80 crops of the module's frames; the init is a
    constant flow plus 0.3 px of noise.  Returns (geometry, u0, v0, JAX's
    u, v and energies), computed once a module."""
    from faldoi_tpu.core.functionals import SOLVERS as JSOLVERS

    key = (method, p, true_tv)
    if key not in _JAX_SOLVES:
        c = consts[method]
        geo, u0, v0 = _patches(p, 80, 87 + p + method, noise=0.3)
        jsolve = JSOLVERS[method]

        def one(i_, j_, oy_, ox_, ph_, pw_, a_, b_):
            return jsolve(c["jsc"], i_, j_, oy_, ox_, ph_, pw_, a_, b_,
                          jnp.zeros_like(a_), p, 1, 4, p // 2)

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FALDOI_CSAD_TRUE_TV", "1" if true_tv else "0")
            ju, jv, _, je = jax.vmap(one)(*map(jnp.asarray, geo + (u0, v0)))
        _JAX_SOLVES[key] = (geo, u0, v0, ju, jv, je)
    return _JAX_SOLVES[key]


@pytest.mark.parametrize("method,p,true_tv", [
    (P.M_TVCSAD, 11, False), (P.M_TVCSAD, 3, False), (P.M_TVCSAD, 11, True),
    (P.M_TVCSAD_W, 11, False), (P.M_NLTVCSAD, 11, False),
    (P.M_NLTVCSAD_W, 3, False)],
    ids=["m4-p11", "m4-p3", "m4-true-tv", "m5", "m6", "m7-p3"])
def test_csad_patch_solver_matches_jax(consts, method, p, true_tv):
    """The four CSAD patch solvers (K8's twin inside, K0's and K4's twins
    around it) against JAX's vmapped solver, with JAX's window radius
    p // 2; m4 also with the per-component TV (JAX under
    ``FALDOI_CSAD_TRUE_TV=1``), one warp (the local step's default).  The
    out-of-box cells take +-inf / NaN in the loop, as in JAX.  The init is a
    constant flow plus 0.3 px of noise, so that every patch's warped cells
    stay inside the 32-px window of JAX's windowed warp (beyond it JAX
    clamps the samples, a TPU shortcut the port's exact warp does not
    keep); the test checks that they do.  (A second warp re-samples at
    flows whose cells spread by 77-130 px on these patches, so JAX's window
    clamps there and two warps cannot be held to JAX.)

    The CSAD solve divides by grad, which sits near its floor of 0.01 on
    these smooth frames, twice (in b and in v = u - i1wx med / grad): it
    amplifies a float32 rounding of the entries ~1e4-fold, and XLA's FMA
    contractions on the CPU are such roundings.  Measured on these inputs:
    0-0.7% of the cells beyond 1e-5 and at most 5.8e-5, energies within a
    relative 1.2e-5.  The gates: at most 1% of the cells beyond 1e-5, all
    within 1e-4, energies within a relative 1e-4."""
    from faldoi_tpu_torch.core.functionals import solver_for
    from faldoi_tpu_torch.ops.csad import csad_vstep

    c = consts[method]
    geo, u0, v0, ju, jv, je = _jax_patch_solve(consts, method, p, true_tv)
    kw = dict(true_tv=True) if true_tv else {}
    before = csad_vstep.launches
    su, sv, ener = solver_for(method)(c["sc"], *map(T, geo), T(u0), T(v0), p,
                                      1, 4, **kw)
    assert csad_vstep.launches == before                 # the twin ran
    d = np.abs(np.concatenate([(su.numpy() - np.asarray(ju)).ravel(),
                               (sv.numpy() - np.asarray(jv)).ravel()]))
    je = np.asarray(je)
    assert np.isfinite(je).all() and np.isfinite(ener.numpy()).all()
    assert (d > ATOL).mean() <= 0.01 and d.max() <= 1e-4
    np.testing.assert_allclose(ener.numpy(), je, rtol=1e-4, atol=0)
    # the solve moved the flow, and JAX's warp window held every patch
    assert float((su - T(u0)).abs().max()) > 1e-3
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < geo[4][:, None, None]) & (cols < geo[5][:, None, None])
    for f, lo in ((np.asarray(ju), geo[3][:, None, None] + cols),
                  (np.asarray(jv), geo[2][:, None, None] + rows)):
        pos = np.where(inbox, f + lo, np.nan)
        spread = np.nanmax(pos, axis=(1, 2)) - np.nanmin(pos, axis=(1, 2))
        assert spread.max() < 32 - 4


@pytest.mark.parametrize("method,p", [(P.M_TVCSAD, 11), (P.M_TVCSAD, 3),
                                      (P.M_TVCSAD_W, 11), (P.M_TVCSAD_W, 3)],
                         ids=["m4-p11", "m4-p3", "m5-p11", "m5-p3"])
def test_patch_loop_plain_matches_jax(consts, method, p):
    """The K8 loop's twin, ``csad_patch_loop_plain``, on the port's own warp
    of the crops of ``test_csad_patch_solver_matches_jax`` (K0's and K4's
    twins, grad, the breakpoints, l_t with m5's window), against JAX's
    inert-TV solve of one warp: the in-box cells within the gates of that
    test (at most 1% beyond 1e-5, all within 1e-4; the same float32 chaos).
    Every canvas takes 1 to 4 steps."""
    from faldoi_tpu_torch.core.functionals import _weight2d
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b, csad_patch_loop_plain
    from faldoi_tpu_torch.ops.patch_gather import gather_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    sc = consts[method]["sc"]
    geo, u0, v0, ju, jv, _ = _jax_patch_solve(consts, method, p, False)
    ci, cj, oy, ox, ph, pw = (T(g) for g in geo)
    oy32, ox32, ph32, pw32 = (x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw))
    u1, u2 = T(u0), T(v0)
    i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, oy32, ox32, ph32, pw32,
                                         u1, u2, 3)
    i0p = gather_patches(sc.i0pad[:, :, None], oy32, ox32, p)[:, :, 0, :]
    i0p = i0p.permute(2, 0, 1)
    grad = hypot(gx * gx + gy * gy, 0.01)
    m, n = canvas_masks(ph32, pw32, p)
    l_t = sc.lambda_ * sc.theta
    if method == P.M_TVCSAD_W:
        rows, cols = canvas_ids(p, "cpu")
        l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy, ox, cj, ci, p // 2)).contiguous()
    su, sv, _, _, iters = csad_patch_loop_plain(
        u1, u2, u1, u2, csad_b(i0p, i1w, gx, gy, u1, u2, grad, m), gx, gy, grad,
        l_t, m, n, ph32, pw32, sc.theta, sc.tau, sc.tol * sc.tol, 4)
    inbox = n.numpy() > 0
    d = np.abs(np.concatenate([(su.numpy() - np.asarray(ju))[inbox],
                               (sv.numpy() - np.asarray(jv))[inbox]]))
    assert np.isfinite(d).all()
    assert (d > ATOL).mean() <= 0.01 and d.max() <= 1e-4
    assert ((iters >= 1) & (iters <= 4)).all()
    assert float((su - u1).abs()[T(inbox)].max()) > 1e-3


def test_true_tv_changes_the_solve(consts):
    """The per-component TV gives another energy than the inert TV."""
    from faldoi_tpu_torch.core.functionals import solve_tvcsad

    c = consts[P.M_TVCSAD]["sc"]
    geo, u0, v0 = _patches(11, 16, 90, noise=0.3)
    e_inert = solve_tvcsad(c, *map(T, geo), T(u0), T(v0), 11, 1, 4)[2]
    e_tv = solve_tvcsad(c, *map(T, geo), T(u0), T(v0), 11, 1, 4, true_tv=True)[2]
    assert (e_tv > e_inert).all()


# the final counters of the traced ``lax.while_loop``s, appended as they run
# (one list for the module: a later test may reuse an earlier test's trace)
COUNTS = []


def _counted(cond, body, init):
    """``jax.lax.while_loop``, recording the loop's final counter (the
    tvcsad state's element 9) in ``COUNTS`` as it runs."""
    out = _WHILE_LOOP(cond, body, init)
    jax.debug.callback(lambda n: COUNTS.append(int(n)), out[9], ordered=True)
    return out


_WHILE_LOOP = jax.lax.while_loop


def _global_case(h, w, seed):
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(h, w, seed=seed, full_shape=(90, 120))
    a, b = prepare_pair(i0, i1, device="cpu")
    rng = np.random.default_rng(seed + 1)
    flow = (gf + rng.normal(0, 0.3, gf.shape)).astype(np.float32)
    return i0, a, b, flow


def test_tvcsad_global_one_iteration_matches_jax():
    """One PD iteration of tvcsad_global (K8's twin, K4's flow-form twin)
    from the same flow at 40x56 against JAX's: mean EPE <= 1e-5 px (3.6e-7
    measured), every element within 1e-4 (3.3e-5 measured: the warped
    planes' last-bit differences, amplified by the two divisions by grad)."""
    from faldoi_tpu.core.global_step_csad import tvcsad_global as jglobal
    from faldoi_tpu_torch.core.global_step_csad import tvcsad_global
    from faldoi_tpu_torch.models import method_global_params

    _, a, b, flow = _global_case(40, 56, 91)
    lam, theta, tau = method_global_params(P.M_TVCSAD, P.Parameters())
    j1, j2 = jglobal(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                     jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]), lam,
                     theta, tau, P.PAR_DEFAULT_TOL_D, 1, max_iters=1)
    stats = {}
    u1, u2 = tvcsad_global(a, b, T(flow[..., 0]), T(flow[..., 1]), lam, theta,
                           tau, P.PAR_DEFAULT_TOL_D, 1, max_iters=1,
                           stats=stats)
    assert stats["global_iters"] == [1]
    port = torch.stack([u1, u2], -1).numpy()
    ref = np.stack([np.asarray(j1), np.asarray(j2)], -1)
    assert syn.epe(port, ref) <= 1e-5
    close(port, ref, 1e-4)
    assert syn.epe(port, flow) > 1e-3                   # it moved


@pytest.mark.parametrize("tol", [P.PAR_DEFAULT_TOL_D, 0.1],
                         ids=["tol-default", "tol-0.1"])
def test_tvcsad_global_matches_jax(tol):
    """tvcsad_global at 40x56, the global CLI's 5 warps of at most 400
    iterations, against JAX's ``tvcsad_global``: the same PD iterations per
    warp (at the default tolerance every warp runs to the cap: the mean
    squared update never falls below 0.0067 against tol^2 1e-4; at 0.1 the
    first warp stops after 10).

    The loop does not converge on this pair: the flow keeps moving by ~0.2
    px an iteration, and a last-bit difference grows to 0.004 px of mean EPE
    within 50 iterations of one warp and to 0.097-0.112 px (4.3-6.4 px at
    the worst pixel) after 5 warps, whatever the order of the float32
    operations.  So the flows are held to JAX at that scale: mean EPE <=
    0.15 px, and each as close to the known flow as the other within 0.05
    px (0.349 against 0.321, 0.291 against 0.293 measured).  One iteration
    is held within 1e-5 above."""
    from faldoi_tpu.core import global_step_csad as jgs
    from faldoi_tpu_torch.core.global_step_csad import tvcsad_global
    from faldoi_tpu_torch.models import method_global_params
    from faldoi_tpu_torch.ops.csad import csad_vstep

    _, a, b, flow = _global_case(40, 56, 91)
    gf = syn.make_pair(40, 56, seed=91, full_shape=(90, 120))[2]
    prm = P.Parameters()
    warps = P.PAR_DEFAULT_NWARPS_GLOBAL               # global_faldoi's -w
    lam, theta, tau = method_global_params(P.M_TVCSAD, prm)
    COUNTS.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "while_loop", _counted)
        offs, masks, ncount = jgs._csad_setup(40, 56)
        fresh = jax.jit(jgs._tvcsad_jit.__wrapped__,
                        static_argnames=("offs", "warps", "max_iters"))
        j1, j2 = fresh(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                       jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]),
                       masks, ncount, offs, lam, theta, tau, tol, warps,
                       P.MAX_ITERATIONS_GLOBAL)
        jax.block_until_ready((j1, j2))
        jax.effects_barrier()
    counts = list(COUNTS)
    before = csad_vstep.launches
    stats = {}
    u1, u2 = tvcsad_global(a, b, T(flow[..., 0]), T(flow[..., 1]), lam, theta,
                           tau, tol, warps, stats=stats)
    assert csad_vstep.launches == before
    assert stats["global_iters"] == counts and len(counts) == warps
    if tol == P.PAR_DEFAULT_TOL_D:
        assert counts == [P.MAX_ITERATIONS_GLOBAL] * warps
    else:
        assert min(counts) < P.MAX_ITERATIONS_GLOBAL   # a warp stopped on tol
    port = torch.stack([u1, u2], -1).numpy()
    ref = np.stack([np.asarray(j1), np.asarray(j2)], -1)
    assert np.isfinite(port).all()
    assert syn.epe(port, ref) <= 0.15
    assert abs(syn.epe(port, gf) - syn.epe(ref, gf)) <= 0.05
    assert syn.epe(port, flow) > 0.01                   # it moved


def test_nltvcsad_global_matches_jax():
    """nltvcsad_global at 30x40, 2 warps of 60 iterations (the duals carried
    across the warps), against JAX's ``nltvcsad_global``: mean EPE <= 1e-5
    px.  (The whole 5 x 400 at 40x56 held 5.8e-6 px when measured; this
    loop converges, unlike TV-CSAD's.)"""
    from faldoi_tpu.core.global_step_csad import nltvcsad_global as jglobal
    from faldoi_tpu_torch.core.global_step_csad import nltvcsad_global
    from faldoi_tpu_torch.models import method_global_params

    i0, a, b, flow = _global_case(30, 40, 93)
    lam, theta, tau = method_global_params(P.M_NLTVCSAD, P.Parameters())
    j1, j2 = jglobal(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), i0,
                     jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]), lam,
                     theta, tau, 2, max_iters=60)
    stats = {}
    u1, u2 = nltvcsad_global(a, b, i0, T(flow[..., 0]), T(flow[..., 1]), lam,
                             theta, tau, 2, max_iters=60, stats=stats)
    assert stats["global_iters"] == [60, 60]
    port = torch.stack([u1, u2], -1).numpy()
    ref = np.stack([np.asarray(j1), np.asarray(j2)], -1)
    assert syn.epe(port, ref) <= 1e-5
    assert syn.epe(port, flow) > 0.01

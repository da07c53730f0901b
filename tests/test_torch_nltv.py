"""NLTV-L1 (methods 2 and 3) of the port against faldoi_tpu: the Lab
conversion and support weights, the non-local operators, the global loop's
twin (K6's) and the patch solvers (K7's twin inside), and the stage CLIs'
method gate.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; the frame shape 37x51 is traced by no other test file, and
``_nltvl1_jit`` by no other test at 44x60).  The weights must equal JAX's
bit for bit (both are the same numpy code); operators, the K6 twin and the
patch solvers agree within 1e-5 abs (energies within a relative 1e-5): XLA
may contract a*b+c into one FMA on the CPU, the port never does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 37, 51            # module tests
GH, GW = 44, 60          # the global loop against _nltvl1_jit


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

    i0, i1, gf, gb = syn.make_pair(H, W, seed=51, full_shape=(70, 90))
    a, b = prepare_pair(i0, i1, device="cpu")
    return dict(i0=i0, i1=i1, a=a, b=b, gf=gf)


def test_lab_matches_jax(frames):
    from faldoi_tpu.ops.nonlocal_ops import rgb_to_lab_np as jlab
    from faldoi_tpu_torch.ops.nonlocal_ops import rgb_to_lab_np

    for planes in (frames["i0"], frames["i1"][:1]):        # colour and gray
        got, want = rgb_to_lab_np(planes), jlab(planes)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("ws,wi", [(2.0, 2.0), (2.0, 5.0)], ids=["local", "global"])
def test_nltv_weights_match_jax(frames, ws, wi):
    from faldoi_tpu.ops.nonlocal_ops import nltv_weights as jweights
    from faldoi_tpu_torch.ops.nonlocal_ops import nltv_weights, rgb_to_lab_np

    lab = rgb_to_lab_np(frames["i0"])
    got, want = nltv_weights(lab, 2, ws, wi), jweights(lab, 2, ws, wi)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[2]) == 24
    # zero exactly where the neighbour leaves the image
    assert (got[0][:, 0, 0] == 0).sum() == 24 - 8


def _mirrored(wp):
    """Plane j of w_{23-j}(x + d_j), zero where x + d_j leaves the grid: the
    weights K6 reads for j >= 12 (any leading dims of ``wp`` after the 24)."""
    from faldoi_tpu_torch.ops.nonlocal_ops import neighbor_offsets, shift_each

    return shift_each(wp.flip(0), neighbor_offsets(2))


@pytest.mark.parametrize("kind,shape", [
    ("global", (37, 51)), ("global", (40, 56)), ("local", (37, 51)),
    ("local", (40, 56)), ("crop11", (37, 51)), ("crop3", (37, 51))])
def test_weights_are_symmetric(frames, kind, shape):
    """w_j(x) == w_{23-j}(x + d_j) bit for bit, which K6 relies on to read
    only weight planes 0-11: the global weights (scales 2 / 5), the local
    ones (2 / 2) on seeded frames of an odd and an even shape, and the
    box-masked crops of ``nltv_crop_weights`` on boxes clamped at the image
    edge (ph, pw < P)."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts, nltv_crop_weights
    from faldoi_tpu_torch.core.global_step_nltv import global_weights
    from faldoi_tpu_torch.ops.nonlocal_ops import nltv_weights, rgb_to_lab_np

    h, w = shape
    i0 = np.random.default_rng(61 + h).uniform(0, 255, (3, h, w)).astype(np.float32)
    if kind == "global":
        wp = global_weights(i0, "cpu")[0]
    elif kind == "local":
        wp = T(nltv_weights(rgb_to_lab_np(i0), 2, 2.0, 2.0)[0])
    else:
        p = int(kind[4:])
        sc = make_solver_consts(frames["a"], frames["b"], 2.0, 0.3, 0.1, 0.01,
                                11, P.M_NLTVL1, i0_planes=frames["i0"])
        (_, _, oy, ox, ph, pw), _, _ = _patches(p, 64, 62 + p)
        wp = nltv_crop_weights(sc.wp_pad, *map(T, (oy, ox, ph, pw)), p)[0]
        assert (ph < p).any() and (pw < p).any()
    assert bool((wp > 0).any())
    assert torch.equal(wp.view(torch.int32), _mirrored(wp).view(torch.int32))


def _operator_inputs(frames, seed):
    from faldoi_tpu_torch.ops.nonlocal_ops import nltv_weights, rgb_to_lab_np

    rng = np.random.default_rng(seed)
    wp, wt, offs = nltv_weights(rgb_to_lab_np(frames["i0"]), 2, 2.0, 5.0)
    sc = rng.normal(0, 0.4, wp.shape).astype(np.float32)
    u = (frames["gf"][..., 0] + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    return sc, u, wp, wt, offs


def test_shift_pull_matches_jax(frames):
    from faldoi_tpu.ops.nonlocal_ops import shift_pull as jshift
    from faldoi_tpu_torch.ops.nonlocal_ops import shift_pull

    sc, u, _, _, offs = _operator_inputs(frames, 52)
    for dy, dx in offs + [(0, 0), (-2, 2)]:
        close(shift_pull(T(u), dy, dx), jshift(jnp.asarray(u), dy, dx), 0)
        close(shift_pull(T(sc[:3]), dy, dx), jshift(jnp.asarray(sc[:3]), dy, dx), 0)


def test_gradient_duals_match_jax(frames):
    from faldoi_tpu.ops.nonlocal_ops import nonlocal_gradient_duals as jgetd
    from faldoi_tpu_torch.ops.nonlocal_ops import nonlocal_gradient_duals

    sc, u, wp, wt, offs = _operator_inputs(frames, 53)
    got = nonlocal_gradient_duals(T(sc), T(u), T(wp), T(wt), offs, 0.1)
    close(got, jgetd(*map(jnp.asarray, (sc, u, wp, wt)), offs, 0.1))
    # duals on an out-of-image edge stay as they were
    assert torch.equal(got[0, 0], T(sc)[0, 0])


def test_divergence_matches_jax(frames):
    from faldoi_tpu.ops.nonlocal_ops import nonlocal_divergence as jdiv
    from faldoi_tpu_torch.ops.nonlocal_ops import nonlocal_divergence

    sc, _, wp, wt, offs = _operator_inputs(frames, 54)
    close(nonlocal_divergence(T(sc), T(wp), T(wt), offs),
          jdiv(*map(jnp.asarray, (sc, wp, wt)), offs))


def test_global_loop_twin_matches_jax():
    """nltvl1_global (K6's twin for the loop, K4's twin for the warps) at
    2 warps x 30 iterations against JAX's _nltvl1_jit, the duals carried
    across the warps."""
    from faldoi_tpu.core.global_step_nltv import _nltvl1_jit
    from faldoi_tpu.ops.nonlocal_ops import nltv_weights as jweights
    from faldoi_tpu.ops.nonlocal_ops import rgb_to_lab_np as jlab
    from faldoi_tpu_torch.core.global_step_nltv import (
        nltv_global_loop, nltvl1_global,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(GH, GW, seed=55, full_shape=(80, 100))
    a, b = prepare_pair(i0, i1, device="cpu")
    rng = np.random.default_rng(56)
    flow = (gf + rng.normal(0, 0.3, gf.shape)).astype(np.float32)
    wp, wt, offs = jweights(jlab(i0), 2, 2.0, 5.0)
    ju1, ju2 = _nltvl1_jit(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                           jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]),
                           jnp.asarray(wp), jnp.asarray(wt), tuple(offs), 2.0,
                           0.3, 0.1, 2, 30)
    before = nltv_global_loop.launches
    stats = {}
    u1, u2 = nltvl1_global(a, b, i0, T(flow[..., 0]), T(flow[..., 1]), 2.0,
                           0.3, 0.1, 2, 30, stats=stats)
    assert nltv_global_loop.launches == before          # the twin ran
    assert stats["global_iters"] == [30, 30]
    close(u1, ju1)
    close(u2, ju2)
    assert float((u1 - T(flow[..., 0])).abs().max()) > 0.01    # it moved


@pytest.fixture(scope="module")
def consts(frames):
    """The forward consts of methods 2 and 3, JAX's and the port's own, at
    P 11 (the seed insertion crops its 3x3 windows from the same planes)."""
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
    for m in (P.M_NLTVL1, P.M_NLTVL1_W):
        lam, theta, tau = jparams(m, 5)
        jsc = jconsts(m, pad_for_crops(ja, 11), jb, jbx, jby, lam, theta, tau,
                      0.01, wr=5, i0_planes=frames["i0"], p=11)
        assert jsc.wp_blk is None and jsc.i1_blk is None
        own = make_solver_consts(a, b, lam, theta, tau, 0.01, 11, m,
                                 i0_planes=frames["i0"])
        out[m] = dict(jsc=jsc, sc=solver_consts_from_numpy(jsc, "cpu"), own=own)
    return out


def test_consts_carry_the_weights(consts, frames):
    from faldoi_tpu_torch.core.functionals import make_solver_consts

    for m, c in consts.items():
        assert tuple(c["own"].wp_pad.shape) == (24, H + 11, W + 11)
        close(c["own"].wp_pad, c["jsc"].wp_pad, 0)
        close(c["sc"].wp_pad, c["jsc"].wp_pad, 0)
        assert (c["own"].w1d is None) == (m == P.M_NLTVL1)
        for got, want in zip(c["own"][:8], c["sc"][:8]):
            close(got, want)
    with pytest.raises(ValueError, match="colour planes"):
        make_solver_consts(frames["a"], frames["b"], 2.0, 0.3, 0.1, 0.01, 11,
                           P.M_NLTVL1)


def _patches(p, b, seed):
    """B patch geometries of radius p // 2 including the four image corners
    and every edge (boxes clamped at the image edge), and init canvases."""
    from faldoi_tpu.core.local_step import _patch_geometry

    rng = np.random.default_rng(seed)
    idx = rng.choice(H * W, b, replace=False)
    idx[:8] = [0, W - 1, H * W - 1, (H - 1) * W,              # corners
               3, 2 * W, 3 * W - 1, (H - 1) * W + 7]          # the four edges
    i, j, oy, ox, ph, pw = (np.asarray(x) for x in _patch_geometry(
        jnp.asarray(idx), H, W, p // 2))
    rows, cols = np.mgrid[0:p, 0:p]
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    u0 = np.where(inbox, 2.6 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)
    v0 = np.where(inbox, -1.4 + rng.normal(0, 1.0, (b, p, p)), 0).astype(np.float32)
    assert (ph < p).any() and (pw < p).any()
    return (i, j, oy, ox, ph, pw), u0, v0


@pytest.mark.parametrize("p", [11, 3])
def test_crop_weights_match_jax(consts, p):
    from faldoi_tpu.core.functionals import _nltv_crop_weights as jcrop
    from faldoi_tpu_torch.core.functionals import nltv_crop_weights

    c = consts[P.M_NLTVL1]
    (_, _, oy, ox, ph, pw), _, _ = _patches(p, 64, 57 + p)
    rows, cols = jnp.arange(p)[:, None], jnp.arange(p)[None, :]
    jwp, jwt = jax.vmap(lambda oy_, ox_, ph_, pw_: jcrop(
        c["jsc"], oy_, ox_, p, rows, cols, ph_, pw_))(*map(jnp.asarray, (oy, ox, ph, pw)))
    wp, wt = nltv_crop_weights(c["sc"].wp_pad, *map(T, (oy, ox, ph, pw)), p)
    close(wp.permute(1, 0, 2, 3), jwp, 0)
    close(wt, jwt, 1e-6)


@pytest.mark.parametrize("method,p,warps", [
    (P.M_NLTVL1, 11, 2), (P.M_NLTVL1, 3, 1), (P.M_NLTVL1_W, 11, 1),
    (P.M_NLTVL1_W, 3, 2)])
def test_nltv_patch_solver_matches_jax(consts, method, p, warps):
    """solve_nltvl1 / solve_nltvl1_w (K0's planes-form twin, K4's patch-form
    twin and K7's twin inside) against JAX's vmapped solver, with JAX's
    window radius p // 2 (the seed insertion's 3x3 solves read the tail of
    the 11-tap window); two warps carry the duals across."""
    from faldoi_tpu.core.functionals import SOLVERS as JSOLVERS
    from faldoi_tpu_torch.core.functionals import nltv_patch_loop, solver_for

    c = consts[method]
    geo, u0, v0 = _patches(p, 96, 58 + p + method)
    jsolve = JSOLVERS[method]

    def one(i_, j_, oy_, ox_, ph_, pw_, a_, b_):
        return jsolve(c["jsc"], i_, j_, oy_, ox_, ph_, pw_, a_, b_,
                      jnp.zeros_like(a_), p, warps, 4, p // 2)

    ju, jv, _, je = jax.vmap(one)(*map(jnp.asarray, geo + (u0, v0)))
    before = nltv_patch_loop.launches
    su, sv, ener = solver_for(method)(c["sc"], *map(T, geo), T(u0), T(v0), p,
                                      warps, 4)
    assert nltv_patch_loop.launches == before            # the twin ran
    close(su, ju)
    close(sv, jv)
    je = np.asarray(je)
    np.testing.assert_allclose(ener.numpy(), je, rtol=1e-5, atol=0)
    assert np.isfinite(je).all()


def test_patch_loop_twin_lanes_freeze_alone(consts):
    """K7's twin: lanes of small data gradients meet tol^2 after one
    iteration and freeze, the others run to max_iters; every lane comes out
    as it does when it is solved alone."""
    from faldoi_tpu_torch.core.functionals import (
        nltv_crop_weights, nltv_patch_loop_plain,
    )

    c = consts[P.M_NLTVL1]["sc"]
    p, b = 11, 24
    (_, _, oy, ox, ph, pw), _, _ = _patches(p, b, 60)
    wp, wt = nltv_crop_weights(c.wp_pad, *map(T, (oy, ox, ph, pw)), p)
    rng = np.random.default_rng(3)
    scale = torch.linspace(0, 1, b)[:, None, None]
    gx, gy, rc, u1, u2 = (T(rng.normal(0, s, (b, p, p)).astype(np.float32))
                          for s in (0.05, 0.05, 0.1, 0.02, 0.02))
    gx, gy = gx * scale, gy * scale
    cv = (gx, gy, gx * gx + gy * gy, rc)
    box = tuple(T(x).to(torch.int32) for x in (ph, pw))
    scal = (c.theta, c.tau, c.tol * c.tol)
    out = nltv_patch_loop_plain(u1, u2, u1, u2, None, *cv, wp, wt,
                                c.lambda_ * c.theta, *box, *scal, 6)
    assert {1, 6} <= set(out[4].tolist()) and out[5] is None
    for k in (0, 12, 17, b - 1):
        one = nltv_patch_loop_plain(
            u1[k:k + 1], u2[k:k + 1], u1[k:k + 1], u2[k:k + 1], None,
            *(x[k:k + 1] for x in cv), wp[:, k:k + 1], wt[k:k + 1],
            c.lambda_ * c.theta, *(x[k:k + 1] for x in box), *scal, 6,
            keep_duals=True)
        for x, y in zip(one[:5], out[:5]):
            assert torch.equal(x[0], y[k])
        assert one[5].shape == (2, 24, 1, p, p)


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A 30x40 crop pair as .npy frames, with seeds, for the stage CLIs."""
    from faldoi_tpu_torch.io.flo import write_flo

    d = tmp_path_factory.mktemp("nltv_cli")
    i0, i1, gf, gb = syn.make_pair(30, 40, seed=62)
    rng = np.random.default_rng(63)
    names = []
    for k, im in enumerate((i0, i1)):
        names.append(str(d / f"f{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    (d / "ims.txt").write_text("\n".join(names) + "\n")
    (d / "ims4.txt").write_text("\n".join(names * 2) + "\n")   # 4 frames: m8
    write_flo(str(d / "go.flo"), syn.make_seeds(
        gf, syn.random_seed_positions(30, 40, 25, rng), rng))
    write_flo(str(d / "ba.flo"), syn.make_seeds(
        gb, syn.random_seed_positions(30, 40, 25, rng), rng))
    return d, gf


@pytest.mark.parametrize("method", [P.M_NLTVL1, P.M_NLTVL1_W])
def test_stage_clis_run_nltv_on_cpu(cli_case, method):
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.io.flo import read_flo

    d, gf = cli_case
    rg, var = str(d / f"rg{method}.flo"), str(d / f"var{method}.flo")
    assert local_faldoi.main([str(d / "ims.txt"), str(d / "go.flo"),
                              str(d / "ba.flo"), rg, str(d / f"sim{method}.tiff"),
                              "-m", str(method), "-loc_it", "1", "-bsz", "256",
                              "-device", "cpu"]) == 0
    stats = {}
    assert global_faldoi.main([str(d / "ims.txt"), rg, var, "-m", str(method),
                               "-device", "cpu"], stats=stats) == 0
    assert stats["global_iters"] == [400] * 5
    flow = read_flo(var)
    assert np.isfinite(read_flo(rg)).all() and np.isfinite(flow).all()
    assert syn.epe(flow, gf) < 1.5


@pytest.mark.parametrize("method", [9, 10])
def test_stage_clis_refuse_unported_methods(cli_case, method, capsys):
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi

    d, _ = cli_case
    ims = str(d / "ims4.txt")
    assert global_faldoi.main([ims, str(d / "go.flo"), str(d / "x.flo"), "-m",
                               str(method), "-device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert f"unknown method {method}" in err and "methods are 0-8" in err
    assert local_faldoi.main([ims, str(d / "go.flo"), str(d / "ba.flo"),
                              str(d / "x.flo"), str(d / "x.tiff"), "-m",
                              str(method), "-device", "cpu"]) == 2

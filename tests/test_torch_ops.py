"""The port's ops against faldoi_tpu's: stencils, normalization, Gaussian,
prepare_pair, bicubic sampling (K4's twin), the patch gather (the twins of
K0's stack and planes forms),
the Poisson fill and the PD building blocks.

The same numpy inputs (from ``default_rng``) go through the JAX function and
the port on ``device="cpu"``; float32 results must agree within 1e-5 abs
unless stated, the patch gather exactly.  The JAX side runs in the repo's
exact configuration (env knobs set for the whole module)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import ref_numpy as ref

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_image_stencils_match_jax():
    from faldoi_tpu.ops import stencils as J
    from faldoi_tpu_torch.ops import stencils as S

    rng = np.random.default_rng(0)
    f = rng.standard_normal((37, 53)).astype(np.float32)
    g = rng.standard_normal((37, 53)).astype(np.float32)
    for a, b in zip(S.forward_gradient(T(f)), J.forward_gradient(jnp.asarray(f))):
        close(a, b)
    for a, b in zip(S.centered_gradient(T(f)), J.centered_gradient(jnp.asarray(f))):
        close(a, b)
    close(S.divergence(T(f), T(g)), J.divergence(jnp.asarray(f), jnp.asarray(g)))
    close(S.divergence(T(f), T(g)), ref.divergence(f, g))


def test_patch_stencils_match_jax():
    from faldoi_tpu.ops import stencils as J
    from faldoi_tpu_torch.ops import stencils as S

    rng = np.random.default_rng(1)
    b, p = 40, 11
    f = rng.standard_normal((b, p, p)).astype(np.float32)
    g = rng.standard_normal((b, p, p)).astype(np.float32)
    ph = rng.integers(1, p + 1, b).astype(np.int32)
    pw = rng.integers(1, p + 1, b).astype(np.int32)
    jfx, jfy = jax.vmap(J.forward_gradient_patch)(jnp.asarray(f), ph, pw)
    fx, fy = S.forward_gradient_patch(T(f), T(ph), T(pw))
    close(fx, jfx)
    close(fy, jfy)
    jd = jax.vmap(J.divergence_patch)(jnp.asarray(f), jnp.asarray(g), ph, pw)
    close(S.divergence_patch(T(f), T(g), T(ph), T(pw)), jd)


def test_normalization_and_gaussian_match_jax():
    from faldoi_tpu.ops import gaussian as JG, normalize as JN
    from faldoi_tpu_torch.ops import gaussian as SG, normalize as SN

    rng = np.random.default_rng(2)
    a, b, c = (rng.uniform(0, 255, (33, 47)).astype(np.float32) for _ in range(3))
    for x, y in zip(SN.image_normalization(T(a), T(b)),
                    JN.image_normalization(jnp.asarray(a), jnp.asarray(b))):
        close(x, y)
    for x, y in zip(SN.image_normalization_3(T(a), T(b), T(c)),
                    JN.image_normalization_3(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(c))):
        close(x, y)
    x = rng.uniform(0, 1, (33, 47)).astype(np.float32)
    close(SG.gaussian_smooth(T(x), 0.9), JG.gaussian_smooth(jnp.asarray(x), 0.9))
    close(SG.gaussian_smooth(T(x), 0.9), ref.gaussian(x, 0.9))
    np.testing.assert_array_equal(SG.gaussian1d_weight(5), JG.gaussian1d_weight(5))


def test_prepare_pair_matches_jax():
    from faldoi_tpu.core.preprocess import prepare_pair as jprep
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    rng = np.random.default_rng(3)
    i0 = rng.uniform(0, 255, (3, 31, 45)).astype(np.float32)
    i1 = rng.uniform(0, 255, (3, 31, 45)).astype(np.float32)
    for x, y in zip(prepare_pair(i0, i1, device="cpu"), jprep(i0, i1)):
        close(x, y)


def _bicubic_points(rng, ny, nx, n):
    """Sample points in and around the domain, with every sign combination
    (the my-row-uses-sx quirk shows only when sign(uu) != sign(vv))."""
    uu = rng.uniform(-6, nx + 6, n).astype(np.float32)
    vv = rng.uniform(-6, ny + 6, n).astype(np.float32)
    uu[:40] = -rng.uniform(0, 3, 40)                 # uu < 0, vv >= 0
    vv[40:80] = -rng.uniform(0, 3, 40)               # uu >= 0, vv < 0
    uu[80:90] = np.arange(10, dtype=np.float32) - 0.0  # integers, -0 sign
    vv[90:100] = ny - 1 + rng.uniform(0, 2, 10)
    return uu, vv


@pytest.mark.parametrize("border_out", [True, False])
def test_bicubic_matches_jax_and_c_oracle(border_out):
    from faldoi_tpu.ops.bicubic import bicubic_interp_at as jinterp
    from faldoi_tpu_torch.ops.bicubic import bicubic_interp_at, bicubic_sample

    rng = np.random.default_rng(4)
    ny, nx = 29, 41
    img = rng.uniform(0, 1, (ny, nx)).astype(np.float32)
    uu, vv = _bicubic_points(rng, ny, nx, 600)
    got = bicubic_interp_at(T(img), T(uu), T(vv), border_out).numpy()
    close(got, jinterp(jnp.asarray(img), jnp.asarray(uu), jnp.asarray(vv),
                       border_out))
    # the C transliteration (float64) near the domain, where |t| stays small
    near = (uu > -2) & (uu < nx + 1) & (vv > -2) & (vv < ny + 1)
    want = np.array([ref.bicubic_at(img, u, v, border_out)
                     for u, v in zip(uu[near], vv[near])])
    close(got[near], want, atol=2e-5)
    # shared weights across planes equal per-plane sampling
    planes = np.stack([img, 2 * img, img * img])
    multi = bicubic_sample(T(planes), T(uu), T(vv), border_out).numpy()
    for c in range(3):
        close(multi[c], bicubic_interp_at(T(planes[c]), T(uu), T(vv),
                                          border_out))


def test_bicubic_warp_stack_matches_jax():
    from faldoi_tpu.ops.bicubic import bicubic_warp as jwarp1
    from faldoi_tpu.ops.bicubic import bicubic_warp_stack as jwarp
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp, bicubic_warp_stack

    rng = np.random.default_rng(5)
    ny, nx = 38, 70
    planes = rng.uniform(0, 1, (3, ny, nx)).astype(np.float32)
    yy, xx = np.mgrid[0:ny, 0:nx]
    u = (4 * np.sin(xx / 9.0) + rng.uniform(-1, 1, (ny, nx))).astype(np.float32)
    v = (3 * np.cos(yy / 7.0) - 2).astype(np.float32)
    got = bicubic_warp_stack(T(planes), T(u), T(v), True)
    close(got, jwarp(jnp.asarray(planes), jnp.asarray(u), jnp.asarray(v), True))
    for border_out in (True, False):
        close(bicubic_warp(T(planes[0]), T(u), T(v), border_out),
              jwarp1(jnp.asarray(planes[0]), jnp.asarray(u), jnp.asarray(v),
                     border_out))


def test_bicubic_patch_warp_matches_window_sample():
    """The patch solver's warp: per-point K4 twin vs JAX's windowed one-hot
    sample (``_warp3`` with FALDOI_BLOCKGATHER=0), border_out=False."""
    from faldoi_tpu.ops.bicubic import bicubic_window_sample
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample

    rng = np.random.default_rng(6)
    planes = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    rows, cols = np.mgrid[0:11, 0:11]
    for oy, ox in ((0, 0), (29, 45), (12, 20), (35, 50)):
        uu = (ox + cols + rng.uniform(-6, 6, (11, 11))).astype(np.float32)
        vv = (oy + rows + rng.uniform(-5, 5, (11, 11))).astype(np.float32)
        want = bicubic_window_sample(jnp.asarray(planes), jnp.asarray(uu),
                                     jnp.asarray(vv), False, win=32)
        close(bicubic_sample(T(planes), T(uu), T(vv), False), want)


@pytest.mark.parametrize("p,c", [(11, 5), (3, 1)])
def test_gather_patches_is_dynamic_slice(p, c):
    from faldoi_tpu.ops.pallas_sweep import _xla_gather_patches
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    rng = np.random.default_rng(7)
    h, w = 23, 29
    stack = rng.standard_normal((h + 11, w + 11, c)).astype(np.float32)
    stack[rng.random(stack.shape) < 0.1] = np.nan
    n = h * w
    b = 64
    oy = rng.integers(-4, h + 15, b).astype(np.int32)
    ox = rng.integers(-4, w + 15, b).astype(np.int32)
    oy[:2], ox[:2] = h - 5, 0          # the dump lane's origin (idx = n)
    oy[2], ox[2] = n // w - 1, n % w   # clamped starts
    got = gather_patches(T(stack), T(oy), T(ox), p).numpy()
    want = np.asarray(_xla_gather_patches(jnp.asarray(stack), jnp.asarray(oy),
                                          jnp.asarray(ox), p))
    assert got.shape == (p, p, c, b)
    np.testing.assert_array_equal(got, want)


def _state_planes(rng, h, w, c, trust_dtype):
    """c - 1 flat float32 state planes (h*w + 1 elements: the dump slot last),
    NaN where unfixed, and an (h, w) trust map of ``trust_dtype``."""
    planes = []
    for _ in range(c - 1):
        pl = rng.standard_normal(h * w + 1).astype(np.float32)
        pl[rng.random(h * w + 1) < 0.3] = np.nan
        planes.append(pl)
    planes.append((rng.random((h, w)) > 0.2).astype(trust_dtype))
    return planes


def _crop_origins(rng, h, w, p, b):
    """int64 starts: the corners, the dump lane (j = h), negative starts,
    starts past the end, and random ones around the image."""
    wr = p // 2
    oy = rng.integers(-4, h + 15, b)
    ox = rng.integers(-4, w + 15, b)
    oy[:4], ox[:4] = [0, 0, h - 1 - wr, h - 1 - wr], [0, w - 1 - wr, 0, w - 1 - wr]
    oy[4], ox[4] = h - wr, 0                      # the dump index h*w: j = h, i = 0
    oy[5:8], ox[5:8] = [-3, -1, -(h + p)], [-7, w + 40, 0]
    oy[8:10], ox[8:10] = [h + 50, 2 * h], [w, 2 * w + 3]
    return oy.astype(np.int64), ox.astype(np.int64)


@pytest.mark.parametrize("trust_dtype", [np.float32, np.int32])
@pytest.mark.parametrize("p,c", [(11, 5), (11, 1), (3, 5), (3, 1)])
def test_plane_patches_twin_is_the_stack_pad_crop(p, c, trust_dtype):
    """K0's planes form (its twin) equals, bit for bit, the composition it
    replaces in the sweep (stack, edge pad, the stack form's crop) and JAX's
    ``jnp.stack`` + ``jnp.pad(mode="edge")`` + ``dynamic_slice``."""
    from faldoi_tpu.ops.pallas_sweep import _xla_gather_patches
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_patches_plain, gather_plane_patches, pad_for_crops,
    )

    rng = np.random.default_rng(100 + p + c)
    h, w, b = 23, 29, 64
    planes = _state_planes(rng, h, w, c, trust_dtype)
    oy, ox = _crop_origins(rng, h, w, p, b)
    got = gather_plane_patches([T(x) for x in planes], T(oy), T(ox), p, h, w)
    assert got.shape == (c, b, p, p) and got.dtype == torch.float32
    assert got.is_contiguous()
    imgs = [np.asarray(x).reshape(-1)[:h * w].reshape(h, w).astype(np.float32)
            for x in planes]
    stack = torch.stack([T(x) for x in imgs], dim=-1)
    want = gather_patches_plain(pad_for_crops(stack, p), T(oy), T(ox), p)
    got_pcb = got.permute(2, 3, 0, 1).numpy()             # (p, p, C, B)
    np.testing.assert_array_equal(got_pcb, want.numpy())
    jstack = jnp.pad(jnp.stack([jnp.asarray(x) for x in imgs], axis=-1),
                     ((0, p), (0, p), (0, 0)), mode="edge")
    jwant = _xla_gather_patches(jstack, jnp.asarray(oy.astype(np.int32)),
                                jnp.asarray(ox.astype(np.int32)), p)
    np.testing.assert_array_equal(got_pcb, np.asarray(jwant))
    assert np.isnan(got_pcb).any() == (c > 1)


@pytest.mark.parametrize("fault,error", [
    ("dtype", TypeError), ("device", ValueError), ("contiguous", ValueError),
    ("size", ValueError), ("count", ValueError), ("origins", ValueError),
])
def test_plane_patches_wrapper_raises(fault, error):
    from faldoi_tpu_torch.ops.patch_gather import MAX_PLANES, gather_plane_patches

    h, w, p = 12, 16, 3
    planes = [torch.zeros(h * w + 1), torch.zeros((h, w), dtype=torch.int32)]
    oy = torch.zeros(5, dtype=torch.int64)
    ox = oy.clone()
    if fault == "dtype":
        planes[0] = planes[0].double()
    elif fault == "device":
        planes[1] = torch.zeros((h, w), device="meta")
    elif fault == "contiguous":
        planes[1] = torch.zeros((w, h)).t()
    elif fault == "size":
        planes[0] = torch.zeros(h * w + 2)
    elif fault == "count":
        planes = [planes[0]] * (MAX_PLANES + 1)
    else:
        ox = ox[:4]
    with pytest.raises(error):
        gather_plane_patches(planes, oy, ox, p, h, w)


@pytest.mark.parametrize("exact", [True, False])
def test_poisson_fill_matches_jax(exact):
    from faldoi_tpu.ops.poisson import poisson_fill_canvas as jfill
    from faldoi_tpu_torch.ops.poisson import poisson_fill_canvas

    rng = np.random.default_rng(8)
    for p in (11, 3):
        b = 48
        x = rng.uniform(-3, 3, (b, p, p)).astype(np.float32)
        x[rng.random(x.shape) < 0.8] = np.nan
        x[0] = np.nan
        x[0, p // 2, p // 2] = 1.5                      # a lone centre
        ph = rng.integers(1, p + 1, b).astype(np.int32)
        pw = rng.integers(1, p + 1, b).astype(np.int32)
        ph[:4], pw[:4] = p, p
        want = jax.vmap(lambda c, a, d: jfill(c, a, d, exact=exact))(
            jnp.asarray(x), ph, pw)
        got = poisson_fill_canvas(T(x), T(ph), T(pw), exact=exact)
        close(got, want)
        if exact:
            for k in range(4):
                close(got[k].numpy(),
                      ref.elap_recursive(x[k].copy(), 0.4, 3, 7), atol=1e-5)


def test_pd_common_matches_jax():
    from faldoi_tpu.core import pd_common as J
    from faldoi_tpu_torch.core import pd_common as S

    rng = np.random.default_rng(9)
    a = [rng.standard_normal((21, 33)).astype(np.float32) for _ in range(8)]
    a[5] = a[5] * 1e-5                                 # grad near zero
    a[5][:3] = 0.0
    l_t = np.float32(40.0) * np.float32(0.3)
    for x, y in zip(S.tvl1_threshold(*map(T, a[:6]), float(l_t)),
                    J.tvl1_threshold(*map(jnp.asarray, a[:6]), l_t)):
        close(x, y)
    for x, y in zip(S.tvl2_getD(*map(T, a), 0.125),
                    J.tvl2_getD(*map(jnp.asarray, a), np.float32(0.125))):
        close(x, y)
    for x, y in zip(S.tvl2_getP(*map(T, a[:6]), 0.3, 0.125),
                    J.tvl2_getP(*map(jnp.asarray, a[:6]), np.float32(0.3),
                                np.float32(0.125))):
        close(x, y)
    for x, y in zip(S.warp_constants(*map(T, a[:6])),
                    J.warp_constants(*map(jnp.asarray, a[:6]))):
        close(x, y)


def _old_solver_warp(planes, oy, ox, ph, pw, u1, u2):
    """The patch solver's warp before K4's patch form: the points composed
    in PyTorch, then K4's point form (its twin here)."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    rows, cols = canvas_ids(u1.shape[-1], u1.device)
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None])
    gx = (ox[:, None, None] + cols).to(u1.dtype)
    gy = (oy[:, None, None] + rows).to(u1.dtype)
    zero = torch.zeros((), dtype=u1.dtype)
    uu = (gx + torch.where(inbox, u1, zero)).contiguous()
    vv = (gy + torch.where(inbox, u2, zero)).contiguous()
    return bicubic_sample(planes, uu, vv, False)


def _solver_patches(rng, ny, nx, p, b):
    """Patch boxes of the solver (patch_geometry of candidate indices: the
    corners, every edge, the dump index ny*nx) and flow canvases: smooth,
    a motion edge of 40 px inside some patches, NaN and far-out cells."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    idx = rng.integers(0, ny * nx, b)
    idx[:7] = [0, nx - 1, ny * nx - 1, (ny - 1) * nx, 3, 2 * nx, ny * nx]
    _, _, oy, ox, ph, pw = patch_geometry(T(idx), ny, nx, p // 2)
    u1 = rng.normal(2.6, 0.8, (b, p, p)).astype(np.float32)
    u2 = rng.normal(-1.4, 0.8, (b, p, p)).astype(np.float32)
    u1[7:15, :, p // 2:] += 40.0                       # a motion edge
    u2[15:20, p // 2:, :] -= 35.0
    u1[20, 0, 0] = np.nan
    u2[21, 1, 1] = -1e12
    return [x.to(torch.int32) for x in (oy, ox, ph, pw)] + [T(u1), T(u2)]


@pytest.mark.parametrize("p,nplanes", [(11, 3), (11, 1), (3, 3), (3, 1)])
def test_patch_form_twin_equals_solver_warp(p, nplanes):
    """K4's patch form (its twin) equals the solver's former warp bit for
    bit on clamped edge boxes, the dump lane, wide-span and NaN patches, and
    JAX's exact per-point sample within 1e-5."""
    from faldoi_tpu.ops.bicubic import bicubic_interp_at as jinterp
    from faldoi_tpu_torch.ops.bicubic import _patch_points, bicubic_sample_patches

    rng = np.random.default_rng(11 + p + nplanes)
    ny, nx = 37, 53
    planes = T(rng.uniform(0, 1, (3, ny, nx)).astype(np.float32))
    geo = _solver_patches(rng, ny, nx, p, 60)
    assert (geo[2] < p).any() and (geo[3] < p).any()    # clamped boxes
    got = bicubic_sample_patches(planes, *geo, nplanes)
    assert got.shape == (nplanes, 60, p, p)
    want = _old_solver_warp(planes[:nplanes], *geo)
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    uu, vv = _patch_points(*geo)
    ok = torch.isfinite(uu) & torch.isfinite(vv) & (uu.abs() < 1e6) & (vv.abs() < 1e6)
    for c in range(nplanes):
        ref_c = np.asarray(jinterp(jnp.asarray(planes[c].numpy()),
                                   jnp.asarray(uu.numpy()), jnp.asarray(vv.numpy()),
                                   False))
        close(got[c][ok], ref_c[ok.numpy()])


def test_cpu_tensors_take_the_twins():
    """On the CPU each kernel wrapper returns its plain twin's result and
    counts no launch (the kernels themselves run in tests/test_torch_card.py)."""
    from faldoi_tpu_torch.core.global_step import (
        global_pd_loop, global_pd_loop_plain,
    )
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_patches, bicubic_sample_patches_plain,
        bicubic_sample_plain,
    )
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_patches, gather_patches_plain, gather_plane_patches,
        gather_plane_patches_plain,
    )

    rng = np.random.default_rng(10)
    wrappers = (gather_patches, gather_plane_patches, bicubic_sample,
                bicubic_sample_patches, global_pd_loop)
    counts = tuple(fn.launches for fn in wrappers)
    stack = T(rng.standard_normal((20, 24, 2)).astype(np.float32))
    oy = T(rng.integers(-3, 20, 30).astype(np.int32))
    ox = T(rng.integers(-3, 24, 30).astype(np.int32))
    assert torch.equal(gather_patches(stack, oy, ox, 5),
                       gather_patches_plain(stack, oy, ox, 5))
    state = [T(x) for x in _state_planes(rng, 20, 24, 3, np.int32)]
    oy64, ox64 = oy.to(torch.int64), ox.to(torch.int64)
    assert torch.equal(
        gather_plane_patches(state, oy64, ox64, 5, 20, 24).nan_to_num(7.0),
        gather_plane_patches_plain(state, oy64, ox64, 5, 20, 24).nan_to_num(7.0))
    planes = T(rng.uniform(0, 1, (2, 20, 24)).astype(np.float32))
    uu, vv = (T(x) for x in _bicubic_points(rng, 20, 24, 200))
    assert torch.equal(bicubic_sample(planes, uu, vv, True),
                       bicubic_sample_plain(planes, uu, vv, True))
    geo = _solver_patches(rng, 20, 24, 5, 30)
    assert torch.equal(bicubic_sample_patches(planes, *geo, 2).nan_to_num(7.0),
                       bicubic_sample_patches_plain(planes, *geo, 2).nan_to_num(7.0))
    st = [T(rng.standard_normal((9, 11)).astype(np.float32)) for _ in range(12)]
    st2 = [x.clone() for x in st]
    n1 = global_pd_loop(*st, 12.0, 0.3, 0.125, 1e-4, 6)
    n2 = global_pd_loop_plain(*st2, 12.0, 0.3, 0.125, 1e-4, 6)
    assert n1 == n2 and all(torch.equal(a, b) for a, b in zip(st, st2))
    assert tuple(fn.launches for fn in wrappers) == counts

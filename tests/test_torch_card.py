"""The hand-written CUDA kernels (K0 in its stack and planes forms, K4 in its
point, patch and flow forms, the K5 loop, the probes P1-P3) against their
plain twins, on the card, and the weighted patch solver on the card against
its CPU run.

These tests need a CUDA card (the kernels have no CPU mode) and skip on a
host without one.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_card.py --noconftest -q

K0, P1, P2 and K4's patch form must equal their twins bit for bit, K4's flow
form the point form bit for bit; K4's point and flow forms and K5 their
twins within 1e-5 abs (the kernels are built with --fmad=false
and contract exactly where the twins do, so the usual difference is 0), K5
with the twin loop's iteration count; P3 within relative 1e-5 (another
summation order)."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import synthetic as syn

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _points(rng, ny, nx, n):
    """Sample points in and around the domain, every sign combination."""
    uu = rng.uniform(-6, nx + 6, n).astype(np.float32)
    vv = rng.uniform(-6, ny + 6, n).astype(np.float32)
    uu[:40] = -rng.uniform(0, 3, 40)
    vv[40:80] = -rng.uniform(0, 3, 40)
    return torch.as_tensor(uu), torch.as_tensor(vv)


def test_k0_matches_twin_on_card(dev):
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_patches_plain

    rng = np.random.default_rng(10)
    stack = torch.as_tensor(rng.standard_normal((60, 70, 5)).astype(np.float32))
    oy = torch.as_tensor(rng.integers(-3, 70, 500).astype(np.int32))
    ox = torch.as_tensor(rng.integers(-3, 80, 500).astype(np.int32))
    want = gather_patches_plain(stack, oy, ox, 11)
    before = gather_patches.launches
    got = gather_patches(stack.to(dev), oy.to(dev), ox.to(dev), 11)
    assert gather_patches.launches == before + 1
    assert torch.equal(got.cpu(), want)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("c,p,b", [(1, 11, 500), (1, 3, 333), (5, 11, 1),
                                   (2, 5, 77), (1, 3, 1)])
def test_k0_stack_form_shapes_on_card(dev, c, p, b):
    """The solver's source crop (C 1), the seed insertion's (p 3), B not a
    multiple of 32 and B = 1, bit for bit (NaN payloads included)."""
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_patches_plain

    rng = np.random.default_rng(20 + c + p + b)
    stack = rng.standard_normal((60, 70, c)).astype(np.float32)
    stack[rng.random(stack.shape) < 0.1] = np.nan
    stack = torch.as_tensor(stack)
    oy = torch.as_tensor(rng.integers(-3, 70, b).astype(np.int32))
    ox = torch.as_tensor(rng.integers(-3, 80, b).astype(np.int32))
    want = gather_patches_plain(stack, oy, ox, p)
    before = gather_patches.launches
    got = gather_patches(stack.to(dev), oy.to(dev), ox.to(dev), p)
    assert gather_patches.launches == before + 1
    assert got.shape == (p, p, c, b)
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("c,p,b,trust", [
    (5, 11, 500, torch.float32), (5, 11, 500, torch.int32), (5, 11, 1, torch.int32),
    (1, 3, 333, torch.float32), (8, 5, 77, torch.int32), (3, 11, 8192, torch.float32),
])
def test_k0_planes_form_matches_twin_on_card(dev, c, p, b, trust):
    """The planes form against its twin (stack, edge pad, stack-form crop),
    bit for bit: flat planes with their dump slot, an (h, w) trust map in
    either dtype, origins at the corners, the dump lane, negative and past
    the end."""
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_plane_patches, gather_plane_patches_plain,
    )

    rng = np.random.default_rng(30 + c + p + b)
    h, w = 61, 83
    planes = []
    for _ in range(c - 1):
        pl = rng.standard_normal(h * w + 1).astype(np.float32)
        pl[rng.random(h * w + 1) < 0.2] = np.nan
        planes.append(torch.as_tensor(pl))
    planes.append(torch.as_tensor(rng.random((h, w)) > 0.2).to(trust))
    oy = rng.integers(-4, h + 15, b)
    ox = rng.integers(-4, w + 15, b)
    edge = np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1],
                     [h - p // 2, 0], [-3, w + 40], [2 * h, -7]])[:b]
    oy[:len(edge)], ox[:len(edge)] = edge[:, 0], edge[:, 1]
    oy, ox = torch.as_tensor(oy), torch.as_tensor(ox)
    want = gather_plane_patches_plain(planes, oy, ox, p, h, w)
    before = gather_plane_patches.launches
    got = gather_plane_patches([x.to(dev) for x in planes], oy.to(dev), ox.to(dev),
                               p, h, w)
    assert gather_plane_patches.launches == before + 1
    assert got.shape == (c, b, p, p) and got.is_contiguous()
    assert torch.equal(_bits(got.cpu()), _bits(want))


def test_k4_matches_twin_on_card(dev):
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample, bicubic_sample_plain

    rng = np.random.default_rng(11)
    planes = torch.as_tensor(rng.uniform(0, 1, (3, 50, 60)).astype(np.float32))
    uu, vv = _points(rng, 50, 60, 2000)
    for border_out in (True, False):
        want = bicubic_sample_plain(planes, uu, vv, border_out)
        got = bicubic_sample(planes.to(dev), uu.to(dev), vv.to(dev), border_out)
        assert (got.cpu() - want).abs().max().item() <= ATOL


def _pd_state(h, w, seed, dev):
    """A warp's PD state and constants on the card, as tvl2_global builds
    them from a synthetic pair and a noisy known flow."""
    from faldoi_tpu_torch.core.pd_common import warp_constants
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    i0, i1, gf, _ = syn.make_pair(h, w, seed=seed)
    a, b = prepare_pair(i0, i1, device=dev)
    rng = np.random.default_rng(seed)
    f = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                        device=dev)
    u1, u2 = f[..., 0].contiguous(), f[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, i1wx, i1wy = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    grad, rho_c = warp_constants(a, i1w, i1wx, i1wy, u1, u2)
    xi = [torch.zeros_like(u1) for _ in range(4)]
    return [u1, u2, u1.clone(), u2.clone(), *xi, i1wx.contiguous(),
            i1wy.contiguous(), grad.contiguous(), rho_c.contiguous()]


L_T = float(np.float32(40.0) * np.float32(0.3))


@pytest.mark.parametrize("h,w,tol,max_iters", [
    (436, 1024, 0.01, 400), (97, 131, 0.01, 400),   # err <= tol^2 ends them
    (97, 131, 0.0, 37),                              # the cap ends it
])
def test_k5_loop_matches_twin_loop_on_card(dev, h, w, tol, max_iters):
    from faldoi_tpu_torch.core.global_step import global_pd_loop, global_pd_loop_plain

    st = _pd_state(h, w, 12, dev)
    twin = [x.clone() for x in st]
    tol2 = float(np.float32(tol) * np.float32(tol))
    before = global_pd_loop.launches
    n = global_pd_loop(*st, L_T, 0.3, 0.125, tol2, max_iters)
    assert global_pd_loop.launches == before + 1
    n_twin = global_pd_loop_plain(*twin, L_T, 0.3, 0.125, tol2, max_iters)
    assert n == n_twin
    assert (n == max_iters) == (tol == 0.0) and n > 1
    for a, b in zip(st, twin):
        assert (a - b).abs().max().item() <= ATOL


def test_k5_matches_twin_on_card(dev):
    from faldoi_tpu_torch.core.global_step import (
        global_pd_iteration_plain, global_pd_loop, tvl2_global,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    h, w = 40, 56
    rng = np.random.default_rng(12)
    st = [rng.normal(0, 1, (h, w)) for _ in range(4)]
    st += [rng.uniform(-0.9, 0.9, (h, w)) for _ in range(4)]
    gx, gy = rng.normal(0, 0.3, (h, w)), rng.normal(0, 0.3, (h, w))
    consts = [gx, gy, gx * gx + gy * gy, rng.normal(0, 0.5, (h, w))]
    cpu = [torch.as_tensor(np.asarray(x, np.float32)) for x in st + consts]
    card = [x.to(dev) for x in cpu]
    e_cpu = torch.empty(1)
    global_pd_iteration_plain(*cpu, e_cpu, L_T, 0.3, 0.125)
    assert global_pd_loop(*card, L_T, 0.3, 0.125, 0.0, 1) == 1   # one iteration
    for a, b in zip(card, cpu):
        assert (a.cpu() - b).abs().max().item() <= ATOL

    i0, i1, gf, _ = syn.make_pair(h, w, seed=11, full_shape=(80, 100))
    a, b = prepare_pair(i0, i1, device="cpu")
    flow = torch.as_tensor(gf + rng.normal(0, 0.3, gf.shape).astype(np.float32))
    st_cpu, st_card = {}, {}
    want = tvl2_global(a, b, flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                       warps=2, stats=st_cpu)
    got = tvl2_global(a.to(dev), b.to(dev), flow[..., 0].contiguous().to(dev),
                      flow[..., 1].contiguous().to(dev), warps=2, stats=st_card)
    assert st_card["global_iters"] == st_cpu["global_iters"]
    for x, y in zip(got, want):
        assert (x.cpu() - y).abs().max().item() <= ATOL


def test_k4_patch_form_matches_twin_on_card(dev):
    """Bit for bit, at the solver's call shapes, on clamped edge boxes, the
    dump lane, NaN cells and wide-span patches (a motion edge inside)."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample_patches, bicubic_sample_patches_plain,
    )

    rng = np.random.default_rng(16)
    ny, nx = 60, 90
    planes = torch.as_tensor(rng.uniform(0, 1, (3, ny, nx)).astype(np.float32))
    for p, b in ((11, 700), (3, 300)):
        idx = torch.as_tensor(rng.integers(0, ny * nx, b))
        idx[:5] = torch.as_tensor([0, nx - 1, ny * nx - 1, (ny - 1) * nx, ny * nx])
        _, _, oy, ox, ph, pw = patch_geometry(idx, ny, nx, p // 2)
        box = [x.to(torch.int32) for x in (oy, ox, ph, pw)]
        u1 = rng.normal(2.6, 1.0, (b, p, p)).astype(np.float32)
        u2 = rng.normal(-1.4, 1.0, (b, p, p)).astype(np.float32)
        u1[5:60, :, p // 2:] += 40.0
        u1[60, 0, 0] = np.nan
        u1, u2 = torch.as_tensor(u1), torch.as_tensor(u2)
        for nplanes in (3, 1):
            want = bicubic_sample_patches_plain(planes, *box, u1, u2, nplanes)
            before = bicubic_sample_patches.launches
            got = bicubic_sample_patches(planes.to(dev), *(x.to(dev) for x in box),
                                         u1.to(dev), u2.to(dev), nplanes).cpu()
            assert bicubic_sample_patches.launches == before + 1
            assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


def _warp_flow(kind, rng, ny, nx):
    """(ny, nx, 2) flows: constant, the smoke's smooth flow with 2 px of noise
    a pixel, and a torn one (every pixel points anywhere within 300 px)."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    if kind == "constant":
        f = np.broadcast_to(np.float32([2.6, -1.4]), (ny, nx, 2))
    elif kind == "noisy":
        f = np.stack([14 * np.sin(xx / 37.0) + 9 * np.cos(yy / 23.0),
                      11 * np.cos(xx / 29.0) - 8 * np.sin(yy / 41.0)], -1)
        f = f + rng.normal(0, 2.0, f.shape)
    else:
        f = rng.uniform(-300, 300, (ny, nx, 2))
    return torch.as_tensor(np.ascontiguousarray(f, dtype=np.float32))


@pytest.mark.parametrize("kind", ["constant", "noisy", "torn"])
@pytest.mark.parametrize("ny,nx", [(436, 1024), (97, 131), (5, 7)])
def test_k4_flow_form_matches_twin_and_point_form_on_card(dev, ny, nx, kind):
    """The flow form within 1e-5 of its twin and bit-equal to the point form
    at the same points, both border modes, the flow's halves read where they
    lie."""
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_warp_planes, bicubic_warp_planes_plain, warp_coords,
    )

    rng = np.random.default_rng(17 + ny)
    planes = torch.as_tensor(rng.uniform(0, 1, (3, ny, nx)).astype(np.float32))
    flow = _warp_flow(kind, rng, ny, nx)
    fd, pd = flow.to(dev), planes.to(dev)
    u, v = fd[..., 0], fd[..., 1]                       # strided views
    for border_out in (True, False):
        want = bicubic_warp_planes_plain(planes, flow[..., 0], flow[..., 1], border_out)
        before = bicubic_warp_planes.launches
        got = bicubic_warp_planes(pd, u, v, border_out)
        assert bicubic_warp_planes.launches == before + 1
        assert got.shape == (3, ny, nx) and got.is_contiguous()
        assert (got.cpu() - want).abs().max().item() <= ATOL
        point = bicubic_sample(pd, *warp_coords(u, v), border_out)
        assert torch.equal(_bits(got), _bits(point))
        assert torch.equal(got, bicubic_warp_planes(pd, u.contiguous(),
                                                    v.contiguous(), border_out))


@pytest.mark.parametrize("h,c", [(436, 1), (436, 3), (440, 3)])
@pytest.mark.parametrize("b", [0, 1, 1023, 8192])
def test_p3_band_form_matches_twins_on_card(dev, b, h, c):
    from faldoi_tpu_torch.ops import probes

    rng = np.random.default_rng(18 + b + h + c)
    planes = torch.as_tensor(rng.uniform(0, 1, (c, h, 1024)).astype(np.float32))
    oy8 = (rng.integers(0, (h - 40) // 8 + 1, b) * 8).astype(np.int32)
    cb = (rng.integers(0, 8, b) * 128).astype(np.int32)
    oy8[:2], cb[:2] = [(h - 40) // 8 * 8, 0][:b], [896, 0][:b]   # the far corners
    oy8, cb = torch.as_tensor(oy8), torch.as_tensor(cb)
    before = probes.probe_window_fetch.launches
    got = probes.probe_window_fetch(planes.to(dev), oy8.to(dev), cb.to(dev)).cpu()
    assert probes.probe_window_fetch.launches == before + (b > 0)
    assert got.shape == (b, 128)
    if b == 0:
        return
    for want in (probes.probe_window_fetch_plain(planes, oy8, cb),
                 probes.probe_window_fetch_bands_plain(planes, oy8, cb)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    again = probes.probe_window_fetch(planes.to(dev), oy8.to(dev), cb.to(dev)).cpu()
    assert torch.equal(got, again)                     # a fixed summation order


def test_wrappers_raise_on_bad_card_tensors(dev):
    """A CUDA tensor launches the kernel or raises; there is no fallback."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    stack = torch.zeros((20, 20, 2), device=dev)
    oy = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="int32"):
        gather_patches(stack, oy, oy, 3)
    from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches

    plane = torch.zeros(20 * 20 + 1, device=dev)
    with pytest.raises(TypeError, match="int64"):
        gather_plane_patches([plane], oy.int(), oy.int(), 3, 20, 20)
    with pytest.raises(ValueError, match="expected"):
        gather_plane_patches([plane, plane.cpu()], oy, oy, 3, 20, 20)
    planes = torch.zeros((1, 8, 8), device=dev)
    uu = torch.zeros((4, 4), device=dev).t()        # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bicubic_sample(planes, uu, uu, True)
    from faldoi_tpu_torch.core.global_step import global_pd_loop
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches

    box = torch.zeros(4, dtype=torch.int64, device=dev)
    can = torch.zeros((4, 3, 3), device=dev)
    with pytest.raises(TypeError, match="int32"):
        bicubic_sample_patches(planes, box, box, box, box, can, can, 1)
    st = [torch.zeros((5, 6), device=dev) for _ in range(12)]
    st[3] = torch.zeros((6, 5), device=dev).t()      # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        global_pd_loop(*st, 12.0, 0.3, 0.125, 1e-4, 5)
    empty = [torch.zeros((0, 6), device=dev) for _ in range(12)]
    with pytest.raises(ValueError, match="non-empty"):
        global_pd_loop(*empty, 12.0, 0.3, 0.125, 1e-4, 5)


def test_probes_match_twins_on_card(dev):
    from faldoi_tpu_torch.ops import probes

    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal((1000, 37)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((1000, 37)).astype(np.float32))
    before = probes.probe_axpy.launches
    got = probes.probe_axpy(x.to(dev), y.to(dev))
    assert probes.probe_axpy.launches == before + 1
    assert torch.equal(got.cpu(), probes.probe_axpy_plain(x, y))
    # an odd offset (the scalar kernel) and ragged sizes (the tail of the
    # vector kernel), each one launch
    for sl in (slice(1, None), slice(0, 36999), slice(0, 3), slice(0, 513),
               slice(3, 36998)):
        xs, ys = x.view(-1)[sl], y.view(-1)[sl]
        before = probes.probe_axpy.launches
        got = probes.probe_axpy(x.to(dev).view(-1)[sl], y.to(dev).view(-1)[sl])
        assert probes.probe_axpy.launches == before + 1
        assert torch.equal(got.cpu(), probes.probe_axpy_plain(xs, ys))
    r = torch.as_tensor(rng.standard_normal((11, 11, 384)).astype(np.float32))
    assert torch.equal(probes.probe_roll4(r.to(dev)).cpu(),
                       probes.probe_roll4_plain(r))
    planes = torch.as_tensor(rng.uniform(0, 1, (3, 440, 1024)).astype(np.float32))
    oy8 = torch.as_tensor((rng.integers(0, 50, 300) * 8).astype(np.int32))
    cb = torch.as_tensor((rng.integers(0, 7, 300) * 128).astype(np.int32))
    want = probes.probe_window_fetch_plain(planes, oy8, cb)
    got = probes.probe_window_fetch(planes.to(dev), oy8.to(dev), cb.to(dev))
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_window_fetch(planes.to(dev), (oy8 + 1).to(dev), cb.to(dev))


def test_weighted_solver_on_card_matches_cpu(dev):
    from faldoi_tpu_torch.core.functionals import make_solver_consts, solve_tvl1_w
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    h, w = 40, 56
    i0, i1, _, _ = syn.make_pair(h, w, seed=14)
    a, b = prepare_pair(i0, i1, device="cpu")
    lam, theta, tau = method_local_params(1, 5)
    rng = np.random.default_rng(15)
    idx = torch.as_tensor(rng.choice(h * w, 200, replace=False))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])
    for p in (11, 3):
        geo = patch_geometry(idx, h, w, p // 2)
        u0 = torch.as_tensor(rng.normal(2.6, 1.0, (200, p, p)).astype(np.float32))
        v0 = torch.as_tensor(rng.normal(-1.4, 1.0, (200, p, p)).astype(np.float32))
        outs = []
        for d in ("cpu", dev):
            sc = make_solver_consts(a.to(d), b.to(d), lam, theta, tau, 0.01, p, 1)
            outs.append(solve_tvl1_w(sc, *(g.to(d) for g in geo), u0.to(d),
                                     v0.to(d), p, 1, 4))
        for x, y in zip(outs[1], outs[0]):
            assert (x.cpu() - y).abs().max().item() <= ATOL

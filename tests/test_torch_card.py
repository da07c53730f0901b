"""The hand-written CUDA kernels (K0 in its stack and planes forms, K4 in its
point, patch and flow forms, the K5 loop, the NLTV loops K6 and K7, the
probes P1-P3, K8 in its whole-image and patch forms, the K8 loop and the
occlusion PD loop K9 in its patch and whole-image forms, the jump-flood
dense fill K10 and the bilateral filter K11, each in one launch) against
their plain twins, on the card (K0's two forms and K4's patch form also
with a lane index), and
the weighted, the NLTV, the CSAD and the occlusion solvers and global steps,
the lane-batched sweep, pairs mode and the growing's ordering modes and
fills (relax, exactmin, defer, polish, dense, bilateral, relax_late) on the
card against their CPU runs.

These tests need a CUDA card (the kernels have no CPU mode) and skip on a
host without one.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_card.py --noconftest -q

K0, P1, P2 and K4's patch form must equal their twins bit for bit, K4's flow
form the point form bit for bit; K4's point and flow forms and K5 their
twins within 1e-5 abs (the kernels are built with --fmad=false
and contract exactly where the twins do, so the usual difference is 0), K5
with the twin loop's iteration count; P3 within relative 1e-5 (another
summation order).  K6, K7, K8, the K8 loop, K9 and the NLTV, CSAD and
occlusion solvers, the lane-batched sweep, pairs mode, K10, K11 and the
growings under the ordering modes must equal their twins (and CPU runs) bit
for bit: they sum in the twins' order, and K8 selects one of the entries the
twin sorts."""

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


def _nltv_consts(dev, h, w, method, p=11, seed=90):
    """A frame pair on ``dev`` and its method-2/3 solver consts."""
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    i0, i1, gf, _ = syn.make_pair(h, w, seed=seed)
    a, b = prepare_pair(i0, i1, device=dev)
    lam, theta, tau = method_local_params(method, 5)
    return make_solver_consts(a, b, lam, theta, tau, 0.01, p, method,
                              i0_planes=i0), i0, gf


@pytest.mark.parametrize("p,b", [(11, 700), (3, 333), (11, 1)])
def test_k0_planes_form_c24_on_card(dev, p, b):
    """K0's planes form on the 24 zero-padded NLTV weight planes, bit for
    bit, counted under 24 planes."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_plane_patches, gather_plane_patches_plain,
    )

    h, w = 61, 83
    sc, _, _ = _nltv_consts(dev, h, w, 2)
    rng = np.random.default_rng(91 + p + b)
    idx = torch.as_tensor(rng.integers(0, h * w, b), device=dev)
    idx[:1] = h * w - 1
    _, _, oy, ox, _, _ = patch_geometry(idx, h, w, p // 2)
    planes = sc.wp_pad.unbind(0)
    hp, wp = sc.wp_pad.shape[1:]
    want = gather_plane_patches_plain([x.cpu() for x in planes], oy.cpu(),
                                      ox.cpu(), p, hp, wp)
    before = gather_plane_patches.launches_by_planes[24]
    got = gather_plane_patches(planes, oy, ox, p, hp, wp)
    assert gather_plane_patches.launches_by_planes[24] == before + 1
    assert got.shape == (24, b, p, p) and torch.equal(got.cpu(), want)


def _k6_state(dev, h, w, seed):
    """A global NLTV warp's state and constants at (h, w), on ``dev``."""
    from faldoi_tpu_torch.core.global_step_nltv import global_weights

    rng = np.random.default_rng(seed)
    i0 = rng.uniform(0, 255, (3, h, w)).astype(np.float32)
    wp, wt = global_weights(i0, dev)

    def t(*shape, s=1.0):
        return torch.as_tensor(rng.normal(0, s, shape).astype(np.float32),
                               device=dev)

    u1, u2 = t(h, w), t(h, w)
    gx, gy = t(h, w, s=0.05), t(h, w, s=0.05)
    return [u1, u2, u1 + t(h, w, s=0.1), u2 + t(h, w, s=0.1),
            t(24, h, w, s=0.3), t(24, h, w, s=0.3), wp, wt, gx, gy,
            gx * gx + gy * gy, t(h, w, s=0.1)]


@pytest.mark.parametrize("h,w,iters", [(61, 83, 1), (97, 131, 7), (5, 7, 3),
                                       (17, 300, 4)])
def test_k6_matches_twin_on_card(dev, h, w, iters):
    """K6 (two launches an iteration) against its twin on the card, bit for
    bit, state updated in place; shapes that are no multiple of its 32x8
    tiles, one smaller than a tile."""
    from faldoi_tpu_torch.core.global_step_nltv import (
        nltv_global_loop, nltv_global_loop_plain,
    )

    got = _k6_state(dev, h, w, 92 + h)
    want = [x.clone() for x in got]
    before = nltv_global_loop.launches
    nltv_global_loop(*got, 0.6, 0.3, 0.1, iters)
    assert nltv_global_loop.launches == before + 1
    nltv_global_loop_plain(*want, 0.6, 0.3, 0.1, iters)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert not torch.equal(got[0], _k6_state(dev, h, w, 92 + h)[0])


def test_k6_reads_only_the_mirrored_weights_on_card(dev):
    """K6 reads weight planes 0-11 and takes w_j, j >= 12, from plane 23 - j
    at x + d_j: fed weights that are not symmetric it disagrees with its
    twin, which reads all 24 planes, and agrees with the twin fed the
    mirrored weights.  The wrapper's precondition shows when broken."""
    from faldoi_tpu_torch.core.global_step_nltv import (
        OFFS, nltv_global_loop, nltv_global_loop_plain,
    )
    from faldoi_tpu_torch.ops.nonlocal_ops import shift_each

    st = _k6_state(dev, 61, 83, 98)
    wp = st[6].clone()
    wp[12:] = wp[12:] * 1.5                  # no longer the mirror of 0-11
    mirrored = wp.clone()
    mirrored[12:] = shift_each(wp.flip(0), OFFS)[12:]
    got, want, same = ([x.clone() for x in st] for _ in range(3))
    got[6], want[6], same[6] = wp, wp, mirrored
    nltv_global_loop(*got, 0.6, 0.3, 0.1, 3)
    nltv_global_loop_plain(*want, 0.6, 0.3, 0.1, 3)
    nltv_global_loop_plain(*same, 0.6, 0.3, 0.1, 3)
    assert not all(torch.equal(x, y) for x, y in zip(got[:6], want[:6]))
    for x, y in zip(got[:6], same[:6]):
        assert torch.equal(x, y)


def _k7_inputs(sc, dev, p, b, method, seed, case="random"):
    """K7's arguments at B canvases of side p from the solver's own
    stages: weights cropped by K0, warp constants from K4's patch form.
    ``case`` "edges" puts the first eight patches at the image's corners
    and edges (boxes clamped, ph, pw < p); "freeze" gives every lane flat
    data and a near-constant flow, so each meets tol^2 after one
    iteration."""
    from faldoi_tpu_torch.core.functionals import _weight2d, nltv_crop_weights
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    h, w = sc.i1.shape
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, h * w, b), device=dev)
    if case == "edges":
        idx[:8] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w, 3, 2 * w,
                                   3 * w - 1, (h - 1) * w + 7], device=dev)
    i, j, oy, ox, ph, pw = patch_geometry(idx, h, w, p // 2)
    box = [x.to(torch.int32).contiguous() for x in (oy, ox, ph, pw)]
    scale = torch.linspace(0, 1, b, device=dev)[:, None, None]
    u1, u2 = (torch.as_tensor(rng.normal(m, 1.0, (b, p, p)).astype(np.float32),
                              device=dev) * scale for m in (2.6, -1.4))
    u1, u2 = u1.contiguous(), u2.contiguous()
    i1w, gx, gy = bicubic_sample_patches(sc.i1_stack, *box, u1, u2, 3)
    wp, wt = nltv_crop_weights(sc.wp_pad, oy, ox, ph, pw, p)
    l_t = sc.lambda_ * sc.theta
    if method == 3:
        rows, cols = canvas_ids(p, dev)
        l_t = (l_t * _weight2d(sc.w1d, rows, cols, oy, ox, j, i, p // 2)).contiguous()
    rho_c = (i1w - gx * u1 - gy * u2).contiguous()
    if case == "freeze":
        u1, u2, rho_c = (torch.as_tensor(rng.normal(0, s, (b, p, p)).astype(np.float32),
                                         device=dev) for s in (0.02, 0.02, 0.1))
        gx, gy = torch.zeros_like(u1), torch.zeros_like(u1)
    return [u1, u2, u1, u2, None, gx, gy, gx * gx + gy * gy, rho_c, wp, wt,
            l_t, box[2], box[3], sc.theta, sc.tau, sc.tol * sc.tol]


@pytest.mark.parametrize("p,b,method,duals,case", [
    (11, 300, 2, "none", "random"), (11, 300, 3, "in", "random"),
    (3, 500, 2, "in", "random"), (3, 131, 3, "none", "random"),
    (11, 1, 2, "none", "random"), (11, 300, 2, "none", "edges"),
    (3, 131, 3, "in", "edges"), (11, 300, 2, "none", "freeze"),
    (3, 500, 3, "none", "freeze"), (7, 150, 2, "in", "random"),
    (23, 40, 3, "none", "random")])
def test_k7_matches_twin_on_card(dev, p, b, method, duals, case):
    """K7 against its twin on the card, bit for bit: outputs, iteration
    counts (lanes freeze at different counts, or all after one) and the
    duals it keeps; boxes clamped at the image edge (ph, pw < p); a side
    compiled for no size (7: two threads a cell) and one too large for two
    threads a cell (23: one)."""
    from faldoi_tpu_torch.core.functionals import (
        nltv_patch_loop, nltv_patch_loop_plain,
    )

    sc, _, _ = _nltv_consts(dev, 40, 56, method, p=max(p, 11))
    args = _k7_inputs(sc, dev, p, b, method, 93 + p + b, case)
    if case == "edges":
        assert bool((args[12] < p).any()) and bool((args[13] < p).any())
    if duals == "in":
        rng = np.random.default_rng(94)
        args[4] = torch.as_tensor(rng.normal(0, 0.05, (2, 24, b, p, p))
                                  .astype(np.float32), device=dev)
    before = nltv_patch_loop.launches
    got = nltv_patch_loop(*args, 6, keep_duals=True)
    assert nltv_patch_loop.launches == before + 1
    want = nltv_patch_loop_plain(*args, 6, keep_duals=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if case == "freeze":
        assert set(got[4].tolist()) == {1}
    elif b > 100:
        assert len(set(got[4].tolist())) > 1
    # no duals kept: the same results, and None
    again = nltv_patch_loop(*args, 6)
    assert again[5] is None
    for x, y in zip(again[:5], got[:5]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("method", [2, 3])
def test_nltv_solver_on_card_matches_cpu(dev, method):
    """solve_nltvl1 / solve_nltvl1_w on the card (K0, K4, K7) against
    their CPU run (the twins), one and two warps."""
    from faldoi_tpu_torch.core.functionals import solver_for
    from faldoi_tpu_torch.core.local_step import patch_geometry

    h, w = 40, 56
    scs = {d: _nltv_consts(d, h, w, method)[0] for d in ("cpu", dev)}
    rng = np.random.default_rng(95)
    idx = torch.as_tensor(rng.choice(h * w, 200, replace=False))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])
    for p, warps in ((11, 1), (3, 2)):
        geo = patch_geometry(idx, h, w, p // 2)
        u0 = torch.as_tensor(rng.normal(2.6, 1.0, (200, p, p)).astype(np.float32))
        v0 = torch.as_tensor(rng.normal(-1.4, 1.0, (200, p, p)).astype(np.float32))
        outs = [solver_for(method)(scs[d], *(g.to(d) for g in geo), u0.to(d),
                                   v0.to(d), p, warps, 4) for d in ("cpu", dev)]
        for x, y in zip(outs[1], outs[0]):
            assert torch.equal(x.cpu(), y)


def test_nltv_wrappers_raise_on_bad_card_tensors(dev):
    from faldoi_tpu_torch.core.functionals import nltv_patch_loop
    from faldoi_tpu_torch.core.global_step_nltv import nltv_global_loop

    st = _k6_state(dev, 9, 11, 96)
    bad = list(st)
    bad[4] = st[4][:23]
    with pytest.raises(ValueError, match="sc_p"):
        nltv_global_loop(*bad, 0.6, 0.3, 0.1, 2)
    bad = list(st)
    bad[0] = st[0].double()
    with pytest.raises(TypeError, match="u1"):
        nltv_global_loop(*bad, 0.6, 0.3, 0.1, 2)
    sc, _, _ = _nltv_consts(dev, 40, 56, 2)
    args = _k7_inputs(sc, dev, 11, 20, 2, 97)
    bad = list(args)
    bad[12] = args[12].to(torch.int64)
    with pytest.raises(TypeError, match="ph"):
        nltv_patch_loop(*bad, 4)
    bad = list(args)
    bad[9] = args[9][:, :10]
    with pytest.raises(ValueError, match="wp"):
        nltv_patch_loop(*bad, 4)


def _csad_global_inputs(dev, h, w, seed, ltg="finite"):
    """Whole-image K8 inputs on ``dev``: random planes, b from ``csad_b``,
    grad at the TV-CSAD floor, l_t a value (``ltg``: "finite", or "inf" /
    "nan" to take the kernel's sorted-B path)."""
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.csad import csad_b, image_masks

    rng = np.random.default_rng(seed)
    i0, i1w, gx, gy, u1, u2 = (torch.as_tensor(rng.normal(0, s, (h, w)).astype(
        np.float32), device=dev) for s in (0.3, 0.3, 0.05, 0.05, 2.0, 2.0))
    grad = hypot(gx * gx + gy * gy, 0.01)
    m, n = image_masks(h, w, dev)
    b = csad_b(i0, i1w, gx, gy, u1, u2, grad, m)
    l_t = {"finite": float(np.float32(0.85) * np.float32(0.3)),
           "inf": float("inf"), "nan": float("nan")}[ltg]
    return (u1, u2, b, gx.contiguous(), gy.contiguous(), grad.contiguous(), l_t,
            m, n)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.parametrize("h,w,ltg", [(436, 1024, "finite"), (5, 7, "finite"),
                                     (61, 83, "finite"), (9, 11, "inf"),
                                     (9, 11, "nan")])
def test_k8_global_matches_twin_on_card(dev, h, w, ltg):
    """K8's whole-image form against its twin on the card, bit for bit, at
    436x1024, a ragged 5x7 (every pixel near an edge) and 61x83; l_t = inf
    and NaN take the kernel's path that sorts the second list."""
    from faldoi_tpu_torch.ops.csad import csad_vstep, csad_vstep_plain

    args = _csad_global_inputs(dev, h, w, 160 + h, ltg)
    before = csad_vstep.launches
    v1, v2 = csad_vstep(*args)
    assert csad_vstep.launches == before + 1
    w1, w2 = csad_vstep_plain(*args)
    assert _same_bits(v1, w1) and _same_bits(v2, w2)
    if ltg == "finite":
        assert torch.isfinite(v1).all() and bool((v1 != args[0]).any())
        assert args[8][0, 0] == 15             # a corner pixel


def _csad_patch_inputs(dev, p, b, seed, weighted):
    """Patch-form K8 inputs on ``dev``: boxes clamped at the edges of a
    40x56 image (out-of-box cells, where no neighbour counts), canvases of a
    constant flow plus noise, b from ``csad_b``; l_t one value, or one a
    cell (the weighted methods' window); i1wx 0 on some out-of-box cells."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.pd_common import hypot
    from faldoi_tpu_torch.ops.csad import canvas_masks, csad_b

    h, w = 40, 56
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, h * w, b))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])[:b]
    _, _, _, _, ph, pw = patch_geometry(idx, h, w, p // 2)
    ph, pw = ph.to(torch.int32).to(dev), pw.to(torch.int32).to(dev)
    i0, i1w, gx, gy, u1, u2 = (torch.as_tensor(rng.normal(mu, s, (b, p, p)).astype(
        np.float32), device=dev) for mu, s in ((0, .3), (0, .3), (0, .05),
                                               (0, .05), (2.6, .3), (-1.4, .3)))
    gx[:, -1, :] = 0.0
    grad = hypot(gx * gx + gy * gy, 0.01)
    m, n = canvas_masks(ph, pw, p)
    bb = csad_b(i0, i1w, gx, gy, u1, u2, grad, m)
    l_t = torch.tensor(np.float32(0.85) * np.float32(0.3), device=dev)
    if weighted:
        l_t = (l_t * torch.as_tensor(rng.uniform(0.1, 1, (b, p, p)).astype(
            np.float32), device=dev)).contiguous()
    return (u1, u2, bb, gx.contiguous(), gy.contiguous(), grad.contiguous(), l_t,
            m, n, ph, pw)


@pytest.mark.parametrize("p,b,weighted", [(11, 8192, False), (11, 1, False),
                                          (11, 1900, True), (3, 333, False)])
def test_k8_patch_matches_twin_on_card(dev, p, b, weighted):
    """K8's patch form against its twin on the card, bit for bit, NaN and
    +-inf of the out-of-box cells included."""
    from faldoi_tpu_torch.ops.csad import csad_vstep, csad_vstep_plain

    args = _csad_patch_inputs(dev, p, b, 170 + b, weighted)
    before = csad_vstep.launches
    v1, v2 = csad_vstep(*args)
    assert csad_vstep.launches == before + 1
    w1, w2 = csad_vstep_plain(*args[:9])
    assert _same_bits(v1, w1) and _same_bits(v2, w2)
    if b > 1:
        out = args[8] == 0
        assert bool(out.any()) and bool(v1[out].isnan().any())


# adversarial K8 cells: case -> (values the b planes take, l_t values)
K8_CASES = {
    "ties-with-b": ([-1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 0.75, 1.0], [0.25, 0.5]),
    "signed-zeros": ([0.0, -0.0, 0.25, -0.25], [0.0, -0.0, 0.25, -0.25]),
    "infinities": ([np.inf, -np.inf, 0.0, 1.5, -2.0], [0.3, -0.3]),
    "nans": ([np.nan, 0.5, -0.5, np.inf, -0.0], [0.3, 0.0]),
    "b-overflow": ([1e38, -1e38, 0.0, 3e38, -np.inf], [1e37, -1e37, 3e38]),
    "lt-inf": ([0.0, 1.0, -1.0, np.inf, np.nan], [np.inf, -np.inf]),
    "lt-nan": ([0.0, 1.0, -1.0, np.inf, np.nan], [np.nan]),
}


def _k8_adversarial(dev, shape, case, seed):
    """K8 inputs of ``shape`` whose entries tie: u 0, i1wx 1, i1wy -1 and
    denom 1, so A_j = -b_j exactly; b and a per-cell l_t drawn from the
    case's values."""
    pool, lts = K8_CASES[case]
    rng = np.random.default_rng(seed)
    b = np.asarray(pool, dtype=np.float32)[rng.integers(0, len(pool), (48,) + shape)]
    lt = np.asarray(lts, dtype=np.float32)[rng.integers(0, len(lts), shape)]
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)   # noqa: E731
    one = np.ones(shape, np.float32)
    return f(0 * one), f(0 * one), f(b), f(one), f(-one), f(one), f(lt)


@pytest.mark.parametrize("case", list(K8_CASES))
def test_k8_adversarial_cells_on_card(dev, case):
    """Both forms on cells whose 97 entries tie within A and with B, hold
    +-0, +-inf and NaN, with l_t negative, +-0, huge, inf or NaN, at every
    n a clipped window has, 0 (out of the box) to 48 (boxes of every size
    from 1x1): bit for bit with the twin, the sign of a selected zero
    included."""
    from faldoi_tpu_torch.ops.csad import (
        canvas_masks, csad_vstep, csad_vstep_plain, image_masks,
    )

    seen = set()
    shapes = [(h, w) for h in (3, 4, 8) for w in (3, 5, 9)] + [(13, 17)]
    for k, (h, w) in enumerate(shapes):
        u1, u2, b, gx, gy, den, lt = _k8_adversarial(dev, (h, w), case, 190 + k)
        m, n = image_masks(h, w, dev)
        b = torch.where(m, b, torch.zeros((), device=dev)).contiguous()
        got = csad_vstep(u1, u2, b, gx, gy, den, lt, m, n)
        want = csad_vstep_plain(u1, u2, b, gx, gy, den, lt, m, n)
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1]), (h, w)
        seen.update(n.flatten().tolist())
    for p, nb in ((11, 300), (3, 200)):
        rng = np.random.default_rng(198 + p)
        ph, pw = (torch.as_tensor(rng.integers(1, p + 1, nb).astype(np.int32),
                                  device=dev) for _ in range(2))
        u1, u2, b, gx, gy, den, lt = _k8_adversarial(dev, (nb, p, p), case, 199 + p)
        m, n = canvas_masks(ph, pw, p)
        b = torch.where(m, b, torch.zeros((), device=dev)).contiguous()
        got = csad_vstep(u1, u2, b, gx, gy, den, lt, m, n, ph, pw)
        want = csad_vstep_plain(u1, u2, b, gx, gy, den, lt, m, n)
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1]), p
        seen.update(n.flatten().tolist())
    # every n a window clipped to a box can have: rows x columns - 1
    assert seen == {float(r * c - 1) for r in range(1, 8) for c in range(1, 8)}


def _k8_loop_args(dev, p, b, seed, weighted, lt=None):
    """The K8 loop's arguments for one warp: K8's patch inputs (boxes
    clipped at the image edge), v = u, theta 0.3, tau 0.1, tol 0.01."""
    u1, u2, bb, gx, gy, grad, l_t, m, n, ph, pw = _csad_patch_inputs(
        dev, p, b, seed, weighted)
    if lt is not None:
        l_t = torch.tensor(lt, dtype=torch.float32, device=dev)
    f = lambda x: torch.tensor(np.float32(x), device=dev)   # noqa: E731
    return [u1, u2, u1, u2, bb, gx, gy, grad, l_t, m, n, ph, pw, f(0.3), f(0.1),
            f(0.01) * f(0.01)]


@pytest.mark.parametrize("p,b,weighted,tol2,lt", [
    (11, 8192, False, None, None), (11, 297, False, None, None),
    (11, 1, False, None, None), (3, 333, False, None, None),
    (11, 1900, True, None, None), (11, 297, False, 1e10, None),
    (11, 64, False, None, float("inf")), (7, 50, True, None, None),
    (23, 20, False, None, None)],
    ids=["p11-b8192", "p11-b297", "p11-b1", "p3-b333", "m5-b1900",
         "large-tol", "lt-inf", "p7", "p23"])
def test_k8_loop_matches_twin_on_card(dev, p, b, weighted, tol2, lt):
    """The K8 loop (one launch a warp) against its twin on the card, bit for
    bit: canvases (NaN and +-inf of the out-of-box cells included) and
    iteration counts; a tol^2 of 1e10 stops every canvas after one step."""
    from faldoi_tpu_torch.ops.csad import csad_patch_loop, csad_patch_loop_plain

    args = _k8_loop_args(dev, p, b, 210 + p + b, weighted, lt)
    if tol2 is not None:
        args[15] = torch.tensor(tol2, dtype=torch.float32, device=dev)
    before = csad_patch_loop.launches
    got = csad_patch_loop(*args, 4)
    assert csad_patch_loop.launches == before + 1
    want = csad_patch_loop_plain(*args, 4)
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert bool(((got[4] >= 1) & (got[4] <= 4)).all())
    if tol2 is not None:
        assert bool((got[4] == 1).all())


def test_k8_loop_wrapper_raises_on_bad_card_tensors(dev):
    from faldoi_tpu_torch.ops.csad import csad_patch_loop

    args = _k8_loop_args(dev, 11, 20, 230, False)
    bad = list(args)
    bad[4] = args[4][:47]
    with pytest.raises(ValueError, match="b"):
        csad_patch_loop(*bad, 4)
    bad = list(args)
    bad[11] = args[11].to(torch.int64)
    with pytest.raises(TypeError, match="ph"):
        csad_patch_loop(*bad, 4)
    bad = list(args)
    bad[8] = args[8].expand(20, 11, 11)
    with pytest.raises(ValueError, match="l_t"):
        csad_patch_loop(*bad, 4)


def test_k8_wrapper_raises_on_bad_card_tensors(dev):
    from faldoi_tpu_torch.ops.csad import csad_vstep

    args = list(_csad_global_inputs(dev, 9, 11, 180))
    bad = list(args)
    bad[2] = args[2][:47]
    with pytest.raises(ValueError, match="b"):
        csad_vstep(*bad)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(TypeError, match="denom"):
        csad_vstep(*bad)
    small = _csad_global_inputs(dev, 2, 9, 182)   # image_masks wraps below 3
    with pytest.raises(ValueError, match="3 x 3"):
        csad_vstep(*small)
    pargs = list(_csad_patch_inputs(dev, 11, 20, 181, False))
    bad = list(pargs)
    bad[9] = pargs[9].to(torch.int64)
    with pytest.raises(TypeError, match="ph"):
        csad_vstep(*bad)


@pytest.mark.parametrize("method", [4, 5, 6, 7])
def test_csad_solver_on_card_matches_cpu(dev, method):
    """The CSAD patch solvers on the card (K0, K4, K8) against their CPU run
    (the twins), bit for bit, at P 11 and 3."""
    from faldoi_tpu_torch.core.functionals import solver_for
    from faldoi_tpu_torch.core.local_step import patch_geometry

    h, w = 40, 56
    scs = {d: _nltv_consts(d, h, w, method)[0] for d in ("cpu", dev)}
    rng = np.random.default_rng(185)
    idx = torch.as_tensor(rng.choice(h * w, 200, replace=False))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])
    for p in (11, 3):
        geo = patch_geometry(idx, h, w, p // 2)
        u0 = torch.as_tensor(rng.normal(2.6, 0.3, (200, p, p)).astype(np.float32))
        v0 = torch.as_tensor(rng.normal(-1.4, 0.3, (200, p, p)).astype(np.float32))
        outs = [solver_for(method)(scs[d], *(g.to(d) for g in geo), u0.to(d),
                                   v0.to(d), p, 1, 4) for d in ("cpu", dev)]
        for x, y in zip(outs[1], outs[0]):
            assert torch.equal(x.cpu(), y)


def test_csad_sweep_on_card_matches_cpu(dev):
    """``sweep_body`` with fill "patch" (the exact raster fill, m4's) on the
    card against the CPU, bit for bit: the seeds inserted and three sweeps
    on each device from the same seeds.  The dump slot, which takes the
    masked writes in no fixed order, is left out."""
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, state_to_numpy, sweep_body,
    )
    from faldoi_tpu_torch.ops.csad import csad_patch_loop

    h, w = 40, 56
    rng = np.random.default_rng(186)
    sc, _, gf = _nltv_consts("cpu", h, w, 4)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(h, w, 30, rng), rng)
    states = []
    for d in ("cpu", dev):
        sc = _nltv_consts(d, h, w, 4)[0]
        sal = torch.ones(h * w + 1, device=d)
        st = insert_seeds(init_state(h, w, d), seeds, sc, sal, 1, 4, method=4)
        tr = torch.ones((h, w), device=d)
        before = csad_patch_loop.launches
        for _ in range(3):
            st, k = sweep_body(st, sc, tr, sal, 0, h, w, 5, 256, 1, 4, 64, 4,
                               fill="patch")
            assert k > 0
        assert (csad_patch_loop.launches > before) == (d != "cpu")
        states.append(state_to_numpy(st))
    for k in states[0]:                          # the dump slot left out
        assert np.array_equal(states[0][k][:h * w], states[1][k][:h * w],
                              equal_nan=True), k


@pytest.mark.parametrize("method", [4, 6])
def test_csad_global_on_card_matches_cpu(dev, method):
    """tvcsad_global / nltvcsad_global on the card (K4, K8) against their
    CPU run, bit for bit, with the same PD iterations per warp (2 warps of
    at most 40 iterations at 40x56)."""
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global, tvcsad_global,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    h, w = 40, 56
    i0, i1, gf, _ = syn.make_pair(h, w, seed=187)
    flow = (gf + np.random.default_rng(188).normal(0, 0.3, gf.shape)
            ).astype(np.float32)
    outs = []
    for d in ("cpu", dev):
        a, b = prepare_pair(i0, i1, device=d)
        f1 = torch.as_tensor(flow[..., 0], device=d)
        f2 = torch.as_tensor(flow[..., 1], device=d)
        st = {}
        if method == 4:
            u1, u2 = tvcsad_global(a, b, f1, f2, 0.85, 0.3, 0.125, 0.1, 2,
                                   max_iters=40, stats=st)
        else:
            u1, u2 = nltvcsad_global(a, b, i0, f1, f2, 0.85, 0.3, 0.1, 2,
                                     max_iters=40, stats=st)
        outs.append((u1.cpu(), u2.cpu(), st["global_iters"]))
    assert outs[0][2] == outs[1][2]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a.cpu()), _bits(b.cpu()))


@pytest.mark.parametrize("p,b,chi,tol2", [
    (11, 8192, "random", None), (11, 1900, "random", None),
    (11, 297, "zeros", None), (11, 297, "ones", None), (11, 1, "random", None),
    (3, 1703, "random", None), (11, 297, "random", 1e10), (7, 61, "ones", None),
], ids=["P11-B8192", "P11-B1900", "P11-B297-chi0", "P11-B297-chi1", "P11-B1",
        "P3-B1703", "P11-one-iteration", "P7-B61"])
def test_k9_patch_matches_twin_on_card(dev, p, b, chi, tol2):
    """K9's patch form against its twin (the plain loop, run on the card)
    bit for bit, every state plane and the iterations: boxes clipped at the
    image edge (the warps at -u there too), chi given all 0 and all 1, and
    a tol^2 that stops every canvas after one PD iteration."""
    from faldoi_tpu_torch.core.occlusion import (
        SCALARS, occ_patch_loop, occ_patch_loop_plain,
    )

    st, wc, g, ph, pw, scal = syn.occ_patch_inputs(b, p, 190 + p + b, dev, chi)
    if tol2 is not None:
        scal[SCALARS.index("tol2")] = tol2
    assert (ph < p).any() or b == 1
    want, wn = occ_patch_loop_plain(st, wc, g, ph, pw, scal, 3)
    before = occ_patch_loop.launches
    got, gn = occ_patch_loop(st, wc, g, ph, pw, scal, 3)
    torch.cuda.synchronize()
    assert occ_patch_loop.launches == before + 1
    assert _same_bits(got, want) and torch.equal(gn.cpu(), wn.cpu())
    if tol2 is not None:
        assert (gn == 1).all()
    assert got[2].unique().tolist() in ([0.0], [1.0], [0.0, 1.0])


@pytest.mark.parametrize("h,w,occ_init,max_iters", [
    (436, 1024, False, 3), (436, 1024, True, 3), (5, 7, True, 3),
    (40, 56, False, 3), (1088, 1920, True, 2), (40, 56, True, 400)],
    ids=["436x1024-chi0", "436x1024-occ_init", "5x7", "40x56",
         "1088x1920-streamed", "40x56-cap400"])
def test_k9_global_matches_twin_on_card(dev, h, w, occ_init, max_iters):
    """K9's whole-image form (one warp's loop in one cooperative launch)
    against its twin bit for bit, state and PD iterations, chi given or 0:
    at 1088x1920 the tiles outnumber the co-resident blocks and go to device
    memory between phases; at 40x56 the loop runs to the CLI's cap of 400
    unless the tol stops it.  One call is one kernel node of a captured
    graph, and raises ``launches`` by one."""
    from faldoi_tpu_torch.core.occlusion import (
        global_plan, occ_global_loop, occ_global_loop_kernels,
        occ_global_loop_plain,
    )

    st, wc, g, scal = syn.occ_global_inputs(h, w, 200 + h, dev, occ_init)
    want, wn = occ_global_loop_plain(st, wc, g, scal, max_iters)
    before = occ_global_loop.launches
    got, gn = occ_global_loop(st, wc, g, scal, max_iters)
    torch.cuda.synchronize()
    assert occ_global_loop.launches == before + 1
    assert _same_bits(got, want), "state"
    assert int(gn) == int(wn) and 0 < int(gn) <= max_iters
    assert got[2].unique().tolist() in ([0.0], [1.0], [0.0, 1.0])
    assert bool(global_plan(h, w)["resident"]) == (h * w < 10 ** 6)
    before = occ_global_loop.launches
    assert occ_global_loop_kernels(st, wc, g, scal, max_iters) == 1
    assert occ_global_loop.launches == before


def test_k9_wrappers_raise_on_bad_card_tensors(dev):
    from faldoi_tpu_torch.core.occlusion import occ_global_loop, occ_patch_loop

    st, wc, g, ph, pw, scal = syn.occ_patch_inputs(5, 11, 209, dev)
    with pytest.raises(TypeError):
        occ_patch_loop(st.double(), wc, g, ph, pw, scal, 3)
    with pytest.raises(ValueError):
        occ_patch_loop(st, wc[:7], g, ph, pw, scal, 3)
    with pytest.raises(TypeError):
        occ_patch_loop(st, wc, g, ph.long(), pw, scal, 3)
    with pytest.raises(ValueError):
        occ_patch_loop(st, wc, g.cpu(), ph, pw, scal, 3)
    with pytest.raises(ValueError, match="P\\*P <= 1024"):
        z = torch.zeros((11, 1, 33, 33), device=dev)
        occ_patch_loop(z, z[:8], z[0], ph[:1], pw[:1], scal, 3)
    gst, gwc, gg, gscal = syn.occ_global_inputs(9, 11, 210, dev, True)
    with pytest.raises(ValueError):
        occ_global_loop(gst.transpose(1, 2), gwc, gg, gscal, 3)
    with pytest.raises(ValueError):
        occ_global_loop(gst, gwc, gg, gscal[:13], 3)
    with pytest.raises(TypeError):
        occ_global_loop(gst.double(), gwc, gg, gscal, 3)


def _occ_consts(d, h, w, seed):
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.functionals import make_solver_consts
    from faldoi_tpu_torch.core.preprocess import prepare_quad
    from faldoi_tpu_torch.models import method_local_params

    *frames, gf, _, _ = syn.make_quad(h, w, seed)
    i0n, i1n, i_1n, _ = prepare_quad(*frames, device=d)
    prm = P.Parameters()
    sc = make_solver_consts(i0n, i1n, *method_local_params(8, 5), prm.tol_OF,
                            11, 8, i_1=i_1n,
                            occ_prm=(prm.alpha, prm.beta, prm.mu, prm.tau_u,
                                     prm.tau_eta, prm.tau_chi))
    return sc, gf


def test_occ_solver_and_sweep_on_card_match_cpu(dev):
    """The m8 patch solver (K0, K4's patch form at u and -u, K9) and an m8
    sweep on the card against their CPU runs, bit for bit; the seeds
    inserted and three sweeps on each device (the dump slot left out)."""
    from faldoi_tpu_torch.core.functionals import solve_tvl1_occ
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, patch_geometry, state_to_numpy, sweep_body,
    )
    from faldoi_tpu_torch.core.occlusion import occ_patch_loop

    h, w = 40, 56
    rng = np.random.default_rng(211)
    idx = torch.as_tensor(rng.choice(h * w, 300, replace=False))
    _, gf = _occ_consts("cpu", h, w, 212)
    seeds = syn.make_seeds(gf, syn.random_seed_positions(h, w, 30, rng), rng)
    outs, states = [], []
    for d in ("cpu", dev):
        sc, _ = _occ_consts(d, h, w, 212)
        i, j, oy, ox, ph, pw = (t.to(d) for t in patch_geometry(idx, h, w, 5))
        u0 = torch.full((300, 11, 11), 2.0, device=d)
        c0 = torch.zeros_like(u0)
        c0[::3] = 1.0
        outs.append([t.cpu() for t in solve_tvl1_occ(
            sc, i, j, oy, ox, ph, pw, u0, -u0, 11, 1, 3, chi=c0)])
        sal = torch.ones(h * w + 1, device=d)
        st = insert_seeds(init_state(h, w, d), seeds, sc, sal, 1, 3, method=8)
        tr = torch.ones((h, w), device=d)
        before = occ_patch_loop.launches
        for _ in range(3):
            st, k = sweep_body(st, sc, tr, sal, 0, h, w, 5, 256, 1, 3, 64, 8)
            assert k > 0
        assert (occ_patch_loop.launches > before) == (d != "cpu")
        states.append(state_to_numpy(st))
    for a, b in zip(*outs):
        assert _same_bits(a, b)
    for k in states[0]:
        assert np.array_equal(states[0][k][:h * w], states[1][k][:h * w],
                              equal_nan=True), k


@pytest.mark.parametrize("occ_init", [False, True])
def test_occ_global_on_card_matches_cpu(dev, occ_init):
    """tvl2_occ_global on the card (K4's flow form, K9's whole-image form,
    one launch a warp) against its CPU run, bit for bit, with the same PD
    iterations per warp (2 warps of at most 12 iterations at 40x56)."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.occlusion import tvl2_occ_global
    from faldoi_tpu_torch.core.preprocess import prepare_triple

    h, w = 40, 56
    i0, i1, i_1, _, gf, _, occ = syn.make_quad(h, w, seed=213)
    flow = (gf + np.random.default_rng(214).normal(0, 0.3, gf.shape)
            ).astype(np.float32)
    prm = P.init_params(None, P.GLOBAL_STEP)
    prm.warps, prm.iterations_of = 2, 12
    outs = []
    for d in ("cpu", dev):
        a, b, c = prepare_triple(i0, i1, i_1, device=d)
        st = {}
        u1, u2, chi = tvl2_occ_global(
            a, b, c, torch.as_tensor(flow[..., 0], device=d),
            torch.as_tensor(flow[..., 1], device=d),
            occ if occ_init else None, prm, stats=st)
        outs.append((u1.cpu(), u2.cpu(), chi.cpu(), st["global_iters"]))
    assert outs[0][3] == outs[1][3]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert _same_bits(a, b)


def _np_same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


def _lane_windows(rng, lanes, b, hp, wp, p):
    """(lane, oy, ox) of b windows: each lane's four corner boxes (negative
    starts and starts past the edge included) first, then random ones."""
    ln, oy, ox = [], [], []
    for lane in range(lanes):
        for y, x in ((0, 0), (hp - 1, wp - 1), (-1, 0), (hp - p + 2, -3)):
            ln.append(lane)
            oy.append(y)
            ox.append(x)
    ln, oy, ox = ln[:b], oy[:b], ox[:b]
    k = b - len(ln)
    ln += rng.integers(0, lanes, k).tolist()
    oy += rng.integers(-p, hp + 1, k).tolist()
    ox += rng.integers(-p, wp + 1, k).tolist()
    return (torch.tensor(ln, dtype=torch.int64), torch.tensor(oy),
            torch.tensor(ox))


LANE_CASES = [(2, 1), (2, 37), (8, 1), (8, 8191), (8, 8192)]


@pytest.mark.parametrize("lanes,b", LANE_CASES)
def test_k0_stack_lane_form_matches_twin_on_card(dev, lanes, b):
    from faldoi_tpu_torch.ops.patch_gather import gather_patches, gather_patches_plain

    rng = np.random.default_rng(120 + lanes)
    stack = torch.as_tensor(rng.standard_normal((lanes, 47, 62, 1)),
                            dtype=torch.float32)
    ln, oy, ox = _lane_windows(rng, lanes, b, 47, 62, 11)
    oy, ox, ln = (t.to(torch.int32) for t in (oy, ox, ln))
    want = gather_patches_plain(stack, oy, ox, 11, ln)
    before = gather_patches.launches
    got = gather_patches(stack.to(dev), oy.to(dev), ox.to(dev), 11, lane=ln.to(dev))
    assert gather_patches.launches == before + 1
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("lanes,b", LANE_CASES)
def test_k0_planes_lane_form_matches_twin_on_card(dev, lanes, b):
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_plane_patches, gather_plane_patches_plain,
    )

    rng = np.random.default_rng(130 + lanes)
    h, w, p = 37, 53, 11
    n = h * w
    state = [torch.as_tensor(rng.standard_normal((lanes, n + 1)),
                             dtype=torch.float32) for _ in range(4)]
    state[0][:, rng.integers(0, n, 50)] = float("nan")
    trust = torch.as_tensor(rng.integers(0, 2, (lanes, h, w)), dtype=torch.int32)
    wp_pad = torch.as_tensor(rng.standard_normal((lanes, 24, h + p, w + p)),
                             dtype=torch.float32)
    ln, oy, ox = _lane_windows(rng, lanes, b, h, w, p)
    for planes, hh, ww in ((tuple(state) + (trust,), h, w),
                           (wp_pad.unbind(1), h + p, w + p)):
        want = gather_plane_patches_plain(planes, oy, ox, p, hh, ww, ln)
        before = gather_plane_patches.launches
        got = gather_plane_patches(tuple(pl.to(dev) for pl in planes), oy.to(dev),
                                   ox.to(dev), p, hh, ww, lane=ln.to(dev))
        assert gather_plane_patches.launches == before + 1
        assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("lanes,b", LANE_CASES)
def test_k4_patch_lane_form_matches_twin_on_card(dev, lanes, b):
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample_patches, bicubic_sample_patches_plain,
    )

    rng = np.random.default_rng(140 + lanes)
    h, w, p = 41, 57, 11
    stack = torch.as_tensor(rng.standard_normal((lanes, 3, h, w)),
                            dtype=torch.float32)
    ln, oy, ox = _lane_windows(rng, lanes, b, h - p, w - p, p)
    oy, ox = oy.clamp(0, h - 1), ox.clamp(0, w - 1)
    ph, pw = torch.clamp(h - oy, max=p), torch.clamp(w - ox, max=p)
    u1 = torch.as_tensor(rng.uniform(-14, 14, (b, p, p)), dtype=torch.float32)
    u2 = torch.as_tensor(rng.uniform(-14, 14, (b, p, p)), dtype=torch.float32)
    args = [t.to(torch.int32) for t in (oy, ox, ph, pw, ln)]
    want = bicubic_sample_patches_plain(stack, *args[:4], u1, u2, 3, args[4])
    before = bicubic_sample_patches.launches
    got = bicubic_sample_patches(stack.to(dev), *(a.to(dev) for a in args[:4]),
                                 u1.to(dev), u2.to(dev), 3, lane=args[4].to(dev))
    assert bicubic_sample_patches.launches == before + 1
    assert torch.equal(_bits(got.cpu()), _bits(want))


def _four_lanes(d, h, w):
    """Four m0 lanes on two synthetic pairs (fwd and bwd of each), seeded."""
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, stack_states,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    scs, sts = [], []
    for k in range(2):
        i0, i1, gf, gb = syn.make_pair(h, w, seed=150 + k)
        a, b = prepare_pair(i0, i1, device=d)
        rng = np.random.default_rng(150 + k)
        for src, dst, g, cnt in ((a, b, gf, 30 + 20 * k), (b, a, gb, 45 - 10 * k)):
            sc = make_solver_consts(src, dst, 0.25, 0.3, 0.125, 0.01, 11, 0)
            seeds = syn.make_seeds(g, syn.random_seed_positions(h, w, cnt, rng), rng)
            scs.append(sc)
            sts.append(insert_seeds(init_state(h, w, d), seeds, sc,
                                    torch.ones(h * w + 1, device=d), 1, 4))
    return stack_solver_consts(scs), stack_states(sts)


def test_sweep_lanes_on_card_matches_cpu(dev):
    """``sweep_lanes`` at L = 4 (two pairs' fwd and bwd lanes), four sweeps
    in iteration 0 and two in iteration 1 under a trust map, on the card
    against the CPU, bit for bit (the dump slots left out)."""
    from faldoi_tpu_torch.core.local_step import state_to_numpy, sweep_lanes
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches

    h, w = 48, 64
    trust = torch.ones((4, h, w), dtype=torch.int32)
    trust[0, 10:20, 5:30] = 0
    trust[3, 30:40, 40:60] = 0
    out = []
    for d in ("cpu", dev):
        sc, st = _four_lanes(d, h, w)
        sal = torch.ones((4, h * w + 1), device=d)
        counts = []
        before = (gather_plane_patches.launches, bicubic_sample_patches.launches)
        for it, tr in [(0, torch.ones((4, h, w), device=d))] * 4 + [
                (1, trust.to(d))] * 2:
            st, c = sweep_lanes(st, sc, tr, sal, it, h, w, 5, 256, 1, 4, 16)
            counts.append(c)
        if d != "cpu":
            # one state crop a sweep for all four lanes; K4's patch form
            # twice a solve (the warp and the eval)
            assert gather_plane_patches.launches == before[0] + 6
            assert bicubic_sample_patches.launches == before[1] + 12
        out.append((counts, {k: v.reshape(4, -1)[:, :h * w]
                             for k, v in state_to_numpy(st).items()}))
    assert out[0][0] == out[1][0] and min(min(c) for c in out[0][0]) > 0
    for k in out[0][1]:
        assert _np_same_bits(out[0][1][k], out[1][1][k]), k


def test_pairs_growing_on_card_matches_cpu(dev):
    """``match_growing_pairs`` at N = 2 (m0, 48x64, bsz 256) on the card
    against the CPU, bit for bit, and the same sweeps."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing_pairs
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    h, w = 48, 64
    prm = P.Parameters()
    res = []
    for d in ("cpu", dev):
        seeds, frames = [], []
        for k in range(2):
            i0, i1, gf, gb = syn.make_pair(h, w, seed=160 + k)
            rng = np.random.default_rng(160 + k)
            seeds.append(tuple(
                syn.make_seeds(g, syn.random_seed_positions(h, w, c, rng), rng)
                for g, c in ((gf, 40 + 15 * k), (gb, 50))))
            frames.append(prepare_pair(i0, i1, device=d))
        st = {}
        outs = match_growing_pairs(seeds, frames, prm, bsz=256, stats=st)
        res.append(([[t.cpu().numpy() for t in o] for o in outs], st["sweeps"]))
    assert res[0][1] == res[1][1]
    for a, b in zip(res[0][0], res[1][0]):
        assert np.isfinite(a[0]).all()
        for x, y in zip(a, b):
            assert _np_same_bits(x, y)


def _one_pass_flood(x):
    """A one-pass jump flood (each stride's 8 neighbours read from the state
    before the stride), then K10's take and relaxation: the function K10
    must NOT compute.  x: (L, C, h, w) on the CPU."""
    from faldoi_tpu_torch.ops.poisson import _rect_relax, flood_strides

    nl, c, h, w = x.shape
    fin = torch.isfinite(x[:, 0])
    seed = torch.where(fin, torch.arange(h * w).view(h, w), -1)
    best = torch.where(fin, 0.0, float("inf"))
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    far = torch.tensor(-1e6)
    for k in flood_strides(h, w):
        before = seed
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                nb = (before.index_select(1, (torch.arange(h) - dy).clamp(0, h - 1))
                      .index_select(2, (torch.arange(w) - dx).clamp(0, w - 1)))
                ey = yy - torch.where(nb >= 0, (nb // w).float(), far)
                ex = xx - torch.where(nb >= 0, (nb % w).float(), far)
                d2 = ey * ey + ex * ex
                better = d2 < best
                best = torch.where(better, d2, best)
                seed = torch.where(better, nb, seed)
    take = x.reshape(nl, c, h * w).gather(
        2, seed.clamp(min=0).view(nl, 1, -1).expand(nl, c, -1))
    take = torch.where(seed.view(nl, 1, -1) >= 0, take, 0.0).view(nl, c, h, w)
    return _rect_relax(torch.where(fin[:, None], x, take), ~fin[:, None], 0.4, 6)


def _golden_seed_field(h, w, lanes):
    """(L, 2, h, w) planes finite at the golden DeepMatching seed positions
    (clipped to h x w), NaN elsewhere."""
    import os

    from faldoi_tpu_torch.io.flo import read_flo

    gold = os.path.join(os.path.dirname(__file__), "golden")
    x = np.full((lanes, 2, h, w), np.nan, np.float32)
    for lane, name in zip(range(lanes), ("deep_mt_1.flo", "deep_mt_2.flo")):
        f = read_flo(os.path.join(gold, name))[:h, :w]
        fin = np.isfinite(f).all(-1)
        x[lane][:, fin] = np.moveaxis(f[fin], -1, 0)
    return x


@pytest.mark.parametrize("h,w", [(436, 1024), (97, 131), (5, 7)])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("kind", ["golden", "sparse", "one", "none"])
def test_k10_matches_twin_on_card(dev, h, w, lanes, kind):
    """K10 against its twin (on the CPU and on the card), bit for bit: the
    golden seed positions, 2% random cells, one finite cell, none."""
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image, nearest_fill_image_plain

    rng = np.random.default_rng(h + lanes)
    if kind == "golden":
        x = _golden_seed_field(h, w, lanes)
    else:
        x = rng.normal(size=(lanes, 2, h, w)).astype(np.float32) * 3
        keep = {"sparse": rng.random((lanes, 1, h, w)) < 0.02,
                "one": np.zeros((lanes, 1, h, w), bool),
                "none": np.zeros((lanes, 1, h, w), bool)}[kind]
        if kind == "one":
            keep[:, 0, h // 3, w - 2] = True
        x[~np.broadcast_to(keep, x.shape)] = np.nan
    xc = torch.as_tensor(x)
    before = nearest_fill_image.launches
    got = nearest_fill_image(xc.to(dev))
    assert nearest_fill_image.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got.cpu()), _bits(nearest_fill_image_plain(xc)))
    assert torch.equal(_bits(got), _bits(nearest_fill_image_plain(xc.to(dev))))


@pytest.mark.parametrize("shape,seed", [((5, 7), 3), ((13, 17), 0)])
def test_k10_keeps_the_direction_order_on_card(dev, shape, seed):
    """Inputs where a one-pass flood picks other nearest cells: K10 equals
    its twin and not the one-pass flood."""
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image, nearest_fill_image_plain

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 1) + shape).astype(np.float32)
    x[rng.random(x.shape) >= 0.15] = np.nan
    got = nearest_fill_image(torch.as_tensor(x, device=dev)).cpu()
    assert torch.equal(_bits(got), _bits(nearest_fill_image_plain(torch.as_tensor(x))))
    assert not torch.equal(got, _one_pass_flood(torch.as_tensor(x)))


def test_k10_refuses_unequal_finite_sets_on_card(dev):
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    x = torch.full((1, 2, 9, 9), float("nan"), device=dev)
    x[0, 0, 3, 3] = 1.0
    with pytest.raises(ValueError, match="same"):
        nearest_fill_image(x)
    with pytest.raises(ValueError, match="contiguous"):
        nearest_fill_image(torch.zeros((1, 9, 9, 2), device=dev).permute(0, 3, 1, 2))


@pytest.mark.parametrize("h,w", [(436, 1024), (97, 131), (5, 7)])
@pytest.mark.parametrize("lanes", [1, 2])
def test_k11_matches_twin_on_card(dev, h, w, lanes):
    """K11 against its twin on the same weight planes (on the CPU and on
    the card), bit for bit; trust from the golden positions' neighbourhoods
    and random cells, some cells fixed."""
    from faldoi_tpu_torch.core.bilateral import (
        bilateral_colour_planes, bilateral_filter_flow,
        bilateral_filter_flow_plain, bilateral_weights,
    )

    rng = np.random.default_rng(3 * h + lanes)
    i0 = torch.as_tensor(rng.random((h, w)).astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(2, lanes, h, w)).astype(np.float32) * 4)
    trust = np.isfinite(_golden_seed_field(h, w, 2)[:lanes, 0])
    trust |= rng.random((lanes, h, w)) < 0.5
    tr = torch.as_tensor(trust.astype(np.int32))
    fx = torch.as_tensor((rng.random((lanes, h, w)) < 0.05).astype(np.int32))
    wts = bilateral_weights(i0)
    want = bilateral_filter_flow_plain(wts, u[0], u[1], tr, fx)
    before = bilateral_filter_flow.launches
    got = bilateral_filter_flow(i0.to(dev), u[0].to(dev), u[1].to(dev),
                                tr.to(dev), fx.to(dev),
                                colour=bilateral_colour_planes(i0).to(dev))
    assert bilateral_filter_flow.launches == before + 1
    twin = bilateral_filter_flow_plain(wts.to(dev), u[0].to(dev), u[1].to(dev),
                                       tr.to(dev), fx.to(dev))
    for g, wc, wg in zip(got, want, twin):
        assert torch.equal(_bits(g.cpu()), _bits(wc))
        assert torch.equal(_bits(g), _bits(wg))
    # the weights on the card are the host's
    assert torch.equal(bilateral_weights(i0.to(dev)).cpu(), wts)


def _tiled_golden_field(h, w, lanes):
    """(L, 2, h, w) planes finite at the golden DeepMatching seed positions
    tiled over h x w (lane l from deep_mt_{1 + l % 2}), NaN elsewhere."""
    base = _golden_seed_field(436, 1024, 2)
    reps = (-(-h // 436), -(-w // 1024))
    return np.stack([np.tile(base[lane % 2], (1,) + reps)[:, :h, :w]
                     for lane in range(lanes)])


@pytest.mark.parametrize("h,w,lanes", [(436, 1024, 2), (436, 1024, 1),
                                       (97, 131, 2), (5, 7, 1), (1, 300, 1),
                                       (300, 1, 2), (1088, 1920, 1),
                                       (1088, 1920, 2), (1088, 1920, 8)])
@pytest.mark.parametrize("kind", ["none", "one", "golden", "corners"])
def test_k10_one_launch_matches_twin_on_card(dev, h, w, lanes, kind):
    """K10 as one cooperative launch without a distance buffer, bit for bit
    its twin on the card (and on the CPU below a million cells): no finite
    cell, one, the golden positions (tiled past 436x1024), a finite cell in
    each corner only (the image-edge clamp); a stride set longer along one
    side at 1x300 and 300x1; 1088x1920 at L 1, 2 and 8."""
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image, nearest_fill_image_plain

    rng = np.random.default_rng(h * 7 + w + lanes)
    if kind == "golden":
        x = _tiled_golden_field(h, w, lanes)
    else:
        x = np.full((lanes, 2, h, w), np.nan, np.float32)
        cells = ({"one": [(h // 3, w - 1)],
                  "corners": [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)]}
                 .get(kind, []))
        for y, c in cells:
            x[:, :, y, c] = rng.normal(size=(lanes, 2))
    xg = torch.as_tensor(x, device=dev)
    before = nearest_fill_image.launches
    got = nearest_fill_image(xg)
    assert nearest_fill_image.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got), _bits(nearest_fill_image_plain(xg)))
    if x.size <= 2_000_000:
        assert torch.equal(_bits(got.cpu()),
                           _bits(nearest_fill_image_plain(torch.as_tensor(x))))


def test_k10_refuses_sides_past_its_packed_seeds_on_card(dev):
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    for shape in ((1, 1, 1 << 15, 1), (1, 1, 1, 1 << 16)):
        with pytest.raises(ValueError, match="16 bits each"):
            nearest_fill_image(torch.full(shape, float("nan"), device=dev))


@pytest.mark.parametrize("h,w", [(436, 1024), (97, 131), (5, 7), (3, 40),
                                 (1, 17), (60, 1), (1088, 1920)])
@pytest.mark.parametrize("lanes", [1, 2])
def test_k11_one_launch_matches_twin_on_card(dev, h, w, lanes):
    """K11 as one launch over column strips on the 5 colour planes, bit for
    bit its twin on the 25 weight planes (on the card, and on the CPU below
    a million cells): h < 5, w = 1, and 1088x1920 (more rows than a block
    has threads); trust from the golden positions and random cells, some
    cells fixed; one lane as an (h, w) call."""
    from faldoi_tpu_torch.core.bilateral import (
        bilateral_colour_planes, bilateral_filter_flow,
        bilateral_filter_flow_plain, bilateral_weights,
    )

    rng = np.random.default_rng(5 * h + w + lanes)
    i0 = torch.as_tensor(rng.random((h, w)).astype(np.float32))
    u = rng.normal(size=(2, lanes, h, w)).astype(np.float32) * 4
    trust = np.isfinite(_tiled_golden_field(h, w, lanes)[:, 0])
    trust |= rng.random((lanes, h, w)) < 0.5
    fixed = rng.random((lanes, h, w)) < 0.05
    if lanes == 1:
        u, trust, fixed = u[:, 0], trust[0], fixed[0]
    ug = torch.as_tensor(u, device=dev)
    tr = torch.as_tensor(trust.astype(np.int32), device=dev)
    fx = torch.as_tensor(fixed.astype(np.int32), device=dev)
    colour = bilateral_colour_planes(i0)
    assert torch.equal(bilateral_colour_planes(i0.to(dev)).cpu(), colour)
    before = bilateral_filter_flow.launches
    got = bilateral_filter_flow(i0.to(dev), ug[0], ug[1], tr, fx,
                                colour=colour.to(dev))
    assert bilateral_filter_flow.launches == before + 1
    wts = bilateral_weights(i0)
    twin = bilateral_filter_flow_plain(wts.to(dev), ug[0], ug[1], tr, fx)
    for g, wg in zip(got, twin):
        assert torch.equal(_bits(g), _bits(wg))
    if u.size <= 2_000_000:
        want = bilateral_filter_flow_plain(
            wts, *(torch.as_tensor(a) for a in (u[0], u[1], trust, fixed)))
        for g, wc in zip(got, want):
            assert torch.equal(_bits(g.cpu()), _bits(wc))


# the crops of the growing's modes (m0, 48x64, bsz 256, two outer
# iterations; exactmin and defer, at ~400 sweeps a drain, one): card
# against CPU
CARD_MODES = {
    "relax": (2, dict(relax=True)),
    "exactmin_11_band0": (1, dict(exactmin=11)),
    "exactmin_11_band1": (1, dict(exactmin=11, exactmin_band="1")),
    "exactmin_10_band2": (1, dict(exactmin=10, exactmin_band="2")),
    "defer": (1, dict(defer=0.25, defer_win=21)),
    "polish": (2, dict(polish=1)),
    "dense": (2, dict(fill="dense")),
    "bilateral": (2, dict(bilateral=True)),
    "relax_late_cold": (2, dict(relax_late=True, warm_band=0, polish=1)),
}


@pytest.mark.parametrize("mode", list(CARD_MODES))
def test_growing_mode_on_card_matches_cpu(dev, mode):
    """``match_growing`` under each ordering mode and fill on the card
    against the CPU, bit for bit, with the same sweeps."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    h, w = 48, 64
    i0, i1, gf, gb = syn.make_pair(h, w, seed=171)
    rng = np.random.default_rng(172)
    go = syn.make_seeds(gf, syn.random_seed_positions(h, w, 40, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(h, w, 40, rng), rng)
    prm = P.Parameters()
    prm.iterations_of, modes = CARD_MODES[mode]
    res = []
    for d in ("cpu", dev):
        st = {}
        out = match_growing(go, ba, *prepare_pair(i0, i1, device=d), prm,
                            bsz=256, stats=st, **modes)
        res.append(([t.cpu().numpy() for t in out], st["sweeps"]))
    assert res[0][1] == res[1][1]
    assert np.isfinite(res[0][0][0]).all()
    for x, y in zip(res[0][0], res[1][0]):
        assert _np_same_bits(x, y)

"""The hand-written CUDA kernels (K0 in its stack and planes forms, K4 in its
point, patch and flow forms, the K5 loop, the NLTV loops K6 and K7, the
probes P1-P3, K8 in its whole-image and patch forms, the K8 loop and the
occlusion PD loop K9 in its patch and whole-image forms, the jump-flood
dense fill K10 and the bilateral filter K11, each in one launch, the TV-L1
patch solve K12 and the canvas Poisson fill K13) against
their plain twins, on the card (K0's two forms and K4's patch form also
with a lane index), and
the weighted, the NLTV, the CSAD and the occlusion solvers and global steps,
the lane-batched sweep, pairs mode and the growing's ordering modes and
fills (relax, exactmin, defer, polish, dense, bilateral, relax_late) on the
card against their CPU runs; K4's point form at its callers' shapes, and
the mesh functions (``parallel/mesh.py``) and the batched patch solver on
the card against their CPU runs.

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
growings under the ordering modes, K12 and K13 must equal their twins (and
CPU runs) bit for bit: they sum in the twins' order, and K8 selects one of
the entries the twin sorts."""

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


@pytest.mark.parametrize("max_iters", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [676, 297])
def test_k8_loop_ranked_iterations_on_card(dev, b, max_iters):
    """The K8 loop's ranked selection (b ranked once a call, a merge search
    every PD iteration) at every cap from 1 to 4 and the m6 and m4 paths'
    median B: bit for bit with the twin, canvases and counts."""
    from faldoi_tpu_torch.ops.csad import csad_patch_loop, csad_patch_loop_plain

    args = _k8_loop_args(dev, 11, b, 500 + b + max_iters, False)
    got = csad_patch_loop(*args, max_iters)
    want = csad_patch_loop_plain(*args, max_iters)
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert bool((got[4] <= max_iters).all())


def _pooled_loop_inputs(dev, p, nb, seed):
    """Loop inputs whose entries tie and whose selections hit zeros of both
    signs: b drawn from a few values with +-0, u1 from a few values, u2 0,
    i1wx 1, i1wy -1 and denom 1 (so dot = u1), l_t one a cell of either
    sign; boxes of every size up to P."""
    from faldoi_tpu_torch.ops.csad import canvas_masks

    rng = np.random.default_rng(seed)
    ph, pw = (torch.as_tensor(rng.integers(1, p + 1, nb).astype(np.int32), device=dev)
              for _ in range(2))
    ph[:4], pw[:4] = p, p
    m, n = canvas_masks(ph, pw, p)
    pool = np.float32([-1.0, -0.5, -0.0, 0.0, 0.25, 0.5, 1.0])
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)   # noqa: E731
    bb = torch.where(m, f(pool[rng.integers(0, len(pool), (48, nb, p, p))]),
                     torch.zeros((), device=dev)).contiguous()
    u1 = f(np.float32([0.0, 0.25, -0.5, 0.1])[rng.integers(0, 4, (nb, p, p))])
    one = torch.ones((nb, p, p), device=dev)
    lt = f(np.float32([0.25, -0.25, 0.5, 0.05])[rng.integers(0, 4, (nb, p, p))])
    return u1, 0 * one, bb, one, -one, one.clone(), lt, m, n, ph, pw


def _pooled_fallbacks(args, step, max_iters):
    """The plain model's fallback cells at each PD iteration of the twin's
    run (``step(k)``: u1, u2 after k iterations), and the selected values:
    [(med, fallback)]."""
    from faldoi_tpu_torch.ops.csad import csad_ranked_select_plain

    u1, u2, bb, gx, gy, den, lt, m, n = (x.cpu() for x in args[:9])
    dots = []
    for k in range(max_iters):
        c1, c2 = (x.cpu() for x in step(k))
        dots.append((gx * c1 + gy * c2) / den)
    return csad_ranked_select_plain(bb, m, n, lt, den, dots)


def test_k8_loop_fallback_cells_on_card(dev):
    """Cells that take the counting path in some PD iterations and not in
    others (a selected zero after a non-zero one), with selected zeros of
    both signs: the K8 loop equals its twin bit for bit."""
    from faldoi_tpu_torch.ops.csad import csad_patch_loop, csad_patch_loop_plain

    u1, u2, bb, gx, gy, den, lt, m, n, ph, pw = _pooled_loop_inputs(dev, 11, 300, 530)
    f = lambda x: torch.tensor(np.float32(x), device=dev)   # noqa: E731
    args = [u1, u2, u1, u2, bb, gx, gy, den, lt, m, n, ph, pw, f(0.3), f(0.1),
            f(1e-12)]
    sel = _pooled_fallbacks([u1, u2, bb, gx, gy, den, lt, m, n],
                            lambda k: csad_patch_loop_plain(*args, k)[:2], 4)
    fb = torch.stack([x for _, x in sel])
    assert bool((fb.any(0) & ~fb.all(0)).any())
    zero = torch.stack([x for x, _ in sel]) == 0
    sign = torch.signbit(torch.stack([x for x, _ in sel]))
    assert bool((zero & sign).any()) and bool((zero & ~sign).any())
    got = csad_patch_loop(*args, 4)
    want = csad_patch_loop_plain(*args, 4)
    for x, y in zip(got, want):
        assert _same_bits(x, y)


@pytest.fixture(scope="module")
def k8_variants_lib():
    """The former K8 loop and K16 and the ranked selection's layouts
    (``csrc/variants/k8_variants.cu``), built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from faldoi_tpu_torch.cli.k8_variants import build_variants

    return build_variants()[0]


@pytest.mark.parametrize("p,b,pooled", [(11, 297, False), (11, 676, False),
                                        (11, 200, True), (3, 61, False)])
def test_k8_loop_former_forms_match_library_on_card(dev, k8_variants_lib, p, b,
                                                    pooled):
    """Every K8 loop form of ``cli/k8_variants.py`` (the former, the kernel
    counting every iteration; the ranked layouts) equals the library's
    ``csad_patch_loop`` bit for bit, four PD iterations; the pooled cells
    take the fallback."""
    from faldoi_tpu_torch.cli.k8_variants import LOOP_VARIANTS, call_loop
    from faldoi_tpu_torch.ops.csad import csad_patch_loop

    if pooled:
        u1, u2, bb, gx, gy, den, lt, m, n, ph, pw = _pooled_loop_inputs(dev, p, b, 540)
        f = lambda x: torch.tensor(np.float32(x), device=dev)   # noqa: E731
        args = [u1, u2, u1, u2, bb, gx, gy, den, lt, m, n, ph, pw, f(0.3), f(0.1),
                f(1e-12)]
    else:
        args = _k8_loop_args(dev, p, b, 540 + p + b, False)
    want = csad_patch_loop(*args, 4)
    for v in (LOOP_VARIANTS if p == 11 else (0, "library")):
        got = call_loop(k8_variants_lib, v, args)
        assert all(_same_bits(x, y) for x, y in zip(got, want)), LOOP_VARIANTS[v]


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


def _k14_args(dev, h, w, seed, tol2, max_iters):
    """K14's arguments for one warp: K8's whole-image inputs
    (``_csad_global_inputs``), u_bar = u, random duals; theta 0.3, tau
    0.125."""
    u1, u2, b, gx, gy, grad, l_t, m, n = _csad_global_inputs(dev, h, w, seed)
    rng = np.random.default_rng(seed + 1)
    xi = [torch.as_tensor(rng.normal(0, 0.5, (h, w)).astype(np.float32),
                          device=dev) for _ in range(4)]
    return [u1, u2, u1.clone(), u2.clone(), *xi, b, gx, gy, grad, l_t, m, n,
            0.3, 0.125, tol2, max_iters]


def _k14_errs(args, k):
    """The first ``k`` mean squared updates of K14's loop on ``args``, by the
    twin one iteration at a time on copies."""
    from faldoi_tpu_torch.core.global_step_csad import (
        ordered_err, tvcsad_global_loop_plain,
    )

    a = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    errs = []
    for _ in range(k):
        u1, u2 = a[0].clone(), a[1].clone()
        tvcsad_global_loop_plain(*a[:-2], -1.0, 1)
        d1, d2 = a[0] - u1, a[1] - u2
        errs.append(float((ordered_err(d1 * d1 + d2 * d2)
                           / torch.tensor(float(u1.numel()), dtype=torch.float64,
                                          device=u1.device)).float()))
    return errs


def _real_warp_args(dev, method, iters, crop=None):
    """K14's (method 4) or K15's (method 6) arguments for the first warp of
    the synthetic pair at 436x1024 (its known flow plus 0.5 px of noise), as
    ``tvcsad_global`` / ``nltvcsad_global`` build them, or cut from it to
    ``crop`` (h, w) before the warp."""
    from faldoi_tpu_torch import synthetic as syn
    from faldoi_tpu_torch.cli.k8_variants import csad_global_args
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(436, 1024, seed=0)
    a, b = prepare_pair(i0, i1, device=dev)
    rng = np.random.default_rng(7)
    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32),
                           device=dev)
    h, w = crop or (436, 1024)
    return csad_global_args(a[:h, :w].contiguous(), b[:h, :w].contiguous(),
                            flow[:h, :w].contiguous(), method, i0[:, :h, :w],
                            iters)


@pytest.mark.parametrize("h,w,stop", [(436, 1024, "cap"), (436, 1024, "real"),
                                      (40, 56, "real"), (40, 56, "cap"),
                                      (40, 56, "tol"), (40, 56, "one"),
                                      (5, 7, "cap"), (3, 3, "cap")])
def test_k14_matches_twin_on_card(dev, h, w, stop):
    """K14 (TV-CSAD's global loop, one call a warp: b ranked once, a merge
    search every PD iteration) against its twin on the card, bit for bit:
    u, u_bar, the four duals and the iteration count; "cap": tol^2 0, the
    loop runs to its cap of 6; "real": the same on the first warp of the
    synthetic pair; "tol": a tol^2 between the first mean squared update
    that falls below every earlier one and the least of those stops it
    there (after 2-5); "one": tol^2 1e10 after 1."""
    from faldoi_tpu_torch.core.global_step_csad import (
        tvcsad_global_loop, tvcsad_global_loop_plain,
    )

    if stop == "real":
        args = _real_warp_args(dev, 4, 6, (h, w))
    else:
        args = _k14_args(dev, h, w, 240 + h + w, 0.0, 6)
    want_n = 6
    if stop == "tol":
        # the first iteration whose err falls below every earlier one
        errs = _k14_errs(args, 5)
        want_n = next(k + 1 for k in range(1, 5) if errs[k] < min(errs[:k]))
        args[-2] = float(np.float32((errs[want_n - 1] + min(errs[:want_n - 1]))
                                    / 2))
    elif stop == "one":
        args[-2], want_n = 1e10, 1
    got = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    want = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    before = tvcsad_global_loop.launches
    gn = tvcsad_global_loop(*got)
    assert tvcsad_global_loop.launches == before + 1
    wn = tvcsad_global_loop_plain(*want)
    assert int(gn) == int(wn) == want_n
    for x, y in zip(got[:8], want[:8]):
        assert _same_bits(x, y)


def test_k14_k15_refuse_what_they_do_not_take_on_card(dev):
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global_loop, tvcsad_global_loop,
    )

    small = _k14_args(dev, 2, 9, 250, 0.0, 3)
    with pytest.raises(ValueError, match="3 x 3"):
        tvcsad_global_loop(*small)
    args = _k14_args(dev, 9, 11, 251, 0.0, 3)
    bad = list(args)
    bad[8] = args[8][:47]
    with pytest.raises(ValueError, match="b"):
        tvcsad_global_loop(*bad)
    bad = list(args)
    bad[11] = args[11].double()
    with pytest.raises(TypeError, match="grad"):
        tvcsad_global_loop(*bad)
    k15 = _k15_args(dev, 2, 9, 252, 3)
    with pytest.raises(ValueError, match="3 x 3"):
        nltvcsad_global_loop(*k15)
    k15 = _k15_args(dev, 9, 11, 253, 3)
    bad = list(k15)
    bad[6] = k15[6][:12]
    with pytest.raises(ValueError, match="wp"):
        nltvcsad_global_loop(*bad)


def _k15_args(dev, h, w, seed, max_iters):
    """K15's arguments for one warp: the global step's symmetric weights of
    random colour planes, random u, u_bar, duals and warp planes, grad 0 at
    a tenth of the pixels (there v = u), sq = sqrt(grad) where grad > 1e-8,
    else 1; l_t, theta, tau of method 6."""
    from faldoi_tpu_torch.core.global_step_nltv import global_weights
    from faldoi_tpu_torch.core.pd_common import sqrt_rn
    from faldoi_tpu_torch.ops.csad import csad_b, image_masks

    rng = np.random.default_rng(seed)
    f = lambda s, shape=(h, w): torch.as_tensor(   # noqa: E731
        rng.normal(0, s, shape).astype(np.float32), device=dev)
    wp, wt = global_weights(rng.uniform(0, 255, (3, h, w)).astype(np.float32), dev)
    u1, u2, i0, i1w, gx, gy = f(2.0), f(2.0), f(0.3), f(0.3), f(0.05), f(0.05)
    gx[torch.as_tensor(rng.uniform(size=(h, w)) < 0.1, device=dev)] = 0.0
    gy[gx == 0] = 0.0
    grad = (gx * gx + gy * gy).contiguous()
    sq = sqrt_rn(torch.where(grad > 1e-8, grad, torch.ones((), device=dev)))
    m, n = image_masks(h, w, dev)
    b = csad_b(i0, i1w, gx, gy, u1, u2, sq, m)
    return [u1, u2, u1.clone(), u2.clone(), f(0.2, (24, h, w)),
            f(0.2, (24, h, w)), wp, wt, b, gx, gy, sq.contiguous(), grad,
            float(np.float32(40.0) * np.float32(0.3)), m, n, 0.3, 0.1, max_iters]


@pytest.mark.parametrize("h,w,iters,real", [
    (436, 1024, 3, False), (436, 1024, 10, True), (436, 1024, 1, True),
    (40, 56, 10, False), (40, 56, 400, True), (40, 56, 1, False), (5, 7, 5, False),
    (3, 3, 4, False)])
def test_k15_matches_twin_on_card(dev, h, w, iters, real):
    """K15 (NLTV-CSAD's global loop: one library call a warp, b ranked once,
    K6's dual phase and a primal phase that selects v itself an iteration)
    against its twin on the card, bit for bit: u, u_bar and the 48 duals;
    K15 launched once a call, K8 never (the former K15 launched K8's
    whole-image form once an iteration); "real": the first warp of the
    synthetic pair's global weights and breakpoints."""
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global_loop, nltvcsad_global_loop_plain,
    )
    from faldoi_tpu_torch.ops.csad import csad_vstep

    if real:
        args = _real_warp_args(dev, 6, iters, (h, w))
    else:
        args = _k15_args(dev, h, w, 260 + h + w, iters)
    got = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    want = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
    before, k8 = nltvcsad_global_loop.launches, csad_vstep.launches
    nltvcsad_global_loop(*got)
    assert nltvcsad_global_loop.launches == before + 1
    assert csad_vstep.launches == k8
    nltvcsad_global_loop_plain(*want)
    for x, y in zip(got[:6], want[:6]):
        assert _same_bits(x, y)


def _inject(dev, args, b_at, u_at, seed):
    """Make the whole-image loops' arguments adversarial, in place: b (at
    ``b_at``) drawn from a pool of ties and zeros of both signs with +-inf
    and NaN at inside neighbours of pixels on the image edge (those pixels
    take the counting path every PD iteration); u1 made +-inf or NaN at a few
    pixels (their dot is not finite in the first iteration)."""
    from faldoi_tpu_torch.ops.csad import image_masks

    b = args[b_at]
    _, h, w = b.shape
    rng = np.random.default_rng(seed)
    m, _ = image_masks(h, w, dev)
    pool = np.float32([-0.5, -0.25, -0.0, 0.0, 0.25, 0.5])
    b.copy_(torch.where(m, torch.as_tensor(pool[rng.integers(0, len(pool), b.shape)],
                                           device=dev), torch.zeros((), device=dev)))
    edge = [(0, 0), (0, w - 1), (h - 1, w // 2), (h // 2, 0)]
    for (y, x), v in zip(edge, (np.inf, -np.inf, np.nan, np.inf)):
        j = int(torch.nonzero(m[:, y, x])[0])   # an inside neighbour
        b[j, y, x] = float(v)
    u1 = args[u_at]
    for (y, x), v in zip(((h // 2, w // 2), (1, 1)), (np.nan, np.inf)):
        u1[y, x] = float(v)


@pytest.mark.parametrize("h,w", [(40, 56), (5, 7), (3, 3)])
def test_k14_k15_adversarial_cells_on_card(dev, h, w):
    """K14 and K15 on breakpoints that tie within A and with B and hold
    zeros of both signs, +-inf and NaN (pixels on the image edge take the
    counting path every iteration), and on a NaN and an inf dot: bit for
    bit with their twins (K14's count too)."""
    from faldoi_tpu_torch.core.global_step_csad import (
        nltvcsad_global_loop, nltvcsad_global_loop_plain, tvcsad_global_loop,
        tvcsad_global_loop_plain,
    )

    for k14, args in ((True, _k14_args(dev, h, w, 600 + h, 0.0, 4)),
                      (False, _k15_args(dev, h, w, 610 + h, 4))):
        _inject(dev, args, 8, 0, 620 + h)
        got = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
        want = [x.clone() if isinstance(x, torch.Tensor) else x for x in args]
        if k14:
            assert int(tvcsad_global_loop(*got)) == int(tvcsad_global_loop_plain(*want))
        else:
            nltvcsad_global_loop(*got)
            nltvcsad_global_loop_plain(*want)
        for x, y in zip(got[:8 if k14 else 6], want[:8 if k14 else 6]):
            assert _same_bits(x, y)


@pytest.fixture(scope="module")
def global_variants_lib():
    """K14's and K15's former and ranked forms
    (``csrc/variants/csad_global_variants.cu``), built once for the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from faldoi_tpu_torch.cli.k8_variants import build_global_variants

    return build_global_variants()[0]


@pytest.mark.parametrize("kernel,h,w", [("K14", 40, 56), ("K14", 5, 7),
                                        ("K15", 40, 56), ("K15", 3, 3)])
def test_k14_k15_former_forms_match_library_on_card(dev, global_variants_lib,
                                                    kernel, h, w):
    """Every K14 and K15 form of ``cli/k8_variants.py`` (the former,
    counting every iteration; the ranked layouts and lanes) equals its twin
    and the library's bit for bit."""
    from faldoi_tpu_torch.cli.k8_variants import (
        K14_VARIANTS, K15_VARIANTS, time_global,
    )

    if kernel == "K14":
        args = _k14_args(dev, h, w, 630 + h, 0.0, 4)
    else:
        args = _k15_args(dev, h, w, 640 + h, 4)
    forms = K14_VARIANTS if kernel == "K14" else K15_VARIANTS
    times = time_global(global_variants_lib, kernel, args, list(forms))
    assert set(times) == {str(v) for v in forms}


def _k16_args(dev, p, b, seed, weighted, duals=False, tol2=None):
    """K16's arguments for one warp: K8's patch inputs (``_csad_patch_inputs``,
    boxes clamped at the edges of a 40x56 image), v = u, the box-masked
    NLTV weights of method 6's consts cropped at the patches
    (``nltv_crop_weights``), random duals or none; theta 0.3, tau 0.1, tol
    0.01 (or ``tol2``)."""
    from faldoi_tpu_torch.core.functionals import nltv_crop_weights
    from faldoi_tpu_torch.core.local_step import patch_geometry

    u1, u2, bb, gx, gy, grad, l_t, m, n, ph, pw = _csad_patch_inputs(
        dev, p, b, seed, weighted)
    h, w = 40, 56
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, h * w, b))
    idx[:4] = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w])[:b]
    _, _, oy, ox, _, _ = patch_geometry(idx, h, w, p // 2)
    sc = _nltv_consts(dev, h, w, 6, p)[0]
    wp, wt = nltv_crop_weights(sc.wp_pad, oy.to(dev), ox.to(dev), ph, pw, p)
    d = None
    if duals:
        d = torch.as_tensor(np.random.default_rng(seed + 1).normal(
            0, 0.3, (2, 24, b, p, p)).astype(np.float32), device=dev)
    f = lambda x: torch.tensor(np.float32(x), device=dev)   # noqa: E731
    return [u1, u2, u1, u2, d, bb, gx, gy, grad, wp.contiguous(), wt.contiguous(),
            l_t, m, n, ph, pw, f(0.3), f(0.1),
            f(0.01) * f(0.01) if tol2 is None else f(tol2)]


@pytest.mark.parametrize("p,b,weighted,duals,tol2", [
    (11, 8192, False, False, None), (11, 1900, True, True, None),
    (11, 297, False, True, None), (11, 1, False, False, None),
    (3, 333, False, True, None), (11, 297, False, False, 1e10),
    (7, 50, True, True, None), (23, 10, False, True, None),
    (31, 3, False, True, None)],
    ids=["p11-b8192", "m7-b1900", "p11-b297", "p11-b1", "p3-b333",
         "large-tol", "p7", "p23", "p31"])
def test_k16_matches_twin_on_card(dev, p, b, weighted, duals, tol2):
    """K16 (NLTV-CSAD's patch loop, one launch a warp) against its twin on
    the card, bit for bit: canvases (NaN and +-inf of the out-of-box cells
    included), the duals it keeps and the iteration counts; a tol^2 of 1e10
    stops every canvas after one step; P 23 takes two lanes a cell, P 31
    one, with its weights read from device memory."""
    from faldoi_tpu_torch.core.functionals import (
        nltvcsad_patch_loop, nltvcsad_patch_loop_plain,
    )

    args = _k16_args(dev, p, b, 270 + p + b, weighted, duals, tol2)
    before = nltvcsad_patch_loop.launches
    got = nltvcsad_patch_loop(*args, 4, keep_duals=True)
    assert nltvcsad_patch_loop.launches == before + 1
    want = nltvcsad_patch_loop_plain(*args, 4, keep_duals=True)
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert bool(((got[4] >= 1) & (got[4] <= 4)).all())
    if tol2 is not None:
        assert bool((got[4] == 1).all())
    none = nltvcsad_patch_loop(*args, 4)
    assert none[5] is None and all(_same_bits(x, y) for x, y in zip(none[:5], got))


@pytest.mark.parametrize("max_iters", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [676, 297])
def test_k16_ranked_iterations_on_card(dev, b, max_iters):
    """K16's ranked selection at every cap from 1 to 4 and the m6 and m4
    paths' median B, duals given: bit for bit with the twin, canvases,
    duals and counts."""
    from faldoi_tpu_torch.core.functionals import (
        nltvcsad_patch_loop, nltvcsad_patch_loop_plain,
    )

    args = _k16_args(dev, 11, b, 550 + b + max_iters, False, duals=True)
    got = nltvcsad_patch_loop(*args, max_iters, keep_duals=True)
    want = nltvcsad_patch_loop_plain(*args, max_iters, keep_duals=True)
    for x, y in zip(got, want):
        assert _same_bits(x, y)
    assert bool((got[4] <= max_iters).all())


def _k16_pooled_args(dev, p, b, seed):
    """K16's arguments (``_k16_args``: the weights, random duals) on the
    pooled cells of ``_pooled_loop_inputs``, tol^2 1e-12."""
    args = _k16_args(dev, p, b, seed, False, duals=True, tol2=1e-12)
    u1, u2, bb, gx, gy, den, lt, m, n, ph, pw = _pooled_loop_inputs(dev, p, b, seed)
    args[:4] = [u1, u2, u1, u2]
    args[5:9] = [bb, gx, gy, den]
    args[11:16] = [lt, m, n, ph, pw]
    return args


def test_k16_fallback_cells_on_card(dev):
    """Cells that take the counting path in some PD iterations and not in
    others, zeros of both signs selected: K16 equals its twin bit for bit."""
    from faldoi_tpu_torch.core.functionals import (
        nltvcsad_patch_loop, nltvcsad_patch_loop_plain,
    )

    args = _k16_pooled_args(dev, 11, 300, 560)
    sel = _pooled_fallbacks([args[0], args[1], *args[5:9], *args[11:14]],
                            lambda k: nltvcsad_patch_loop_plain(*args, k)[:2], 4)
    fb = torch.stack([x for _, x in sel])
    assert bool((fb.any(0) & ~fb.all(0)).any())
    meds = torch.stack([x for x, _ in sel])
    assert bool(((meds == 0) & torch.signbit(meds)).any())
    assert bool(((meds == 0) & ~torch.signbit(meds)).any())
    got = nltvcsad_patch_loop(*args, 4, keep_duals=True)
    want = nltvcsad_patch_loop_plain(*args, 4, keep_duals=True)
    for x, y in zip(got, want):
        assert _same_bits(x, y)


@pytest.mark.parametrize("p,b,pooled", [(11, 297, False), (11, 676, False),
                                        (11, 200, True), (3, 61, False)])
def test_k16_former_forms_match_library_on_card(dev, k8_variants_lib, p, b, pooled):
    """Every K16 form of ``cli/k8_variants.py`` (the former, the kernel
    counting every iteration; the ranked layouts) equals the library's
    ``nltvcsad_patch_loop`` bit for bit, duals included, four PD
    iterations."""
    from faldoi_tpu_torch.cli.k8_variants import NL_VARIANTS, call_nl
    from faldoi_tpu_torch.core.functionals import nltvcsad_patch_loop

    args = (_k16_pooled_args(dev, p, b, 570) if pooled
            else _k16_args(dev, p, b, 570 + p + b, False, duals=True))
    want = nltvcsad_patch_loop(*args, 4, keep_duals=True)
    for v in (NL_VARIANTS if p == 11 else (0, "library")):
        got = call_nl(k8_variants_lib, v, args)
        assert all(_same_bits(x, y) for x, y in zip(got, want)), NL_VARIANTS[v]


def test_k16_wrapper_raises_on_bad_card_tensors(dev):
    from faldoi_tpu_torch.core.functionals import nltvcsad_patch_loop

    args = _k16_args(dev, 11, 20, 290, False)
    for k, exc, name, bad in (
            (5, ValueError, "b", lambda a: a[:47]),
            (9, ValueError, "wp", lambda a: a[:23]),
            (14, TypeError, "ph", lambda a: a.to(torch.int64)),
            (11, ValueError, "l_t", lambda a: a.expand(20, 11, 11)),
            (4, ValueError, "duals", lambda a: torch.zeros(2, 24, 19, 11, 11,
                                                           device=dev))):
        bad_args = list(args)
        bad_args[k] = bad(args[k])
        with pytest.raises(exc, match=name):
            nltvcsad_patch_loop(*bad_args, 4)
    with pytest.raises(ValueError, match="patch side"):
        big = torch.zeros(2, 33, 33, device=dev)
        nltvcsad_patch_loop(big, *args[1:], 4)


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
    from faldoi_tpu_torch.core.functionals import tvl1_patch_solve
    from faldoi_tpu_torch.core.local_step import state_to_numpy, sweep_lanes
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.patch_gather import gather_plane_patches
    from faldoi_tpu_torch.ops.poisson import poisson_fill_planes

    h, w = 48, 64
    trust = torch.ones((4, h, w), dtype=torch.int32)
    trust[0, 10:20, 5:30] = 0
    trust[3, 30:40, 40:60] = 0
    out = []
    for d in ("cpu", dev):
        sc, st = _four_lanes(d, h, w)
        sal = torch.ones((4, h * w + 1), device=d)
        counts = []
        wrappers = (gather_plane_patches, poisson_fill_planes,
                    tvl1_patch_solve, bicubic_sample_patches)
        before = [f.launches for f in wrappers]
        for it, tr in [(0, torch.ones((4, h, w), device=d))] * 4 + [
                (1, trust.to(d))] * 2:
            st, c = sweep_lanes(st, sc, tr, sal, it, h, w, 5, 256, 1, 4, 16)
            counts.append(c)
        if d != "cpu":
            # one state crop, one fill and one solve a sweep for all four
            # lanes; the solve samples in K12, K4's patch form never
            assert [f.launches - n for f, n in zip(wrappers, before)] == [
                6, 6, 6, 0]
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


# --- K4's point form in its redesigned launch, and the modules that sample
# with it: the mesh functions and the batched patch solver


def _k4_point_shapes(dev):
    """K4's point form at the shapes its callers give it: 3 x 436x1024 at
    the whole-image points of a noisy and a smooth flow (a), the row-sharded
    global step's band at 4 shards (b), ``zoom_in`` of 1 x 218x512 to
    436x1024 (c), the patch solver's (8192, 11, 11) points (d)."""
    from faldoi_tpu_torch.cli.k4_variants import point_shapes

    return point_shapes(dev, np.random.default_rng(31))


@pytest.mark.parametrize("shape", ["a_noisy", "a_smooth", "b_band",
                                   "c_zoom_in", "d_patches"])
def test_k4_point_form_matches_twin_at_path_shapes_on_card(dev, shape):
    """The point form bit for bit equal to its twin (on the CPU) at the
    shapes its callers give it, both border modes; and the flow form equal
    to it at the whole-image points."""
    from faldoi_tpu_torch.ops.bicubic import (
        bicubic_sample, bicubic_sample_plain, bicubic_warp_planes,
    )

    calls, _ = _k4_point_shapes(dev)[shape]
    for planes, uu, vv in calls:
        for border_out in (True, False):
            want = bicubic_sample_plain(planes.cpu(), uu.cpu(), vv.cpu(), border_out)
            before = bicubic_sample.launches
            got = bicubic_sample(planes, uu, vv, border_out)
            assert bicubic_sample.launches == before + 1
            assert torch.equal(_bits(got.cpu()), _bits(want))
    if shape.startswith("a_"):
        planes, uu, vv = calls[0]
        ii = torch.arange(uu.shape[0], dtype=torch.float32, device=dev)[:, None]
        jj = torch.arange(uu.shape[1], dtype=torch.float32, device=dev)[None, :]
        flow = bicubic_warp_planes(planes, uu - jj, vv - ii, True)
        # the flow form forms j + (uu - j), which rounds back to uu only
        # where that is exact: compare at the points it formed
        point = bicubic_sample(planes, jj + (uu - jj), ii + (vv - ii), True)
        assert torch.equal(_bits(flow), _bits(point))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(2000,), (1,), (37, 19), (1, 70), (16, 16),
                                   (40, 50), (1, 11, 11), (63, 11, 11),
                                   (5, 3, 3), (3, 17, 33)])
def test_k4_point_form_adversarial_points_on_card(dev, c, shape):
    """Every sign pairing, the edges, NaN and far-out points, at C 1-5 and
    points of 1, 2 and 3 dimensions (tiled and 1-D launches, ragged tails),
    bit for bit with the twin in both border modes; a NaN point gives NaN
    where the twin's does (the card's arithmetic NaN is the canonical one,
    the CPU's another payload)."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample, bicubic_sample_plain

    rng = np.random.default_rng(41 + c)
    ny, nx = 23, 37
    planes = torch.as_tensor(rng.uniform(-1, 1, (c, ny, nx)).astype(np.float32))
    n = int(np.prod(shape))
    uu, vv = (t.numpy() for t in _points(rng, ny, nx, max(n, 100)))
    uu, vv = uu[:n].copy(), vv[:n].copy()
    edges = np.array([0, -0.0, nx - 1, nx - 2, -1, nx, np.nan, 1e12, -3e11,
                      0.5], np.float32)
    k = min(n, len(edges))
    uu[:k] = edges[:k]
    vv[:k] = edges[::-1][:k] * (ny / nx)
    uu, vv = (torch.as_tensor(x.reshape(shape)) for x in (uu, vv))
    for border_out in (True, False):
        want = bicubic_sample_plain(planes, uu, vv, border_out)
        got = bicubic_sample(planes.to(dev), uu.to(dev), vv.to(dev),
                             border_out).cpu()
        assert got.shape == (c,) + shape
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(_bits(got[~nan]), _bits(want[~nan]))
        # the NaN point reads the image unless border_out zeroes it
        assert bool(nan.any()) == (not border_out and n > 6)


def _mesh_pair(h, w, seed, dev):
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, _ = syn.make_pair(h, w, seed=seed)
    a, b = prepare_pair(i0, i1, device=dev)
    rng = np.random.default_rng(seed)
    f = (gf + rng.normal(0, 0.3, gf.shape)).astype(np.float32)
    return a, b, torch.as_tensor(f[..., 0]), torch.as_tensor(f[..., 1])


def test_spatial_tvl2_global_on_card_matches_cpu(dev):
    """The row-sharded global step with its 4 shards on the card equal to
    its run with CPU shards, bit for bit; one K4 point-form launch a shard a
    warp."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.parallel import make_mesh, spatial_tvl2_global

    res = []
    for d in ("cpu", dev):
        a, b, u, v = _mesh_pair(64, 96, 201, d)
        before = bicubic_sample.launches
        out = spatial_tvl2_global(make_mesh(1, 4, devices=[d] * 4), a, b, u, v,
                                  iters=30, warps=3, max_disp=8)
        if d == dev:
            assert bicubic_sample.launches - before == 4 * 3
            assert out[0].device.type == "cuda"
        res.append([t.cpu() for t in out])
    assert np.isfinite(res[0][0].numpy()).all()
    for x, y in zip(*res):
        assert torch.equal(_bits(x), _bits(y))


def test_dp_global_refine_on_card_matches_cpu(dev):
    """The data-split global refinement on the card equal to its CPU run,
    bit for bit; K5 runs its fixed iterations."""
    from faldoi_tpu_torch.core.global_step import global_pd_loop
    from faldoi_tpu_torch.parallel import dp_global_refine, make_mesh

    pairs = [_mesh_pair(48, 64, 210 + k, "cpu") for k in range(2)]
    i0b, i1b, u1b, u2b = (torch.stack([p[j] for p in pairs]) for j in range(4))
    res = []
    for d in ("cpu", dev):
        before = global_pd_loop.launches
        out = dp_global_refine(make_mesh(2, 1, devices=[d] * 2), i0b, i1b,
                               u1b, u2b, warps=2, iters=25)
        if d == dev:
            assert global_pd_loop.launches - before == 2 * 2
        res.append([t.cpu() for t in out])
    for x, y in zip(*res):
        assert torch.equal(_bits(x), _bits(y))


def test_pipeline_train_step_on_card_matches_cpu(dev):
    """The bounded whole pipeline of two pairs on the card equal to its CPU
    run, bit for bit."""
    from faldoi_tpu_torch.parallel import make_mesh, pipeline_train_step

    h, w = 32, 48
    rng = np.random.default_rng(220)
    i0b, i1b, seeds = [], [], []
    for k in range(2):
        i0, i1, gf, _ = syn.make_pair(h, w, seed=221 + k)
        from faldoi_tpu_torch.core.preprocess import prepare_pair

        a, b = prepare_pair(i0, i1, device="cpu")
        i0b.append(a)
        i1b.append(b)
        seeds.append(syn.make_seeds(gf, syn.random_seed_positions(h, w, 30, rng), rng))
    i0b, i1b = torch.stack(i0b), torch.stack(i1b)
    seeds = np.stack(seeds).astype(np.float32)
    res = [pipeline_train_step(make_mesh(2, 1, devices=[d] * 2), i0b, i1b,
                               seeds, n_seeds=24, bsz=256).cpu()
           for d in ("cpu", dev)]
    assert np.isfinite(res[0].numpy()).all()
    assert torch.equal(_bits(res[0]), _bits(res[1]))


@pytest.mark.parametrize("p,b", [(11, 64), (11, 1), (3, 40)])
def test_solve_patch_batch_on_card_matches_cpu(dev, p, b):
    """The batched patch solver on the card equal to its CPU run, bit for
    bit; K4's point form at C 3 a warp and at C 1 for the energy."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.core.patch_solver import PatchBatch, solve_patch_batch
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    h, w = 33, 45
    a, bb, u, v = _mesh_pair(h, w, 230 + p, "cpu")
    rng = np.random.default_rng(231)
    idx = torch.as_tensor(rng.integers(0, h * w, b))
    idx[:1] = 0
    _, _, oy, ox, ph, pw = patch_geometry(idx, h, w, p // 2)
    rows = (oy[:, None, None] + torch.arange(p)[:, None]).clamp(max=h - 1)
    cols = (ox[:, None, None] + torch.arange(p)[None, :]).clamp(max=w - 1)
    u1 = (u[rows, cols] + torch.as_tensor(rng.normal(0, 1.0, (b, p, p)),
                                          dtype=torch.float32)).contiguous()
    u2 = v[rows, cols].contiguous()
    res = []
    for d in ("cpu", dev):
        bx, by = centered_gradient(bb.to(d))
        batch = PatchBatch(*(t.to(d, torch.int32) for t in (oy, ox, ph, pw)),
                           u1.to(d), u2.to(d))
        before = bicubic_sample.launches
        out = solve_patch_batch(bb.to(d), bx, by, a.to(d), batch, warps=2)
        if d == dev:
            assert bicubic_sample.launches - before == 2 + 1
        res.append([t.cpu() for t in out])
    assert np.isfinite(res[0][2].numpy()).all()
    for x, y in zip(*res):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("method,n_space,shape", [(0, 2, (48, 64)),
                                                  (0, 4, (48, 64)),
                                                  (4, 2, (32, 48))])
def test_spatial_match_growing_on_card_matches_cpu(dev, method, n_space,
                                                   shape):
    """The row-sharded local growing with its shards on the card equal to
    its run with CPU shards, bit for bit (NaN by mask), with the same
    sweeps; K0's planes form and K13 launch on the card, and K12 for method
    0, K0's stack form, K4's patch form and the K8 loop for method 4."""
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.functionals import tvl1_patch_solve
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample_patches
    from faldoi_tpu_torch.ops.csad import csad_patch_loop
    from faldoi_tpu_torch.ops.patch_gather import (
        gather_patches, gather_plane_patches,
    )
    from faldoi_tpu_torch.ops.poisson import poisson_fill_planes
    from faldoi_tpu_torch.parallel import make_mesh, spatial_match_growing

    h, w = shape
    i0, i1, gf, gb = syn.make_pair(h, w, seed=240, full_shape=(96, 128))
    rng = np.random.default_rng(241)
    go = syn.make_seeds(gf, syn.random_seed_positions(h, w, 40, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(h, w, 40, rng), rng)
    prm = P.Parameters()
    prm.val_method = method
    prm.iterations_of = 1
    wrappers = [gather_plane_patches, poisson_fill_planes]
    if method == 4:
        wrappers += [gather_patches, bicubic_sample_patches, csad_patch_loop]
    else:
        wrappers.append(tvl1_patch_solve)
    res = []
    for d in ("cpu", dev):
        a, b = prepare_pair(i0, i1, device=d)
        before = [f.launches for f in wrappers]
        st = {}
        out = spatial_match_growing(make_mesh(1, n_space, devices=[d] * n_space),
                                    go, ba, a, b, prm, bsz=256, stats=st)
        if d == dev:
            assert all(f.launches > n for f, n in zip(wrappers, before))
            assert out[0].device.type == "cuda"
        res.append(([t.cpu() for t in out], st["sweeps"]))
    assert res[0][1] == res[1][1]
    assert np.isfinite(res[0][0][0].numpy()).mean() > 0.95
    for x, y in zip(res[0][0], res[1][0]):
        nan = x.isnan()
        assert torch.equal(nan, y.isnan())
        assert torch.equal(_bits(x[~nan]), _bits(y[~nan]))


def _same_nan(a, b):
    """Bit for bit, NaN compared by mask (a NaN's payload may differ)."""
    a, b = a.cpu(), b.cpu()
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and torch.equal(_bits(a[~nan]), _bits(b[~nan])))


def _fill_canvases(rng, b, p, kind="random"):
    """u and v canvases of B patches with holes (NaN) and their boxes: the
    first canvases full-box, all-hole, centre-only (the seed insertion's)
    and without holes, then ragged boxes (clamped at an image edge)."""
    u, v = (rng.uniform(-6, 6, (b, p, p)).astype(np.float32) for _ in range(2))
    hole = rng.random((b, p, p)) < 0.7
    ph = rng.integers(1, p + 1, b)
    pw = rng.integers(1, p + 1, b)
    ph[:4], pw[:4] = p, p
    hole[1:3] = True
    hole[2:3, p // 2, p // 2] = False
    hole[3:4] = False
    u[hole], v[hole] = np.nan, np.nan
    u[5 % b, 0, 0] = np.inf                    # an infinite cell is a hole
    return ([torch.as_tensor(x) for x in (u, v)],
            [torch.as_tensor(x) for x in (ph, pw)])


# the sweep's P 11, the seed insertion's P 3, B odd and B 1 (a warp's second
# canvas missing), sides compiled for no size: 7, 16 (the largest with two
# canvases a warp), 17 (one canvas a warp) and 32 (the largest)
K13_CASES = [(11, 8192), (11, 1900), (11, 577), (11, 1901), (11, 1), (3, 1703),
             (3, 1), (7, 61), (16, 33), (17, 3), (32, 5)]


@pytest.mark.parametrize("exact", [False, True], ids=["red-black", "exact"])
@pytest.mark.parametrize("p,b", K13_CASES)
def test_k13_matches_twin_on_card(dev, p, b, exact):
    """K13 (``poisson_fill_planes``) against its twin on the card and on
    the CPU, bit for bit: u and v of B canvases as two planes of one launch
    and one plane alone, the sweep's P 11 at B 8192, 1900 and 1, the seed
    insertion's P 3 at B 1703 and 1, B odd, and sides compiled for no size
    (7, 16, 17 and the largest, 32)."""
    from faldoi_tpu_torch.ops.poisson import (
        poisson_fill_canvas, poisson_fill_canvas_plain, poisson_fill_planes,
    )

    rng = np.random.default_rng(300 + p + b)
    (u, v), (ph, pw) = _fill_canvases(rng, b, p)
    want = poisson_fill_canvas_plain(torch.cat([u, v]), torch.cat([ph, ph]),
                                     torch.cat([pw, pw]), exact=exact)
    ud, vd, phd, pwd = (t.to(dev) for t in (u, v, ph, pw))
    card = poisson_fill_canvas_plain(torch.cat([ud, vd]), torch.cat([phd, phd]),
                                     torch.cat([pwd, pwd]), exact=exact)
    before = poisson_fill_planes.launches
    got = poisson_fill_planes((ud, vd), phd, pwd, exact=exact)
    assert poisson_fill_planes.launches == before + 1
    assert _same_nan(torch.cat(got), card)
    assert _same_nan(torch.cat(got), want)
    assert bool(torch.isfinite(got[0]).all())
    one = poisson_fill_canvas(vd, phd, pwd.to(torch.int32), exact=exact)
    assert poisson_fill_planes.launches == before + 2
    assert _same_nan(one, got[1])
    assert torch.equal(ud.isnan(), u.to(dev).isnan())   # inputs unchanged


@pytest.mark.parametrize("exact", [False, True], ids=["red-black", "exact"])
@pytest.mark.parametrize("p,b", [(11, 33), (3, 7)])
def test_k13_infinite_holes_one_plane_on_card(dev, p, b, exact):
    """K13 on one plane of an odd B (two patches a warp, the last warp's
    second canvas missing) with +inf and -inf holes beside NaN ones and
    an all-NaN canvas, bit for bit against its twin on the card."""
    from faldoi_tpu_torch.ops.poisson import (
        poisson_fill_canvas, poisson_fill_canvas_plain,
    )

    rng = np.random.default_rng(320 + p + b)
    (u, _), (ph, pw) = _fill_canvases(rng, b, p)
    u[4, 0, 1] = float("-inf")
    u[6, 1, 0] = float("inf")
    u[6, 0, 0] = float("-inf")
    u[b - 1] = float("nan")
    ud, phd, pwd = u.to(dev), ph.to(dev), pw.to(dev)
    want = poisson_fill_canvas_plain(ud, phd, pwd, exact=exact)
    got = poisson_fill_canvas(ud, phd, pwd, exact=exact)
    assert _same_nan(got, want)
    assert _same_nan(got, poisson_fill_canvas_plain(u, ph, pw, exact=exact))
    assert bool(torch.isfinite(got).all())


def test_k13_refuses_what_it_does_not_take_on_card(dev):
    from faldoi_tpu_torch.ops.poisson import poisson_fill_planes

    rng = np.random.default_rng(310)
    (u, v), (ph, pw) = _fill_canvases(rng, 16, 11)
    u, v, ph, pw = (t.to(dev) for t in (u, v, ph, pw))
    before = poisson_fill_planes.launches
    with pytest.raises(TypeError):
        poisson_fill_planes((u.double(), v.double()), ph, pw)
    with pytest.raises(TypeError):
        poisson_fill_planes((u, v), ph.float(), pw)
    with pytest.raises(ValueError):
        poisson_fill_planes((u, v[:8]), ph, pw)
    with pytest.raises(ValueError):
        poisson_fill_planes((u, v), ph[:8], pw)
    with pytest.raises(ValueError):
        poisson_fill_planes((u, v, u), ph, pw)
    with pytest.raises(ValueError):
        poisson_fill_planes((u[:, :, :10],), ph, pw)
    with pytest.raises(ValueError):
        poisson_fill_planes((u, v.cpu()), ph, pw)
    big = torch.zeros((2, 33, 33), device=dev)
    box = torch.full((2,), 33, device=dev)
    with pytest.raises(ValueError):
        poisson_fill_planes((big,), box, box)
    assert poisson_fill_planes.launches == before


def _k12_consts(dev, lanes, method, seed=320, p=11):
    """Solver consts of ``lanes`` synthetic pairs (each its own frames) on
    the card for patches of side p, stacked with a lane axis when lanes >
    1."""
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.models import method_local_params

    lam, theta, tau = method_local_params(method, 5)
    scs = []
    for k in range(lanes):
        i0, i1, _, _ = syn.make_pair(96, 128, seed=seed + k)
        a, b = prepare_pair(i0, i1, device=dev)
        scs.append(make_solver_consts(a, b, lam, theta, tau, 0.01, p, method))
    return scs[0] if lanes == 1 else stack_solver_consts(scs)


def _k12_patches(sc, dev, p, b, lanes, seed):
    """B patches of side p: centres at random pixels with the image's
    corners and edges first (clamped boxes), inits around the synthetic
    flow with noise, zero outside the box; a lane index when lanes > 1."""
    from faldoi_tpu_torch.core.local_step import patch_geometry

    h, w = sc.i1.shape[-2:]
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(0, h * w, b))
    corners = torch.as_tensor([0, w - 1, h * w - 1, (h - 1) * w, 2 * w + 1])
    idx[:min(b, 5)] = corners[:min(b, 5)]
    geo = patch_geometry(idx.to(dev), h, w, p // 2)
    rows = torch.arange(p, device=dev)
    inbox = ((rows[:, None] < geo[4][:, None, None])
             & (rows[None, :] < geo[5][:, None, None]))
    u1, u2 = (torch.where(inbox, torch.as_tensor(
        rng.normal(m, 1.0, (b, p, p)).astype(np.float32), device=dev), 0.0)
        for m in (2.6, -1.4))
    lane = (None if lanes == 1 else
            torch.as_tensor(rng.integers(0, lanes, b), device=dev))
    return geo, u1.contiguous(), u2.contiguous(), lane


K12_CASES = [(11, 8192), (11, 1900), (11, 297), (11, 1), (3, 1703)]


@pytest.mark.parametrize("tol", ["0.01", "freeze"])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("p,b", K12_CASES)
def test_k12_matches_twin_on_card(dev, p, b, method, lanes, tol):
    """K12 (``tvl1_patch_solve``, through ``solve_tvl1`` / ``solve_tvl1_w``)
    against its twin on the card and on the CPU, bit for bit: the solved
    canvases and the energies, two warps of at most 4 PD iterations; P 11
    at B 8192 / 1900 / 297 / 1 and P 3 (the seed insertion's) at B 1703,
    methods 0 and 1, one lane and two lane-stacked pairs; "freeze": a tol
    under which every canvas stops after one PD iteration of each warp."""
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, solver_for, tvl1_patch_solve,
    )

    sc = _k12_consts(dev, lanes, method)
    if tol == "freeze":
        sc = sc._replace(tol=torch.full_like(sc.tol, 1e3))
    geo, u1, u2, lane = _k12_patches(sc, dev, p, b, lanes, 330 + p + b)
    args = (*geo, u1, u2, p, 2, 4)
    want = _solve_tvl1_family_plain(sc, *args, method == 1, lane)
    cpu_sc = type(sc)(*(None if f is None else f.cpu() for f in sc))
    cpu = _solve_tvl1_family_plain(
        cpu_sc, *(t.cpu() for t in args[:8]), *args[8:], method == 1,
        None if lane is None else lane.cpu())
    before = tvl1_patch_solve.launches
    got = solver_for(method)(sc, *args, lane=lane)
    assert tvl1_patch_solve.launches == before + 1
    for x, y, z in zip(got, want, cpu):
        assert _same_nan(x, y)
        assert _same_nan(x, z)
    if tol == "freeze":
        # one PD iteration a warp: the same as max_iters 1
        once = solver_for(method)(sc, *args[:-1], 1, lane=lane)
        for x, y in zip(got, once):
            assert _same_nan(x, y)


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("p,b", [(11, 1900), (3, 1703)])
def test_k12_mixed_freeze_on_card(dev, p, b, method, lanes):
    """K12 with a tol at the median of the first PD step's err, two warps
    of at most 4 steps: about half the canvases stop after one step while
    their neighbours in the same block (or warp group) run on; bit for bit
    against its twin on the card, and the split is checked."""
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, solver_for, tvl1_patch_solve,
    )

    sc = _k12_consts(dev, lanes, method, p=p)
    geo, u1, u2, lane = _k12_patches(sc, dev, p, b, lanes, 360 + p + b)
    one = _solve_tvl1_family_plain(sc, *geo, u1, u2, p, 1, 1, method == 1, lane)
    e1, e2 = one[0] - u1, one[1] - u2
    err = (e1 * e1 + e2 * e2).amax(dim=(1, 2))   # zero outside the box
    tol = float(err.median().sqrt())
    sc = sc._replace(tol=torch.full_like(sc.tol, tol))
    frozen = err <= sc.tol * sc.tol
    pairs = frozen[0:b - 1:2] != frozen[1:b:2]
    assert 0.25 * b < int(frozen.sum()) < 0.75 * b and bool(pairs.any())
    args = (*geo, u1, u2, p, 2, 4)
    want = _solve_tvl1_family_plain(sc, *args, method == 1, lane)
    before = tvl1_patch_solve.launches
    got = solver_for(method)(sc, *args, lane=lane)
    assert tvl1_patch_solve.launches == before + 1
    for x, y in zip(got, want):
        assert _same_nan(x, y)


@pytest.mark.parametrize("p,b", [(7, 61), (32, 3)])
def test_k12_other_sides_match_twin_on_card(dev, p, b):
    """K12 at sides compiled for no size: 7, and 32 (one 1024-thread canvas
    a block), method 1, bit for bit against its twin on the card."""
    from faldoi_tpu_torch.core.functionals import (
        _solve_tvl1_family_plain, tvl1_patch_solve,
    )

    sc = _k12_consts(dev, 1, 1, p=p)
    geo, u1, u2, _ = _k12_patches(sc, dev, p, b, 1, 340 + p)
    args = (*geo, u1, u2, p, 1, 4, True)
    got = tvl1_patch_solve(sc, *args)
    want = _solve_tvl1_family_plain(sc, *args)
    for x, y in zip(got, want):
        assert _same_nan(x, y)


@pytest.fixture(scope="module")
def patch_variants_lib():
    """The former forms of K12 and K13 and the redesign's variants
    (``csrc/variants/patch_variants.cu``), built once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from faldoi_tpu_torch.cli.patch_variants import build_variants

    return build_variants()[0]


@pytest.mark.parametrize("exact", [False, True], ids=["red-black", "exact"])
@pytest.mark.parametrize("p,b,n", [(11, 577, 2), (11, 33, 1), (3, 1703, 2),
                                   (7, 5, 2)])
def test_k13_former_form_matches_library_on_card(dev, patch_variants_lib, p, b,
                                                 n, exact):
    """Every K13 form of ``cli/patch_variants.py`` (the former, the library's,
    the row in registers, without the register bound) equals the library's
    ``poisson_fill_planes`` bit for bit, one and two planes."""
    from faldoi_tpu_torch.cli.patch_variants import K13_VARIANTS, k13_variant
    from faldoi_tpu_torch.ops.poisson import poisson_fill_planes

    rng = np.random.default_rng(370 + p + b)
    planes, (ph, pw) = _fill_canvases(rng, b, p)
    planes = tuple(t.to(dev) for t in planes[:n])
    ph, pw = ph.to(dev), pw.to(dev)
    want = poisson_fill_planes(planes, ph, pw, exact=exact)
    for v, name in K13_VARIANTS.items():
        got = k13_variant(patch_variants_lib, v, planes, ph, pw, exact)
        assert all(_same_nan(x, y) for x, y in zip(got, want)), name


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("p,b", [(11, 297), (3, 61)])
def test_k12_former_form_matches_library_on_card(dev, patch_variants_lib, p, b,
                                                 method, lanes):
    """Every bit-equal K12 form of ``cli/patch_variants.py`` (the former, the
    block, named-barrier and warp layouts at each launch bound) equals the
    library's ``tvl1_patch_solve`` bit for bit, two warps of at most 4 PD
    steps."""
    from faldoi_tpu_torch.cli.patch_variants import FAST, K12_VARIANTS, k12_variant
    from faldoi_tpu_torch.core.functionals import tvl1_patch_solve

    sc = _k12_consts(dev, lanes, method, p=p)
    geo, u1, u2, lane = _k12_patches(sc, dev, p, b, lanes, 380 + p + b)
    args = (sc, *geo, u1, u2, p, 2, 4, method == 1, lane)
    want = tvl1_patch_solve(*args)
    for v, (name, *_, mode) in K12_VARIANTS.items():
        if mode == FAST:   # approximate divisions and root: timing only
            continue
        got = k12_variant(patch_variants_lib, v, args)
        assert all(_same_nan(x, y) for x, y in zip(got, want)), name


def test_k12_refuses_what_it_does_not_take_on_card(dev):
    from faldoi_tpu_torch.core.functionals import tvl1_patch_solve

    sc = _k12_consts(dev, 1, 0)
    geo, u1, u2, _ = _k12_patches(sc, dev, 11, 16, 1, 350)
    before = tvl1_patch_solve.launches

    def solve(*args, **kw):
        return tvl1_patch_solve(sc if "sc" not in kw else kw.pop("sc"), *args,
                                **kw)

    with pytest.raises(TypeError):
        solve(*geo, u1.double(), u2.double(), 11, 1, 4, False)
    with pytest.raises(TypeError):
        solve(*geo[:4], geo[4].float(), geo[5], u1, u2, 11, 1, 4, False)
    with pytest.raises(ValueError):
        solve(*geo, u1[:8], u2[:8], 11, 1, 4, False)
    with pytest.raises(ValueError):
        solve(*geo, u1, u2[:, :10, :10], 11, 1, 4, False)
    with pytest.raises(ValueError):
        solve(*geo[:5], geo[5][:8], u1, u2, 11, 1, 4, False)
    with pytest.raises(ValueError):     # method 1 without its window
        solve(*geo, u1, u2, 11, 1, 4, True)
    with pytest.raises(ValueError):     # a lane index with one lane's consts
        solve(*geo, u1, u2, 11, 1, 4, False,
              lane=torch.zeros(16, dtype=torch.int64, device=dev))
    big = torch.zeros((16, 33, 33), device=dev)
    with pytest.raises(ValueError):
        solve(*geo, big, big, 33, 1, 4, False)
    assert tvl1_patch_solve.launches == before


# --- K2 (candidate selection) and K3 (payload scatters) ------------------

NEG_NAN_BITS = -4194304          # 0xFFC00000: x86's default NaN


def _key_planes(rng, nl, n, case):
    """Lane-stacked (L, n + 1) cand_e / fixed / ene planes for a case."""
    cand = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0, 0.0]), (nl, n + 1))
    fixed = rng.random((nl, n + 1)) < 0.3
    ene = rng.choice(np.float32([0.2, 0.6, 1.2, np.inf]), (nl, n + 1))
    if case == "adversarial":
        cand[:, 1::3] = -0.0
        cand[:, 2::7] = np.inf
        cand[:, 3::11] = -np.inf
        cand[:, 5::13] = np.nan
        neg = np.zeros((nl, n + 1), bool)
        neg[:, 7::17] = True
        cand[neg] = np.int32(NEG_NAN_BITS).view(np.float32)
    elif case == "all_inf":
        cand[:] = np.inf
    elif case == "distinct":
        cand = rng.standard_normal((nl, n + 1)).astype(np.float32)
    return cand.astype(np.float32), fixed, ene.astype(np.float32)


@pytest.mark.parametrize("shape,nl,bsz,case,relax", [
    ((5, 7), 1, 1, "adversarial", False),
    ((5, 7), 2, 1024, "adversarial", False),
    ((40, 56), 1, 1024, "adversarial", True),
    ((40, 56), 2, 1024, "all_inf", False),
    ((40, 56), 8, 1024, "distinct", False),
    ((40, 56), 2, 1, "distinct", True),
    ((436, 1024), 2, 8192, "adversarial", False),
    ((436, 1024), 1, 8192, "exact_bsz", False),
    ((436, 1024), 8, 8192, "distinct", False),
    ((436, 1024), 2, 8192, "distinct", True),
    ((40, 56), 66, 1024, "distinct", False),
    ((40, 56), 130, 2240, "adversarial", False),
])
def test_k2_matches_twin_on_card(dev, shape, nl, bsz, case, relax):
    """K2's select and accept against their twins, bit for bit: e_pop (bits),
    idx, queue, band, floor, valid, order, counts, total; with a lane subset
    and owned rows on the adversarial cases, a modes' mask and band_min."""
    from faldoi_tpu_torch.ops.select import (
        accept, accept_plain, select, select_plain,
    )

    h, w = shape
    n = h * w
    rng = np.random.default_rng(h * nl + bsz)
    cand, fixed, ene = _key_planes(rng, nl, n, "distinct" if case == "exact_bsz"
                                   else case)
    if case == "exact_bsz":
        # exactly bsz finite keys
        cand[:] = np.inf
        fixed[:] = False
        cand[0, rng.choice(n, bsz, replace=False)] = rng.random(bsz)
    args = [torch.as_tensor(x) for x in (cand, fixed, ene)]
    extras = [dict()]
    if case == "adversarial" and nl > 1:
        extras.append(dict(lanes=torch.tensor([nl - 1, 0]),
                           owned=torch.as_tensor(rng.random(n) < 0.7)))
    before = select.launches, accept.launches
    for kw in extras:
        want = select_plain(*args, n, bsz, relax, **kw)
        got = select(*(a.to(dev) for a in args), n, bsz, relax,
                     **{k: v.to(dev) for k, v in kw.items()})
        torch.cuda.synchronize()
        assert torch.equal(_bits(got[0].cpu()), _bits(want[0]))
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu(), want[2])
        for akw in (dict(), dict(band_min=want[0][:, :1] + 0.5),
                    dict(valid=torch.as_tensor(rng.random(want[0].shape) < 0.5))):
            wa = accept_plain(want[0], want[2], 0.05, 0.5, 40, 16, 4, 300,
                              **akw)
            ga = accept(got[0], got[2], 0.05, 0.5, 40, 16, 4, 300,
                        **{k: v.to(dev) for k, v in akw.items()})
            for name, x, y in zip(ga._fields, ga, wa):
                x = x.cpu()
                if name == "band":
                    assert torch.equal(x.isnan(), y.isnan()), name
                    assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)), name
                else:
                    assert torch.equal(x.reshape(y.shape), y), name
    assert (select.launches - before[0], accept.launches - before[1]) == (
        len(extras), 3 * len(extras))


def _nan_bits(x):
    """A float tensor's bits with NaN as one pattern (the card's canonical
    NaN and the CPU's may carry other payloads)."""
    return torch.where(x.isnan(), torch.full_like(x, float("nan")), x).view(torch.int32)


@pytest.mark.parametrize("n,m,nan,chi", [(60, 500, False, False),
                                         (60, 500, True, True),
                                         (4000, 40000, True, False),
                                         (446465, 32768, False, True),
                                         (446465, 1, True, False)])
def test_k3_generic_matches_twin_on_card(dev, n, m, nan, chi):
    """K3's generic form, min and max, against its twin: collisions, ties
    within the batch and with the target, signed zeros, NaN keys, masked
    updates, the chi payload, a position order; bit for bit off the dump
    slot, NaN by mask."""
    from faldoi_tpu_torch.ops.scatter import (
        scatter_max_payload, scatter_max_payload_plain, scatter_min_payload,
        scatter_min_payload_plain, scatter_payload,
    )

    rng = np.random.default_rng(n + m)
    q = torch.as_tensor(rng.integers(0, min(n, 3 * m), m))
    e = torch.as_tensor(rng.choice(np.float32([0.5, 1.0, 0.0, -0.0, 2.0]), m))
    if nan:
        e[::37] = float("nan")
    u, v, c = (torch.as_tensor(rng.standard_normal(m).astype(np.float32))
               for _ in range(3))
    ok = torch.as_tensor(rng.random(m) < 0.7)
    pos = torch.as_tensor(rng.permutation(m))
    tgt = [torch.as_tensor(rng.choice(np.float32([0.75, 1.0, 0.0, -0.0, np.inf]),
                                      n + 1))]
    if nan:
        tgt[0][3::11] = float("nan")
    tgt += [torch.as_tensor(rng.standard_normal(n + 1).astype(np.float32))
            for _ in range(3)]
    kw = dict(tgt_c=tgt[3], c=c) if chi else {}
    before = scatter_payload.launches
    calls = 0
    for port, twin, t0 in ((scatter_min_payload, scatter_min_payload_plain,
                            tgt[0]),
                           (scatter_max_payload, scatter_max_payload_plain,
                            torch.where(tgt[0].isinf(), -tgt[0], tgt[0]))):
        for p_ in (None, pos):
            want = twin(t0, tgt[1], tgt[2], q, e, u, v, ok, n, p_, **kw)
            got = port(t0.to(dev), tgt[1].to(dev), tgt[2].to(dev), q.to(dev),
                       e.to(dev), u.to(dev), v.to(dev), ok.to(dev), n,
                       None if p_ is None else p_.to(dev),
                       **{k: x.to(dev) for k, x in kw.items()})
            calls += 1
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert torch.equal(_nan_bits(x.cpu()[:n]), _nan_bits(y[:n]))
    assert scatter_payload.launches - before == calls


@pytest.mark.parametrize("h,w,k,p,lanes,chi", [(436, 1024, 16384, 11, 2, False),
                                               (436, 1024, 8192, 11, 1, True),
                                               (40, 56, 1703, 3, 1, False),
                                               (40, 56, 300, 11, 8, False),
                                               (5, 7, 1, 11, 1, True)])
def test_k3_wflow_matches_twin_on_card(dev, h, w, k, p, lanes, chi):
    """K3's working-flow form against its twin: overlapping boxes at the
    image's edges, masked patches, tied and NaN energies, lane bases; the
    key plane and the payloads bit for bit off the dump slots."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.scatter import wflow_scatter, wflow_scatter_plain
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    rng = np.random.default_rng(h + k + lanes)
    n, wr = h * w, p // 2
    pix = torch.as_tensor(rng.integers(0, n, k))
    _, _, oy, ox, ph, pw = patch_geometry(pix, h, w, wr)
    rows, cols = canvas_ids(p, "cpu")
    inbox = ((rows < ph[:, None, None]) & (cols < pw[:, None, None])
             & torch.as_tensor(rng.random(k) < 0.8)[:, None, None])
    ener = torch.as_tensor(rng.choice(np.float32([0.5, 1.0, 2.0, np.nan]), k,
                                      p=[0.4, 0.3, 0.29, 0.01]))
    su, sv, schi = (torch.as_tensor(rng.standard_normal((k, p, p)).astype(np.float32))
                    for _ in range(3))
    planes = [torch.as_tensor(rng.standard_normal(lanes * (n + 1)).astype(np.float32))
              for _ in range(3)]
    base = (torch.as_tensor(rng.integers(0, lanes, k)) * (n + 1)
            if lanes > 1 else None)
    args = (*planes, su, sv, schi if chi else None, ener, oy, ox, inbox, h, w, p)
    want = wflow_scatter_plain(*args, base)
    cuda = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    got = wflow_scatter(*cuda, None if base is None else base.to(dev))
    off_dump = torch.ones(lanes * (n + 1), dtype=torch.bool)
    off_dump[n::n + 1] = False
    for x, y in zip(got, want):
        assert torch.equal(_nan_bits(x.cpu()[off_dump]), _nan_bits(y[off_dump]))


def _static_lanes(d, h, w, method, copies=1):
    """Two m0 / m1 lanes (fwd, bwd) of a synthetic pair, seeded, with their
    stacked consts and saliency; ``copies`` times over (2 * copies lanes,
    as pairs mode stacks them)."""
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, stack_states,
    )
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(h, w, seed=220)
    a, b = prepare_pair(i0, i1, device=d)
    rng = np.random.default_rng(221)
    scs, sts = [], []
    for src, dst, g, cnt in ((a, b, gf, 60), (b, a, gb, 45)):
        sc = make_solver_consts(src, dst, 40.0, 0.3, 0.125, 0.01, 11, method)
        seeds = syn.make_seeds(g, syn.random_seed_positions(h, w, cnt, rng), rng)
        scs.append(sc)
        sts.append(insert_seeds(init_state(h, w, d), seeds, sc,
                                torch.ones(h * w + 1, device=d), 1, 4,
                                method=method))
    return (stack_solver_consts(scs * copies), stack_states(sts * copies),
            torch.ones((2 * copies, h * w + 1), device=d))


@pytest.mark.parametrize("method", [0, 1])
def test_static_sweep_and_drain_on_card_match_cpu(dev, method):
    """The drains' fixed-shape sweep and drain on the 96x128 crop, on the
    card against the CPU: the sweep (under sync debug mode "error": no host
    read) and a whole drain of both lanes, bit for bit off the dump slots,
    the counts and each lane's sweeps; K2's two entry points launch once a
    sweep, K3's generic form three times (candidates, donations, centre)
    and its working-flow form once."""
    from faldoi_tpu_torch.core import local_step
    from faldoi_tpu_torch.ops.scatter import scatter_payload, wflow_scatter
    from faldoi_tpu_torch.ops.select import accept, select

    h, w = 96, 128
    n = h * w
    out = {}
    for d in ("cpu", dev):
        sc, st, sal = _static_lanes(d, h, w, method)
        tr = torch.ones((2, h, w), device=d)
        if d != "cpu":
            counters = (select, accept, scatter_payload, wflow_scatter)
            before = [f.launches for f in counters]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            one, counts = local_step.sweep_static(st, sc, tr, sal, 0, h, w, 5,
                                                  8192, 1, 4, 64, method)
        finally:
            if d != "cpu":
                torch.cuda.set_sync_debug_mode("default")
        if d != "cpu":
            assert [f.launches - b for f, b in zip(counters, before)] == [
                1, 1, 3, 1]
        drained, sweeps = local_step.drain_lanes(st, sc, tr, sal, 0, h, w, 5,
                                                 8192, 1, 4, 64, method)
        out[d] = (one, counts.cpu(), drained, sweeps)
    (c1, cc, cd, cs), (g1, gc, gd, gs) = out["cpu"], out[dev]
    assert torch.equal(gc, cc) and gs == cs and int(cc.sum()) > 0
    for a, b in ((g1, c1), (gd, cd)):
        for x, y in zip(a, b):
            x, y = x[:, :n].cpu(), y[:, :n]
            if x.dtype == torch.float32:
                x, y = _nan_bits(x), _nan_bits(y)
            assert torch.equal(x, y)


def test_static_sweep_on_card_takes_66_lanes(dev):
    """The fixed-shape sweep and drain at 66 lanes (pairs mode at N 33) on
    a 30x40 crop, on the card against the CPU, bit for bit off the dump
    slots: K2's acceptance takes any number of lanes."""
    from faldoi_tpu_torch.core import local_step

    h, w = 30, 40
    n = h * w
    out = {}
    for d in ("cpu", dev):
        sc, st, sal = _static_lanes(d, h, w, 0, copies=33)
        tr = torch.ones((66, h, w), device=d)
        one, counts = local_step.sweep_static(st, sc, tr, sal, 0, h, w, 5, 64,
                                              1, 4, 64, 0)
        drained, sweeps = local_step.drain_lanes(st, sc, tr, sal, 0, h, w, 5,
                                                 64, 1, 4, 64, 0)
        out[d] = (one, counts.cpu(), drained, sweeps)
    (c1, cc, cd, cs), (g1, gc, gd, gs) = out["cpu"], out[dev]
    assert torch.equal(gc, cc) and gs == cs and int(cc.sum()) > 0
    for a, b in ((g1, c1), (gd, cd)):
        for x, y in zip(a, b):
            x, y = x[:, :n].cpu(), y[:, :n]
            if x.dtype == torch.float32:
                x, y = _nan_bits(x), _nan_bits(y)
            assert torch.equal(x, y)

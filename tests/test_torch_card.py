"""The hand-written CUDA kernels (K0, K4, K5) against their plain twins, on
the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip on a
host without one.  The file imports no JAX, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_card.py --noconftest -q

K0 must equal its twin bit for bit; K4 and K5 within 1e-5 abs (the kernels
are built with --fmad=false and contract exactly where the twins do, so the
usual difference is 0)."""

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


def test_k4_matches_twin_on_card(dev):
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample, bicubic_sample_plain

    rng = np.random.default_rng(11)
    planes = torch.as_tensor(rng.uniform(0, 1, (3, 50, 60)).astype(np.float32))
    uu, vv = _points(rng, 50, 60, 2000)
    for border_out in (True, False):
        want = bicubic_sample_plain(planes, uu, vv, border_out)
        got = bicubic_sample(planes.to(dev), uu.to(dev), vv.to(dev), border_out)
        assert (got.cpu() - want).abs().max().item() <= ATOL


def test_k5_matches_twin_on_card(dev):
    from faldoi_tpu_torch.core.global_step import (
        global_pd_iteration, global_pd_iteration_plain, tvl2_global,
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
    e_cpu, e_card = torch.empty(1), torch.empty(1, device=dev)
    l_t = float(np.float32(40.0) * np.float32(0.3))
    global_pd_iteration_plain(*cpu, e_cpu, l_t, 0.3, 0.125)
    global_pd_iteration(*card, e_card, l_t, 0.3, 0.125)
    for a, b in zip(card + [e_card], cpu + [e_cpu]):
        assert (a.cpu() - b).abs().max().item() <= ATOL

    i0, i1, gf, _ = syn.make_pair(h, w, seed=11, full_shape=(80, 100))
    a, b = prepare_pair(i0, i1, device="cpu")
    flow = torch.as_tensor(gf + rng.normal(0, 0.3, gf.shape).astype(np.float32))
    want = tvl2_global(a, b, flow[..., 0].contiguous(), flow[..., 1].contiguous(),
                       warps=2)
    got = tvl2_global(a.to(dev), b.to(dev), flow[..., 0].contiguous().to(dev),
                      flow[..., 1].contiguous().to(dev), warps=2)
    for x, y in zip(got, want):
        assert (x.cpu() - y).abs().max().item() <= ATOL


def test_wrappers_raise_on_bad_card_tensors(dev):
    """A CUDA tensor launches the kernel or raises; there is no fallback."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_sample
    from faldoi_tpu_torch.ops.patch_gather import gather_patches

    stack = torch.zeros((20, 20, 2), device=dev)
    oy = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="int32"):
        gather_patches(stack, oy, oy, 3)
    planes = torch.zeros((1, 8, 8), device=dev)
    uu = torch.zeros((4, 4), device=dev).t()        # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bicubic_sample(planes, uu, uu, True)

"""K4's flow form (``faldoi_tpu_torch.ops.bicubic.bicubic_warp_planes``), the
whole-image warp that forms its points ``(j + u, i + v)`` itself.

On the CPU the wrapper runs its plain twin, which must equal, bit for bit,
the composition it replaces on the paths (``warp_coords`` then the point
form's twin) and agree within 1e-5 abs with the JAX package's exact
per-point warp on the same seeded numpy inputs.  The kernel itself runs in
``tests/test_torch_card.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch.ops import bicubic as B

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

ATOL = 1e-5


def T(x):
    return torch.as_tensor(np.asarray(x))


def leaving_flow(rng, ny, nx):
    """A flow that leaves the domain on all four sides, with every sign
    combination of the sample point (the row stencil's sx quirk)."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    u = 3.0 * np.sin(xx / 5.0 + yy / 9.0) + rng.uniform(-1, 1, (ny, nx))
    v = 2.5 * np.cos(yy / 4.0 - xx / 11.0) + rng.uniform(-1, 1, (ny, nx))
    u[:, 0], u[:, -1] = -2.75, 3.5          # out to the left and the right
    v[0, :], v[-1, :] = -1.25, 4.5          # out above and below
    u[ny // 2, nx // 2], v[ny // 2, nx // 2] = -(nx + 9.0), ny + 7.0   # far out
    u, v = u.astype(np.float32), v.astype(np.float32)
    jj, ii = xx + u, yy + v
    assert (jj < 0).any() and (jj > nx - 1).any()
    assert (ii < 0).any() and (ii > ny - 1).any()
    return u, v


@pytest.mark.parametrize("border_out", [True, False])
@pytest.mark.parametrize("ny,nx", [(5, 7), (97, 131)])
def test_flow_form_twin_is_warp_coords_then_the_point_twin(ny, nx, border_out):
    from faldoi_tpu.ops.bicubic import bicubic_warp as jwarp

    rng = np.random.default_rng(70 + ny + border_out)
    planes = rng.uniform(0, 1, (3, ny, nx)).astype(np.float32)
    u, v = leaving_flow(rng, ny, nx)
    before = B.bicubic_warp_planes.launches
    got = B.bicubic_warp_planes(T(planes), T(u), T(v), border_out)
    assert B.bicubic_warp_planes.launches == before        # the CPU launches nothing
    assert got.shape == (3, ny, nx) and got.is_contiguous()
    uu, vv = B.warp_coords(T(u), T(v))
    want = B.bicubic_sample_plain(T(planes), uu, vv, border_out)
    assert torch.equal(got, want)
    for c in range(3):
        ref = jwarp(jnp.asarray(planes[c]), jnp.asarray(u), jnp.asarray(v),
                    border_out)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    if border_out:
        assert (got[:, 0, :] == 0).all() and (got[:, :, -1] == 0).all()


@pytest.mark.parametrize("c", [1, 2])
def test_callers_reach_the_flow_form_with_flows_where_they_lie(c):
    """``bicubic_warp_stack`` and ``bicubic_warp`` give the flow form's result,
    also for the halves of an (h, w, 2) flow (strided views, as the FB check
    passes them)."""
    rng = np.random.default_rng(80 + c)
    ny, nx = 23, 31
    planes = T(rng.uniform(0, 1, (c, ny, nx)).astype(np.float32))
    flow = T(np.stack(leaving_flow(rng, ny, nx), -1))
    u, v = flow[..., 0], flow[..., 1]
    assert not u.is_contiguous()
    want = B.bicubic_warp_planes_plain(planes, u.contiguous(), v.contiguous(), True)
    assert torch.equal(B.bicubic_warp_planes(planes, u, v, True), want)
    assert torch.equal(B.bicubic_warp_stack(planes, u, v, True), want)
    assert torch.equal(B.bicubic_warp(planes[0], u, v, True), want[0])


@pytest.mark.parametrize("fault", ["planes", "flow", "small"])
def test_flow_form_raises_on_what_it_does_not_take(fault):
    planes, u = torch.zeros((2, 8, 9)), torch.zeros((8, 9))
    if fault == "planes":
        planes = planes[0]
    elif fault == "flow":
        u = torch.zeros((9, 8))
    else:
        planes, u = torch.zeros((2, 3, 9)), torch.zeros((3, 9))
    with pytest.raises(ValueError):
        B.bicubic_warp_planes(planes, u, u, True)


def test_global_step_takes_the_warp_planes_as_they_come():
    """The warp's three planes are contiguous views, which the K5 loop takes
    without a copy; ``stats`` carries device times only on the card."""
    from faldoi_tpu_torch.core.global_step import GLOBAL_STAGES, tvl2_global

    rng = np.random.default_rng(90)
    ny, nx = 12, 17
    stack = T(rng.uniform(0, 1, (3, ny, nx)).astype(np.float32))
    u, v = (T(x) for x in leaving_flow(rng, ny, nx))
    for plane in B.bicubic_warp_stack(stack, u, v, True):
        assert plane.is_contiguous()
    stats = {}
    tvl2_global(stack[0], stack[1], u, v, warps=2, max_iters=3, stats=stats)
    assert stats["global_iters"] == [3, 3] and "global_ms" not in stats
    assert GLOBAL_STAGES == ("warp", "constants", "clones", "pd_loop")

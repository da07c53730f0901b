"""What the one-launch designs of K10 (the jump-flood dense fill,
``csrc/dense_fill.cu``) and K11 (the bilateral pre-fill,
``csrc/bilateral.cu``) rest on, held on the CPU:

* K10 keeps no distance buffer: it recomputes a cell's best squared
  distance from its seed in every direction.  A copy of the twin's flood
  loop that does the same gives the same seeds as the twin's loop, which
  carries the distance, and the same fill as ``nearest_fill_image_plain``,
  bit for bit, on the inputs where the direction order matters and on
  edge shapes; likewise with the kernel's packed (y << 16 | x) seeds.
* K11 reads 5 colour planes, not 25 weight planes: ``bilateral_weights``
  built from ``bilateral_colour_planes`` equals the former construction (an
  exponential a tap, kept as ``cli/fill_variants.former_weights``) bit for
  bit, on random frames and at h or w < 5, and stays within 1e-6 of JAX's
  weights there; the wrapper's CPU route on given colour planes equals its
  route without them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

FAR = -1.0e6


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sparse(shape, keep, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[np.broadcast_to(rng.random(shape[:1] + (1,) + shape[2:]) >= keep,
                      shape)] = np.nan
    return x


def _flood(x, carry: bool, packed: bool = False):
    """The twin's flood loop on (L, C, h, w) planes, returning the seeds as
    flat indices (-1: none).  ``carry``: the distance carried beside the
    seed, as the twin does; else recomputed from the seed every direction,
    as K10 does.  ``packed``: seeds held as y << 16 | x, as K10 holds them."""
    from faldoi_tpu_torch.ops.poisson import flood_strides

    nl, _, h, w = x.shape
    fin = torch.isfinite(x[:, 0])
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    ri, ci = torch.arange(h), torch.arange(w)
    if packed:
        cell = (ri[:, None] << 16) | ci[None, :]
    else:
        cell = torch.arange(h * w).view(h, w)
    seed = torch.where(fin, cell, -1)
    best = torch.where(fin, 0.0, float("inf"))

    def dist2(s):
        sy = (s >> 16) if packed else s // w
        sx = (s & 0xffff) if packed else s % w
        ey = yy - torch.where(s >= 0, sy.float(), torch.tensor(FAR))
        ex = xx - torch.where(s >= 0, sx.float(), torch.tensor(FAR))
        return ey * ey + ex * ex

    for k in flood_strides(h, w):
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                nb = (seed.index_select(1, (ri - dy).clamp(0, h - 1))
                      .index_select(2, (ci - dx).clamp(0, w - 1)))
                d2 = dist2(nb)
                better = d2 < (best if carry else dist2(seed))
                if carry:
                    best = torch.where(better, d2, best)
                seed = torch.where(better, nb, seed)
    if packed:
        seed = torch.where(seed >= 0, (seed >> 16) * w + (seed & 0xffff), -1)
    return seed


def _fill_from(x, seed):
    """The twin's take and relaxation from given flat seeds."""
    from faldoi_tpu_torch.ops.poisson import _rect_relax

    nl, c, h, w = x.shape
    fin = torch.isfinite(x[:, 0])
    take = x.reshape(nl, c, h * w).gather(
        2, seed.clamp(min=0).view(nl, 1, -1).expand(nl, c, -1))
    take = torch.where(seed.view(nl, 1, -1) >= 0, take, 0.0).view(nl, c, h, w)
    return _rect_relax(torch.where(fin[:, None], x, take), ~fin[:, None], 0.4, 6)


# the direction-order inputs of test_torch_fills.py and the card tests, and
# edge shapes: one row, one column, one cell, no finite cell, one, corners
FLOOD_CASES = [((1, 1, 5, 7), 0.15, 3), ((1, 1, 13, 17), 0.15, 0),
               ((2, 2, 30, 40), 0.1, 1), ((1, 2, 1, 300), 0.05, 2),
               ((2, 1, 300, 1), 0.05, 4), ((1, 1, 1, 1), 1.0, 5),
               ((1, 2, 9, 11), 0.0, 6), ((3, 2, 33, 45), 0.02, 7)]


@pytest.mark.parametrize("shape,keep,seed", FLOOD_CASES)
@pytest.mark.parametrize("packed", [False, True])
def test_flood_without_distance_buffer_gives_the_same_seeds(shape, keep, seed,
                                                            packed):
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image_plain

    x = torch.as_tensor(_sparse(shape, keep, seed))
    carried = _flood(x, carry=True)
    recomputed = _flood(x, carry=False, packed=packed)
    assert torch.equal(carried, recomputed)
    assert torch.equal(_bits(_fill_from(x, recomputed)),
                       _bits(nearest_fill_image_plain(x)))


def test_flood_without_distance_buffer_one_cell_and_corners():
    """One finite cell, and a finite cell in each corner only."""
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image_plain

    x = torch.full((2, 2, 37, 53), float("nan"))
    x[0, :, 17, 52] = torch.tensor([1.5, -2.0])
    for y, c in ((0, 0), (0, 52), (36, 0), (36, 52)):
        x[1, :, y, c] = torch.tensor([float(y), float(c)])
    seeds = _flood(x, carry=False, packed=True)
    assert torch.equal(seeds, _flood(x, carry=True))
    assert (seeds[0] == 17 * 53 + 52).all()
    assert torch.equal(_bits(_fill_from(x, seeds)),
                       _bits(nearest_fill_image_plain(x)))


@pytest.mark.parametrize("shape", [(29, 41), (4, 30), (30, 4), (1, 9), (9, 1),
                                   (2, 3), (1, 1)])
def test_bilateral_weights_from_colour_planes_equal_the_former_ones(shape):
    from faldoi_tpu_torch.cli.fill_variants import former_weights
    from faldoi_tpu_torch.core.bilateral import (
        bilateral_colour_planes, bilateral_weights,
    )

    rng = np.random.default_rng(sum(shape))
    i0 = torch.as_tensor(rng.random(shape).astype(np.float32))
    colour = bilateral_colour_planes(i0)
    assert colour.shape == (5,) + shape and colour.dtype == torch.float32
    want = former_weights(i0)
    assert torch.equal(_bits(bilateral_weights(i0)), _bits(want))
    assert torch.equal(_bits(bilateral_weights(i0, colour)), _bits(want))


@pytest.mark.parametrize("shape", [(4, 30), (30, 4), (1, 9), (3, 2)])
def test_bilateral_weights_match_jax_at_small_sides(shape):
    """As test_torch_fills.py's test_bilateral_weights_match_jax, where a
    side is shorter than the 5-tap window."""
    from faldoi_tpu.core import bilateral as jb
    from faldoi_tpu.params import SIGMA_BILATERAL_COLOR
    from faldoi_tpu_torch.core.bilateral import SHIFTS, SPATIAL, bilateral_weights

    rng = np.random.default_rng(149)
    i0 = rng.random(shape).astype(np.float32)
    got = bilateral_weights(torch.as_tensor(i0)).numpy()
    j0 = jnp.asarray(i0)
    for s, (dy, dx) in enumerate(SHIFTS):
        wcol = jnp.exp(-0.5 * ((j0 - jb._shift(j0, dy, dx))
                               / SIGMA_BILATERAL_COLOR) ** 2) * jb._inside(*shape, dy, dx)
        want = np.float32(SPATIAL[dy * dy + dx * dx]) * np.asarray(wcol)
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6)


def test_spatial_taps_follow_the_shift_order():
    from faldoi_tpu_torch.core.bilateral import SHIFTS, SPATIAL, spatial_taps

    taps = spatial_taps()
    assert taps.dtype == torch.float32 and taps.shape == (25,)
    for s, (dy, dx) in enumerate(SHIFTS):
        assert float(taps[s]) == SPATIAL[dy * dy + dx * dx]


def test_bilateral_wrapper_takes_colour_planes_on_the_cpu():
    from faldoi_tpu_torch.core.bilateral import (
        bilateral_colour_planes, bilateral_filter_flow,
    )

    rng = np.random.default_rng(150)
    i0 = torch.as_tensor(rng.random((19, 23)).astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(2, 2, 19, 23)).astype(np.float32))
    tr = torch.as_tensor((rng.random((2, 19, 23)) < 0.5).astype(np.int32))
    fx = torch.zeros_like(tr)
    got = bilateral_filter_flow(i0, u[0], u[1], tr, fx,
                                colour=bilateral_colour_planes(i0))
    want = bilateral_filter_flow(i0, u[0], u[1], tr, fx)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="colour"):
        bilateral_filter_flow(i0, u[0], u[1], tr, fx,
                              colour=torch.zeros((25, 19, 23)))

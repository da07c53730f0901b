"""The whole-image fills, the bilateral filter and the zoom of the port
against faldoi_tpu's: ``ops/poisson.py`` ``nearest_fill_image`` (K10's
twin), ``poisson_fill_image`` and ``poisson_fill_batch``;
``core/bilateral.py`` ``bilateral_filter_flow`` (K11's twin) and its frozen
spatial constants; ``ops/zoom.py``.  Tolerance 1e-5 abs in float32; the
spatial constants exactly.  The jump flood is also held against a one-pass
flood (all 8 neighbours from the state before the stride), which is a
different function: the per-direction order matters."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

ATOL = 1e-5


def sparse(shape, keep, seed):
    """Normal values with all but a ``keep`` share set to NaN."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= keep] = np.nan
    return x


def one_pass_flood(x):
    """The jump flood as a one-pass JFA: each stride's 8 neighbours read
    from the state before the stride (the first strictly nearer wins), then
    the port's take and relaxation.  x: (L, C, h, w)."""
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
    y = torch.where(fin[:, None], x, take)
    return _rect_relax(y, ~fin[:, None], 0.4, 6)


@pytest.mark.parametrize("shape,keep", [((30, 40), 0.1), ((33, 45), 0.02),
                                        ((5, 7), 0.3), ((1, 9), 0.3),
                                        ((17, 1), 0.3), ((12, 20), 0.0)])
def test_nearest_fill_matches_jax(shape, keep):
    from faldoi_tpu.ops.poisson import nearest_fill_image as jfill
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    x = sparse(shape, keep, 141)
    got = nearest_fill_image(torch.as_tensor(x)).numpy()
    want = np.asarray(jfill(jnp.asarray(x)))
    assert got.shape == shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_nearest_fill_one_finite_cell():
    """A single finite cell: every cell takes its value before the
    relaxation, which keeps a constant field."""
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    x = np.full((21, 34), np.nan, np.float32)
    x[7, 30] = 2.5
    np.testing.assert_array_equal(nearest_fill_image(torch.as_tensor(x)).numpy(),
                                  np.full_like(x, 2.5))


def test_nearest_fill_lanes_and_planes():
    """(L, C, h, w): every plane equals its own JAX fill; the planes of a
    lane must share their finite cells."""
    from faldoi_tpu.ops.poisson import nearest_fill_image as jfill
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    rng = np.random.default_rng(142)
    x = rng.normal(size=(3, 2, 26, 37)).astype(np.float32)
    holes = rng.random((3, 1, 26, 37)) > 0.08
    x[np.broadcast_to(holes, x.shape)] = np.nan
    got = nearest_fill_image(torch.as_tensor(x)).numpy()
    for lane in range(3):
        for c in range(2):
            np.testing.assert_allclose(got[lane, c],
                                       np.asarray(jfill(jnp.asarray(x[lane, c]))),
                                       rtol=0, atol=ATOL)
    x[1, 1, 3, 4] = np.nan if np.isfinite(x[1, 1, 3, 4]) else 1.0
    with pytest.raises(ValueError, match="same"):
        nearest_fill_image(torch.as_tensor(x))


@pytest.mark.parametrize("shape,seed", [((5, 7), 3), ((13, 17), 0)])
def test_nearest_fill_keeps_the_direction_order(shape, seed):
    """Inputs where a one-pass flood picks other nearest cells: the port
    equals JAX and not the one-pass flood."""
    from faldoi_tpu.ops.poisson import nearest_fill_image as jfill
    from faldoi_tpu_torch.ops.poisson import nearest_fill_image

    x = sparse((1, 1) + shape, 0.15, seed)
    got = nearest_fill_image(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy()[0, 0],
                               np.asarray(jfill(jnp.asarray(x[0, 0]))),
                               rtol=0, atol=ATOL)
    assert not torch.equal(got, one_pass_flood(torch.as_tensor(x)))


@pytest.mark.parametrize("shape,keep,scale", [((30, 40), 0.05, 0),
                                              ((33, 45), 0.2, 0),
                                              ((7, 3), 0.3, 0),
                                              ((30, 40), 0.05, 3)])
def test_poisson_fill_image_matches_jax(shape, keep, scale):
    from faldoi_tpu.ops.poisson import poisson_fill_image as jfill
    from faldoi_tpu_torch.ops.poisson import poisson_fill_image

    x = sparse(shape, keep, 143)
    got = poisson_fill_image(torch.as_tensor(x), scale=scale).numpy()
    want = np.asarray(jfill(jnp.asarray(x), scale=scale))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("exact", [True, False])
def test_poisson_fill_batch_matches_jax(exact):
    from faldoi_tpu.ops.poisson import poisson_fill_batch as jfill
    from faldoi_tpu_torch.ops.poisson import poisson_fill_batch

    rng = np.random.default_rng(144)
    x = sparse((9, 11, 11), 0.2, 145)
    ph = rng.integers(1, 12, 9).astype(np.int32)
    pw = rng.integers(1, 12, 9).astype(np.int32)
    got = poisson_fill_batch(torch.as_tensor(x), torch.as_tensor(ph),
                             torch.as_tensor(pw), exact=exact).numpy()
    want = np.asarray(jfill(jnp.asarray(x), jnp.asarray(ph), jnp.asarray(pw),
                            exact=exact))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bilateral_spatial_constants_are_jax():
    """The frozen spatial constants equal JAX's float32 exponentials bit for
    bit, one for each squared tap distance of the 5x5 window."""
    from faldoi_tpu.params import SIGMA_BILATERAL_DIST
    from faldoi_tpu_torch.core.bilateral import SHIFTS, SPATIAL

    assert len(SHIFTS) == 25
    assert sorted(SPATIAL) == sorted({dy * dy + dx * dx for dy, dx in SHIFTS})
    for d2, v in SPATIAL.items():
        want = np.float32(jnp.float32(jnp.exp(-0.5 * d2 / SIGMA_BILATERAL_DIST ** 2)))
        assert np.float32(v) == want and float(np.float32(v)) == v


def test_bilateral_weights_match_jax():
    """The 25 weight planes against JAX's spatial constant times its colour
    weight (its ``_shift`` and ``_inside``)."""
    from faldoi_tpu.core import bilateral as jb
    from faldoi_tpu.params import SIGMA_BILATERAL_COLOR
    from faldoi_tpu_torch.core.bilateral import SHIFTS, SPATIAL, bilateral_weights

    rng = np.random.default_rng(146)
    i0 = rng.random((29, 41)).astype(np.float32)
    got = bilateral_weights(torch.as_tensor(i0)).numpy()
    j0 = jnp.asarray(i0)
    for s, (dy, dx) in enumerate(SHIFTS):
        wcol = jnp.exp(-0.5 * ((j0 - jb._shift(j0, dy, dx))
                               / SIGMA_BILATERAL_COLOR) ** 2) * jb._inside(29, 41, dy, dx)
        want = np.float32(SPATIAL[dy * dy + dx * dx]) * np.asarray(wcol)
        np.testing.assert_allclose(got[s], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,trusted", [((30, 40), 0.5), ((37, 53), 0.9),
                                           ((6, 5), 0.3)])
def test_bilateral_matches_jax(shape, trusted):
    from faldoi_tpu.core.bilateral import bilateral_filter_flow as jfilter
    from faldoi_tpu_torch.core.bilateral import bilateral_filter_flow

    rng = np.random.default_rng(147)
    i0 = rng.random(shape).astype(np.float32)
    u1 = rng.normal(size=shape).astype(np.float32) * 3
    u2 = rng.normal(size=shape).astype(np.float32) * 3
    tr = (rng.random(shape) < trusted).astype(np.int32)
    fx = (rng.random(shape) < 0.1).astype(np.int32)
    want = jfilter(*(jnp.asarray(a) for a in (i0, u1, u2, tr, fx)))
    got = bilateral_filter_flow(*(torch.as_tensor(a) for a in (i0, u1, u2, tr, fx)))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0, atol=ATOL)
        assert not np.array_equal(g.numpy(), u1)


def test_bilateral_lanes_equal_one_lane_calls():
    """Two lanes of one frame in one call: each lane bit for bit its own
    call (the growing filters a pair's fwd and bwd lanes together)."""
    from faldoi_tpu_torch.core.bilateral import bilateral_filter_flow

    rng = np.random.default_rng(148)
    i0 = torch.as_tensor(rng.random((23, 31)).astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(2, 2, 23, 31)).astype(np.float32))
    tr = torch.as_tensor((rng.random((2, 23, 31)) < 0.6).astype(np.int32))
    fx = torch.zeros_like(tr)
    both = bilateral_filter_flow(i0, u[0], u[1], tr, fx)
    for lane in range(2):
        one = bilateral_filter_flow(i0, u[0, lane], u[1, lane], tr[lane], fx[lane])
        for a, b in zip(both, one):
            assert torch.equal(a[lane], b)


@pytest.mark.parametrize("shape,factor", [((30, 40), 0.5), ((41, 57), 0.7),
                                          ((36, 36), 0.25)])
def test_zoom_out_matches_jax(shape, factor):
    from faldoi_tpu.ops.zoom import zoom_out as jzoom
    from faldoi_tpu_torch.ops.zoom import zoom_out, zoom_size

    img = np.random.default_rng(149).random(shape).astype(np.float32)
    got = zoom_out(torch.as_tensor(img), factor).numpy()
    assert got.shape == (zoom_size(shape[0], factor), zoom_size(shape[1], factor))
    np.testing.assert_allclose(got, np.asarray(jzoom(jnp.asarray(img), factor)),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,target", [((30, 40), (61, 77)),
                                          ((12, 9), (24, 18)),
                                          ((20, 25), (13, 31))])
def test_zoom_in_matches_jax(shape, target):
    from faldoi_tpu.ops.zoom import zoom_in as jzoom
    from faldoi_tpu_torch.ops.zoom import zoom_in

    img = np.random.default_rng(150).random(shape).astype(np.float32)
    got = zoom_in(torch.as_tensor(img), *target).numpy()
    np.testing.assert_allclose(got, np.asarray(jzoom(jnp.asarray(img), *target)),
                               rtol=0, atol=ATOL)


def test_zoom_size_rounds_to_nearest():
    from faldoi_tpu.ops.zoom import zoom_size as jsize
    from faldoi_tpu_torch.ops.zoom import zoom_size

    for n in (1, 7, 436, 1024):
        for f in (0.25, 0.5, 0.75, 1 / 3, math.sqrt(0.5)):
            assert zoom_size(n, f) == jsize(n, f)

"""The port's global step and FB pruning against faldoi_tpu's.

``tvl2_global`` (K5's twin inside, K4's twin for the warps) at 40x56 with two
warps, one PD iteration of K5's twin, K5's loop twin against JAX's loop rule,
``fb_consistency_check`` and ``prune``:
the same numpy inputs through JAX and the port on ``device="cpu"``, float32
agreement within 1e-5 abs, trust masks equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

ATOL = 1e-5
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 40, 56


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


@pytest.fixture(scope="module")
def frames():
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, gf, gb = syn.make_pair(H, W, seed=11, full_shape=(80, 100))
    a, b = prepare_pair(i0, i1, device="cpu")
    rng = np.random.default_rng(12)
    # a plausible flow: the known one, blurred at the layer edge, plus noise
    flow = gf + rng.normal(0, 0.3, gf.shape).astype(np.float32)
    return a.numpy(), b.numpy(), flow.astype(np.float32), gb


def test_tvl2_global_matches_jax(frames):
    from faldoi_tpu.core.global_step import tvl2_global as jglobal
    from faldoi_tpu_torch.core.global_step import tvl2_global

    a, b, flow, _ = frames
    stats = {}
    u1, u2 = tvl2_global(T(a), T(b), T(flow[..., 0]), T(flow[..., 1]),
                         warps=2, stats=stats)
    j1, j2 = jglobal(jnp.asarray(a), jnp.asarray(b), jnp.asarray(flow[..., 0]),
                     jnp.asarray(flow[..., 1]), warps=2)
    assert len(stats["global_iters"]) == 2
    close(u1, j1)
    close(u2, j2)


def test_global_pd_iteration_twin_matches_jax_body(frames):
    """One K5 iteration (its plain twin) from a non-trivial state against the
    JAX loop body's arithmetic."""
    from faldoi_tpu.core import pd_common as J
    from faldoi_tpu.ops import stencils as JS
    from faldoi_tpu_torch.core.global_step import global_pd_iteration_plain

    a, b, flow, _ = frames
    rng = np.random.default_rng(13)
    st = [flow[..., 0], flow[..., 1],
          flow[..., 0] + rng.normal(0, 0.1, (H, W)),
          flow[..., 1] + rng.normal(0, 0.1, (H, W))]
    st += [rng.uniform(-0.9, 0.9, (H, W)) for _ in range(4)]
    consts = [rng.normal(0, 0.3, (H, W)), rng.normal(0, 0.3, (H, W))]
    consts.append(consts[0] ** 2 + consts[1] ** 2)
    consts.append(rng.normal(0, 0.5, (H, W)))
    st = [np.asarray(x, np.float32) for x in st]
    consts = [np.asarray(x, np.float32) for x in consts]
    l_t = np.float32(40.0) * np.float32(0.3)
    theta, tau = np.float32(0.3), np.float32(0.125)

    tst = [T(x).clone() for x in st]
    err = torch.empty(1)
    global_pd_iteration_plain(*tst, *map(T, consts), err, float(l_t),
                              float(theta), float(tau))

    u1, u2, u1_, u2_, x11, x12, x21, x22 = map(jnp.asarray, st)
    i1wx, i1wy, grad, rho_c = map(jnp.asarray, consts)
    v1, v2 = J.tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, l_t)
    u1x, u1y = JS.forward_gradient(u1_)
    u2x, u2y = JS.forward_gradient(u2_)
    x11, x12, x21, x22 = J.tvl2_getD(x11, x12, x21, x22, u1x, u1y, u2x, u2y, tau)
    nu1, nu2, u_n = J.tvl2_getP(u1, u2, v1, v2, JS.divergence(x11, x12),
                                JS.divergence(x21, x22), theta, tau)
    want = [nu1, nu2, 2.0 * nu1 - u1, 2.0 * nu2 - u2, x11, x12, x21, x22]
    for got, ref in zip(tst, want):
        close(got, ref)
    close(err[0], jnp.max(u_n))


def _warp_state(frames, seed):
    """A warp's PD state and constants, as ``tvl2_global`` builds them."""
    from faldoi_tpu_torch.core.pd_common import warp_constants
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    a, b, flow, _ = frames
    rng = np.random.default_rng(seed)
    u1 = T(flow[..., 0] + rng.normal(0, 0.5, (H, W)).astype(np.float32))
    u2 = T(flow[..., 1] + rng.normal(0, 0.5, (H, W)).astype(np.float32))
    i1x, i1y = centered_gradient(T(b))
    i1w, i1wx, i1wy = bicubic_warp_stack(torch.stack([T(b), i1x, i1y]), u1, u2,
                                         True)
    grad, rho_c = warp_constants(T(a), i1w, i1wx, i1wy, u1, u2)
    xi = [T(rng.uniform(-0.5, 0.5, (H, W)).astype(np.float32)) for _ in range(4)]
    return [u1, u2, u1.clone(), u2.clone(), *xi, i1wx.contiguous(),
            i1wy.contiguous(), grad, rho_c]


@pytest.mark.parametrize("tol,max_iters,nan", [
    (0.01, 400, False),      # stops at err <= tol^2
    (0.0, 9, False),         # runs to the cap
    (1e6, 400, False),       # one iteration (err starts at inf)
    (0.01, 400, True),       # a NaN err stops the loop
])
def test_global_pd_loop_twin_matches_jax_loop(frames, tol, max_iters, nan):
    """K5's loop (its twin on the CPU) equals the host loop of one-iteration
    twins that tvl2_global ran before (same count, same planes bit for bit),
    and JAX's while-loop rule on the JAX body (same count, planes within
    1e-5)."""
    from faldoi_tpu.core import pd_common as J
    from faldoi_tpu.ops import stencils as JS
    from faldoi_tpu_torch.core.global_step import (
        global_pd_iteration_plain, global_pd_loop,
    )

    st = _warp_state(frames, 15)
    if nan:
        st[9][7, 9] = float("nan")                      # i1wy
    l_t = float(np.float32(40.0) * np.float32(0.3))
    tol2 = float(np.float32(tol) * np.float32(tol))
    old = [x.clone() for x in st]
    err = torch.empty(1)
    e, n_old = float("inf"), 0
    while e > tol2 and n_old < max_iters:
        global_pd_iteration_plain(*old, err, l_t, 0.3, 0.125)
        e = float(err.item())
        n_old += 1
    n = global_pd_loop(*st, l_t, 0.3, 0.125, tol2, max_iters)
    assert n == n_old
    assert all(torch.equal(x.nan_to_num(9.0), y.nan_to_num(9.0))
               for x, y in zip(st, old))
    if nan:
        assert n == 1
    else:
        assert (n == 1) == (tol > 1) and (n == max_iters) == (tol == 0.0)

    # JAX's rule: while err > tol^2 and n < max_iters, on its loop body
    u1, u2, u1_, u2_, x11, x12, x21, x22, i1wx, i1wy, grad, rho_c = (
        jnp.asarray(x.numpy()) for x in _warp_state(frames, 15))
    if nan:
        i1wy = i1wy.at[7, 9].set(jnp.nan)
    theta, tau = np.float32(0.3), np.float32(0.125)
    je, jn = jnp.float32(jnp.inf), 0
    while bool(je > np.float32(tol2)) and jn < max_iters:
        v1, v2 = J.tvl1_threshold(u1, u2, rho_c, i1wx, i1wy, grad, np.float32(l_t))
        g = [*JS.forward_gradient(u1_), *JS.forward_gradient(u2_)]
        x11, x12, x21, x22 = J.tvl2_getD(x11, x12, x21, x22, *g, tau)
        nu1, nu2, u_n = J.tvl2_getP(u1, u2, v1, v2, JS.divergence(x11, x12),
                                    JS.divergence(x21, x22), theta, tau)
        je, jn = jnp.max(u_n), jn + 1
        u1_, u2_, u1, u2 = 2.0 * nu1 - u1, 2.0 * nu2 - u2, nu1, nu2
    assert jn == n
    if not nan:
        for got, ref_ in zip(st[:8], (u1, u2, u1_, u2_, x11, x12, x21, x22)):
            close(got, ref_)


def test_fb_check_and_prune_match_jax(frames):
    from faldoi_tpu.core.pruning import fb_consistency_check as jfb, prune as jprune
    from faldoi_tpu_torch.core.pruning import fb_consistency_check, prune

    a, b, flow, gb = frames
    rng = np.random.default_rng(14)
    bwd = gb + rng.normal(0, 0.4, gb.shape).astype(np.float32)
    bad = rng.random(gb.shape[:2]) < 0.1
    bwd[bad] += rng.uniform(-4, 4, (bad.sum(), 2)).astype(np.float32)
    bwd[0, 0] = np.nan                          # sanitized inside the check
    got = fb_consistency_check(T(flow[..., 0]), T(flow[..., 1]),
                               T(bwd[..., 0]), T(bwd[..., 1]), 2.0)
    want = jfb(jnp.asarray(flow[..., 0]), jnp.asarray(flow[..., 1]),
               jnp.asarray(bwd[..., 0]), jnp.asarray(bwd[..., 1]),
               jnp.float32(2.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.02 < 1 - got.numpy().mean() < 0.6
    bwd[0, 0] = 0.0
    for x, y in zip(prune(T(a), T(b), T(flow), T(bwd), 2.0),
                    jprune(jnp.asarray(a), jnp.asarray(b), jnp.asarray(flow),
                           jnp.asarray(bwd), jnp.float32(2.0))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_global_refine_dispatch(frames):
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.models import global_refine

    a, b, flow, _ = frames
    prm = P.init_params(None, P.GLOBAL_STEP)
    prm.warps = 1
    u1, u2, chi = global_refine(P.M_TVL1, T(a), T(b), T(flow[..., 0]),
                                T(flow[..., 1]), prm)
    w1, w2 = tvl2_global(T(a), T(b), T(flow[..., 0]), T(flow[..., 1]), warps=1)
    assert torch.equal(u1, w1) and torch.equal(u2, w2) and chi is None
    with pytest.raises(ValueError, match="method 8 needs the frame I-1"):
        global_refine(P.M_TVL1_OCC, T(a), T(b), T(flow[..., 0]),
                      T(flow[..., 1]), prm)
    with pytest.raises(ValueError, match="unknown method 9"):
        global_refine(9, T(a), T(b), T(flow[..., 0]), T(flow[..., 1]), prm)

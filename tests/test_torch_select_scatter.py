"""The plain twins of the sweep's selection (K2, ``ops/select.py``) and
payload scatters (K3, ``ops/scatter.py``) against faldoi_tpu's, bit for bit.

K2: ``select`` and ``accept`` on CPU tensors against ``lax.top_k(-eligible,
bsz)`` with the band, queue and rank floor as ``_sweep_body``
(``faldoi_tpu/core/local_step.py:302-405``) computes them, on adversarial
key planes: ties, both zeros, +inf, NaN of both signs, fewer finite keys
than ``bsz``, the relax keys, the staged floor divisor, one and two lanes.
K3: the generic scatters against ``_scatter_min_payload`` /
``_scatter_max_payload(exact=True)``, and the working-flow form against the
scatter ``_sweep_body`` runs (its (p, p, B) layout and cell-major order),
with collisions, ties within a batch and with the target, NaN and signed
zero keys, dump slots and the chi payload.

Tolerance 0: selection and scatters are exact.  The key planes are compared
by value (a min over -0.0 and +0.0 may keep either sign: XLA keeps -0.0),
NaN by mask; indices, counts, masks and payloads exactly.  The JAX side runs
under the repo's exact dials (module-scoped environment)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
NEG_NAN = np.uint32(0xFFC00000).view(np.float32)   # x86's default NaN


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def T(x):
    return torch.as_tensor(np.asarray(x))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def same_values(a, b):
    """Equal as floats, NaN where NaN (either sign, any payload)."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a[~np.isnan(a)], b[~np.isnan(b)])


def key_planes(case, nl, n, rng):
    """(cand_e, fixed, ene) lane-stacked (L, n + 1) planes for ``case``."""
    cand = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (nl, n + 1))
    fixed = rng.random((nl, n + 1)) < 0.3
    ene = rng.choice(np.float32([0.2, 0.6, 1.2, np.inf]), (nl, n + 1))
    if case == "zeros":
        cand[:, ::3] = 0.0
        cand[:, 1::3] = -0.0
    elif case == "inf":
        cand[:, ::2] = np.inf
        cand[:, 1::7] = -np.inf
    elif case == "nan":
        cand[:, 5::11] = np.nan
        cand[:, 3::13] = NEG_NAN
        cand[:, 7::17] = -0.0
    elif case == "sparse":
        # fewer finite keys than bsz
        cand[:] = np.inf
        cand[:, rng.integers(0, n, 9)] = rng.standard_normal(9).astype(np.float32)
    elif case == "distinct":
        cand = rng.standard_normal((nl, n + 1)).astype(np.float32)
    return cand.astype(np.float32), fixed, ene.astype(np.float32)


def jax_selection(cand, fixed, ene, n, bsz, relax, delta, delta_rel, floor,
                  floor_scale, floor_scale_hi, queue_hi):
    """One lane's selection as ``_sweep_body`` writes it (its lines on
    jnp), returning (e_pop, idx, queue, band, floor_dyn, valid)."""
    from faldoi_tpu.core.local_step import RECLAIM_BIAS

    cand, fixed, ene = map(jnp.asarray, (cand, fixed, ene))
    if relax:
        improving = cand[:n] < ene[:n] * jnp.float32(0.95) - 1e-6
        key = jnp.where(fixed[:n], cand[:n] + RECLAIM_BIAS, cand[:n])
        eligible = jnp.where(improving, key, jnp.inf)
    else:
        eligible = jnp.where(fixed[:n], jnp.inf, cand[:n])
    neg_e, idx = jax.lax.top_k(-eligible, bsz)
    valid = jnp.isfinite(neg_e)
    e_pop = -neg_e
    rank = jnp.arange(bsz)
    e_min = e_pop[0]
    band = e_min + jnp.maximum(jnp.float32(delta), delta_rel * e_min)
    e_ok = e_pop <= band
    queue = jnp.isfinite(eligible).sum()
    floor_base = jnp.maximum(jnp.asarray(floor, jnp.int32), 1)
    fs_lo = jnp.maximum(jnp.asarray(floor_scale, jnp.int32), 1)
    fs_hi = jnp.asarray(floor_scale_hi, jnp.int32)
    q_hi = jnp.asarray(queue_hi, jnp.int32)
    fscale = jnp.where((fs_hi > 0) & (queue >= q_hi), fs_hi, fs_lo)
    floor_dyn = jnp.where(
        fscale > 1, jnp.minimum(floor_base, jnp.maximum(1, queue // fscale)),
        floor_base)
    valid = valid & (e_ok | (rank < floor_dyn))
    return tuple(np.asarray(x) for x in (e_pop, idx, queue, band, floor_dyn,
                                         valid))


SELECT_CASES = {
    # name: (key case, lanes, bsz, relax, floor, floor_scale, fs_hi, queue_hi)
    "ties_l1": ("ties", 1, 64, False, 4096, 64, 0, 1 << 30),
    "ties_l2_floor": ("ties", 2, 48, False, 20, 4, 0, 1 << 30),
    "zeros_l2": ("zeros", 2, 64, False, 4096, 16, 0, 1 << 30),
    "inf_l1": ("inf", 1, 80, False, 4096, 8, 0, 1 << 30),
    "nan_l2": ("nan", 2, 64, False, 4096, 8, 0, 1 << 30),
    "sparse_l2": ("sparse", 2, 32, False, 4096, 4, 0, 1 << 30),
    "relax_l2": ("ties", 2, 64, True, 64, 0, 0, 1 << 30),
    "staged_l2": ("distinct", 2, 96, False, 40, 64, 4, 200),
    "distinct_l1_all": ("distinct", 1, 300, False, 4096, 1, 0, 1 << 30),
}


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_and_accept_twins_match_jax(name):
    from faldoi_tpu_torch.ops.select import accept, select

    case, nl, bsz, relax, floor, fs, fs_hi, q_hi = SELECT_CASES[name]
    n = 300
    rng = np.random.default_rng(sum(map(ord, name)))
    cand, fixed, ene = key_planes(case, nl, n, rng)
    delta = float(np.float32(0.05))
    e_pop, idx, queue = select(T(cand), T(fixed), T(ene), n, bsz, relax)
    acc = accept(e_pop, queue, delta, 0.5, floor, fs, fs_hi, q_hi)
    want_order = []
    for lane in range(nl):
        je, ji, jq, jband, jfloor, jvalid = jax_selection(
            cand[lane], fixed[lane], ene[lane], n, bsz, relax, delta, 0.5,
            floor, fs, fs_hi, q_hi)
        np.testing.assert_array_equal(idx[lane].numpy(), ji)
        np.testing.assert_array_equal(bits(e_pop[lane].numpy()), bits(je))
        assert int(queue[lane]) == int(jq)
        same_values(acc.band[lane, 0].numpy(), jband)
        assert int(acc.floor_dyn[lane, 0]) == int(jfloor)
        np.testing.assert_array_equal(acc.valid[lane].numpy(), jvalid)
        assert int(acc.counts[lane]) == int(jvalid.sum())
        want_order += [lane * bsz + r for r in np.nonzero(jvalid)[0]]
    k = len(want_order)
    assert int(acc.total) == k
    np.testing.assert_array_equal(acc.order[:k].numpy(), want_order)
    rest = sorted(set(range(nl * bsz)) - set(want_order))
    np.testing.assert_array_equal(acc.order[k:].numpy(), rest)


def test_select_caps_the_batch_at_the_image():
    """bsz above h*w: the whole lane in order, as the sort's [:bsz] took it
    (lax.top_k refuses k > n)."""
    from faldoi_tpu_torch.ops.select import select, total_order

    rng = np.random.default_rng(3)
    cand, fixed, ene = key_planes("nan", 2, 40, rng)
    e_pop, idx, queue = select(T(cand), T(fixed), T(ene), 40, 100)
    assert tuple(idx.shape) == (2, 40)
    for lane in range(2):
        key = np.where(fixed[lane, :40], np.inf, cand[lane, :40]).astype(np.float32)
        words = total_order(T(key)).numpy()
        want = np.lexsort((np.arange(40), words))
        np.testing.assert_array_equal(idx[lane].numpy(), want)
        assert int(queue[lane]) == int(np.isfinite(key).sum())


def test_select_lane_subset_and_owned_rows():
    """The lanes given, in their order, and the owned mask."""
    from faldoi_tpu_torch.ops.select import keys_plain, select

    rng = np.random.default_rng(5)
    cand, fixed, ene = key_planes("ties", 3, 120, rng)
    owned = rng.random(120) < 0.6
    lanes = torch.tensor([2, 0])
    e_pop, idx, queue = select(T(cand), T(fixed), T(ene), 120, 50, False,
                               lanes, T(owned))
    keys = keys_plain(T(cand), T(fixed), T(ene), 120, False, lanes, T(owned))
    for k, lane in enumerate((2, 0)):
        key = np.where(fixed[lane, :120] | ~owned, np.inf, cand[lane, :120])
        np.testing.assert_array_equal(keys[k].numpy(), key)
        je, ji, jq, *_ = jax_selection(cand[lane], fixed[lane] | np.append(~owned, False),
                                       ene[lane], 120, 50, False, 0.05, 0.5,
                                       4096, 1, 0, 1 << 30)
        np.testing.assert_array_equal(idx[k].numpy(), ji)
        assert int(queue[k]) == int(jq)


def test_accept_takes_the_modes_mask_and_band_min():
    """A mask from the ordering modes is compacted as given; ``band_min``
    anchors the band."""
    from faldoi_tpu_torch.ops.select import accept, band_floor_plain

    rng = np.random.default_rng(6)
    e_pop = np.sort(rng.random((2, 30)).astype(np.float32), 1)
    queue = torch.tensor([30, 12])
    valid = T(rng.random((2, 30)) < 0.4)
    acc = accept(T(e_pop), queue, 0.05, 0.5, 4096, 1, valid=valid)
    assert torch.equal(acc.valid, valid)
    flat = np.nonzero(valid.numpy().reshape(-1))[0]
    np.testing.assert_array_equal(acc.order[:len(flat)].numpy(), flat)
    band_min = torch.tensor([[0.1], [0.3]])
    acc = accept(T(e_pop), queue, 0.05, 0.5, 4096, 1, band_min=band_min)
    band, e_ok, _ = band_floor_plain(T(e_pop), queue, 0.05, 0.5, 4096, 1,
                                     band_min=band_min)
    assert torch.equal(acc.band, band)
    assert torch.equal(acc.band, band_min + torch.clamp(0.5 * band_min, min=0.05))


def scatter_case(rng, n, m, nan=False):
    q = rng.integers(0, n, m)
    e = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0, 0.0, -0.0]), m)
    u = rng.standard_normal(m).astype(np.float32)
    v = rng.standard_normal(m).astype(np.float32)
    c = rng.standard_normal(m).astype(np.float32)
    ok = rng.random(m) < 0.7
    te = rng.choice(np.float32([0.75, 1.0, 0.0, -0.0, np.inf]), n + 1)
    if nan:
        e[::37] = np.nan
        e[5::41] = NEG_NAN
        te[3::11] = np.nan
    return (q, e.astype(np.float32), u, v, c, ok, te.astype(np.float32))


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("chi", [False, True])
def test_scatter_twins_match_jax(nan, chi):
    """Collisions, ties within the batch and with the target, signed zeros,
    NaN keys (updates and targets), masked updates to the dump slot, the chi
    payload: the kernel's twins against ``_scatter_min_payload`` and
    ``_scatter_max_payload(exact=True)``."""
    from faldoi_tpu.core.local_step import _scatter_max_payload, _scatter_min_payload
    from faldoi_tpu_torch.ops.scatter import scatter_max_payload, scatter_min_payload

    rng = np.random.default_rng(40 + nan + 2 * chi)
    n, m = 60, 500
    q, e, u, v, c, ok, te = scatter_case(rng, n, m, nan)
    tu, tv, tc = (rng.standard_normal(n + 1).astype(np.float32) for _ in range(3))
    kw = dict(tgt_c=T(tc), c=T(c)) if chi else {}
    for port, jfun, tgt in ((scatter_min_payload, _scatter_min_payload, te),
                            (scatter_max_payload, _scatter_max_payload,
                             np.where(np.isinf(te), -np.inf, te).astype(np.float32))):
        extra = {} if jfun is _scatter_min_payload else dict(exact=True)
        jout = jfun(*map(jnp.asarray, (tgt, tu, tv)),
                    jnp.asarray(tc) if chi else None,
                    *map(jnp.asarray, (q.astype(np.int32), e, u, v)),
                    jnp.asarray(c) if chi else None, jnp.asarray(ok), n, **extra)
        pout = port(*map(T, (tgt, tu, tv)), T(q), *map(T, (e, u, v)), T(ok), n,
                    **kw)
        same_values(pout[0].numpy()[:n], np.asarray(jout[0])[:n])
        for x, y in zip(pout[1:], jout[1:3] + ((jout[3],) if chi else ())):
            np.testing.assert_array_equal(bits(x.numpy()[:n]), bits(np.asarray(y)[:n]))


def jax_wflow(wu, wv, wchi, su, sv, schi, ener, oy, ox, ph, pw, valid, h, w, p):
    """``_sweep_body``'s working-flow scatter (its lines on jnp, canvases
    (p, p, B), the exact max-key form)."""
    from faldoi_tpu.core.local_step import _rowcol_ids, _scatter_max_payload

    n = h * w
    rows, cols = _rowcol_ids((p, p))
    gy = oy[None, None, :] + rows[..., None]
    gx = ox[None, None, :] + cols[..., None]
    inbox = (rows[..., None] < ph[None, None, :]) & (cols[..., None] < pw[None, None, :])
    cell_ok = inbox & valid[None, None, :]
    flat_q = jnp.where(cell_ok, gy * w + gx, n).reshape(-1)
    key = jnp.broadcast_to(ener[None, None, :], su.shape).reshape(-1)
    key_buf = jnp.full((n + 1,), -jnp.inf, jnp.float32)
    return _scatter_max_payload(key_buf, wu, wv, wchi, flat_q, key,
                                su.reshape(-1), sv.reshape(-1),
                                schi.reshape(-1), cell_ok.reshape(-1), n,
                                exact=True)


@pytest.mark.parametrize("nan", [False, True])
def test_wflow_twin_matches_jax(nan):
    """Overlapping patches at the image's edges, tied energies, masked
    patches, a NaN energy: ``wflow_scatter`` against the scatter
    ``_sweep_body`` runs; the lane form equals per-lane calls."""
    from faldoi_tpu_torch.core.local_step import patch_geometry
    from faldoi_tpu_torch.ops.scatter import wflow_scatter
    from faldoi_tpu_torch.ops.stencils import canvas_ids

    rng = np.random.default_rng(50 + nan)
    h, w, wr, k = 17, 23, 2, 90
    p, n = 2 * wr + 1, h * w
    pix = T(rng.integers(0, n, k))
    i, j, oy, ox, ph, pw = patch_geometry(pix, h, w, wr)
    ener = rng.choice(np.float32([0.5, 1.0, 2.0]), k)
    if nan:
        ener[[4, 30]] = np.nan
    su, sv, schi = (rng.standard_normal((k, p, p)).astype(np.float32)
                    for _ in range(3))
    valid = rng.random(k) < 0.8
    wu, wv, wchi = (rng.standard_normal(n + 1).astype(np.float32)
                    for _ in range(3))
    rows, cols = canvas_ids(p, "cpu")
    inbox = (rows < ph[:, None, None]) & (cols < pw[:, None, None]) & T(valid)[:, None, None]
    pw_u, pw_v, pw_c, pkey = wflow_scatter(T(wu), T(wv), T(wchi), T(su), T(sv),
                                           T(schi), T(ener), oy, ox, inbox, h,
                                           w, p)
    jk, ju, jv, jc = jax_wflow(*map(jnp.asarray, (wu, wv, wchi)),
                               *(jnp.moveaxis(jnp.asarray(x), 0, -1)
                                 for x in (su, sv, schi)),
                               jnp.asarray(ener), *(jnp.asarray(x.numpy())
                                                    for x in (oy, ox, ph, pw)),
                               jnp.asarray(valid), h, w, p)
    same_values(pkey.numpy()[:n], np.asarray(jk)[:n])
    for x, y in ((pw_u, ju), (pw_v, jv), (pw_c, jc)):
        np.testing.assert_array_equal(bits(x.numpy()[:n]), bits(np.asarray(y)[:n]))
    # the lane form: two lanes' planes stacked, each patch its lane's base
    lane = T(rng.integers(0, 2, k))
    base = lane * (n + 1)
    planes = [T(np.stack([x, x[::-1].copy()])) for x in (wu, wv, wchi)]
    got = wflow_scatter(*(pl.reshape(-1) for pl in planes), T(su), T(sv),
                        T(schi), T(ener), oy, ox, inbox, h, w, p, base)
    for ln in range(2):
        sel = lane == ln
        one = wflow_scatter(*(pl[ln] for pl in planes), T(su)[sel], T(sv)[sel],
                            T(schi)[sel], T(ener)[sel], oy[sel], ox[sel],
                            inbox[sel], h, w, p)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(bits(a.view(2, n + 1)[ln, :n].numpy()),
                                          bits(b[:n].numpy()))

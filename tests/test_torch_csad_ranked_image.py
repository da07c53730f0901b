"""The whole-image CSAD loops' ranked selection (K14 and K15,
``csrc/csad_global.cu``) as plain models, ``ops/csad.py``'s
``csad_rank_image_plain`` (the rank launch: each pixel's inside b in
descending order, ties by j, in a flat buffer of 48 floats a pixel, and the
``ok`` byte) and ``csad_ranked_image_select_plain`` (one PD iteration: the
merge-path search over the pixel's column at the kernel's flat indices, the
twin's sort where ``ok`` is clear or dot is not finite), against the twins'
sort (``csad_vstep_plain``) on the CPU, bit for bit, the sign of a selected
zero included, in both layouts the kernels were timed in (pixel-major, the
library's, and plane-major).

The states are the first warp of ``tvcsad_global`` (grad the hypot floor)
and of ``nltvcsad_global`` (the breakpoints over sqrt(grad), with pixels
where grad <= GRAD_IS_ZERO, whose v is u) on crops of the synthetic pair at
40x56, 5x7 and 3x3, and their dots over several PD iterations of the twins'
own loops; then adversarial images: NaN and +-inf b at inside neighbours of
pixels on the image edge, NaN and inf dots, ties within A and between A and
B, zeros of both signs.  No JAX; seconds."""

import functools

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import synthetic as syn
from faldoi_tpu_torch.cli.k8_variants import copies, csad_global_args
from faldoi_tpu_torch.core.global_step_csad import (
    nltvcsad_global_loop_plain, tvcsad_global_loop_plain,
)
from faldoi_tpu_torch.core.pd_common import sqrt_rn
from faldoi_tpu_torch.core.preprocess import prepare_pair
from faldoi_tpu_torch.ops.csad import (
    N_D, _sorted_med, csad_b, csad_rank_image_plain, csad_ranked_image_select_plain,
    csad_ranked_select_plain, csad_vstep_plain, image_masks,
)
from faldoi_tpu_torch.params import GRAD_IS_ZERO

torch.set_num_threads(1)

LAYOUTS = ("pixel", "plane")
SHAPES = [(40, 56), (5, 7), (3, 3)]


def _bits(x):
    return x.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=1)
def _pair():
    """The synthetic pair at 40x56, prepared (normalised and smoothed) once;
    the smaller states are its top-left crops."""
    i0, i1, gf, _ = syn.make_pair(40, 56, seed=3)
    a, b = prepare_pair(i0, i1, device="cpu")
    return i0, a, b, gf


def _warp_state(method, h, w, iters):
    """The first warp's arguments of the CSAD global loop of ``method`` (4:
    K14's, 6: K15's) on the prepared synthetic pair at 40x56 at its known
    flow plus 0.5 px of noise, cut to its top-left h x w (the breakpoints
    masked to the crop's windows, K15's weights made of the crop's colour
    planes); for method 6 i1wx and i1wy are zeroed at a tenth of the pixels
    (grad 0 there: v = u) and the breakpoints rebuilt.  Returns (args, [the
    (u1, u2) before each of ``iters`` PD iterations of the twin's own
    loop])."""
    from faldoi_tpu_torch.core.global_step_nltv import global_weights

    i0, a, b, gf = _pair()
    rng = np.random.default_rng(h * w + method)
    flow = torch.as_tensor((gf + rng.normal(0, 0.5, gf.shape)).astype(np.float32))
    args = csad_global_args(a, b, flow, method, i0, iters)
    if method == 6:
        gx, gy = args[9], args[10]
        flat = torch.as_tensor(rng.uniform(size=gx.shape) < 0.1)
        flat[0, 0] = True
        gx[flat], gy[flat] = 0.0, 0.0
        grad = (gx * gx + gy * gy).contiguous()
        sq = sqrt_rn(torch.where(grad > GRAD_IS_ZERO, grad, torch.ones(())))
        args[8] = _rebuild_b(a, b, flow, gx, gy, sq, args[14])
        args[11], args[12] = sq.contiguous(), grad
    masks, n = image_masks(h, w, "cpu")
    m_at = 13 if method == 4 else 14
    cut = [x[..., :h, :w].contiguous() if isinstance(x, torch.Tensor) else x
           for x in args]
    cut[8] = torch.where(masks, cut[8], torch.zeros(())).contiguous()
    cut[m_at], cut[m_at + 1] = masks, n
    if method == 6:
        cut[6], cut[7] = global_weights(i0[:, :h, :w], "cpu")
    us = []
    state = copies(cut)
    for _ in range(iters):
        us.append((state[0].clone(), state[1].clone()))
        if method == 4:
            tvcsad_global_loop_plain(*state[:-2], -1.0, 1)
        else:
            nltvcsad_global_loop_plain(*state[:-1], 1)
    return cut, us


def _rebuild_b(a, b, flow, gx, gy, den, masks):
    """``csad_b`` of the warp of b at ``flow`` with the given gradient
    planes and denominator."""
    from faldoi_tpu_torch.ops.bicubic import bicubic_warp_stack
    from faldoi_tpu_torch.ops.stencils import centered_gradient

    u1, u2 = flow[..., 0].contiguous(), flow[..., 1].contiguous()
    i1x, i1y = centered_gradient(b)
    i1w, _, _ = bicubic_warp_stack(torch.stack([b, i1x, i1y]), u1, u2, True)
    return csad_b(a, i1w, gx, gy, u1, u2, den, masks)


def _hold(b, masks, n, l_t, den, dots, layout):
    """The image model against the sort at each dot, and against the loop
    kernels' model (``csad_ranked_select_plain``); returns the fallback
    masks."""
    rb, ok = csad_rank_image_plain(b, masks, l_t, den, layout)
    ltg = l_t * den
    out = []
    loop = csad_ranked_select_plain(b, masks, n, l_t, den, dots)
    for dot, (lmed, _) in zip(dots, loop):
        med, fb = csad_ranked_image_select_plain(rb, ok, b, masks, n, l_t, den, dot,
                                                 layout)
        assert torch.equal(_bits(med), _bits(_sorted_med(b, masks, n, dot, ltg)))
        assert torch.equal(_bits(med), _bits(lmed))
        bfin = (torch.isfinite(b) | ~masks).all(dim=0)
        assert torch.equal(fb, ~(bfin & torch.isfinite(ltg) & torch.isfinite(dot)))
        out.append(fb)
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_rank_image_layouts(h, w, layout):
    """The rank launch's model: rank i of pixel `cell` at col(cell) + i *
    stride holds the inside b of rank i (descending, ties by j), for every
    i < n and nothing else; ok marks the pixels whose inside b and l_t
    denom are all finite."""
    args, _ = _warp_state(4, h, w, 1)
    b, den, l_t, masks, n = args[8], args[11], args[12], args[13], args[14]
    b = b.clone()
    b[0, h - 1, w - 1] = float("inf")   # inside at the far corner: dy -3, dx -3
    rb, ok = csad_rank_image_plain(b, masks, l_t, den, layout)
    hw = h * w
    cols = rb.view(hw, N_D).t() if layout == "pixel" else rb.view(N_D, hw)
    for cell in range(hw):
        y, x = divmod(cell, w)
        inside = b[:, y, x][masks[:, y, x]]
        k = int(n[y, x])
        want = torch.sort(-inside, stable=True).values.neg()
        assert torch.equal(_bits(cols[:k, cell]), _bits(want))
        assert bool(cols[k:, cell].isnan().all())
    expect = (torch.isfinite(b) | ~masks).all(dim=0)
    assert torch.equal(ok, expect)
    assert bool(ok[h - 1, w - 1]) == (h < 4 or w < 4)   # the inf b is inside?


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("method", [4, 6])
@pytest.mark.parametrize("h,w", SHAPES)
def test_image_select_matches_sort_on_warp_states(h, w, method, layout):
    """The first warp of each CSAD global step, its dots over the PD
    iterations of the twin's own loop: the image model's median equals the
    sort's (and the loop kernels' model's) bit for bit, no pixel falls
    back, and v (v = u where grad <= GRAD_IS_ZERO for K15) equals the
    twin's v-step."""
    iters = 4 if h > 5 else 8
    args, us = _warp_state(method, h, w, iters)
    b, gx, gy = args[8], args[9], args[10]
    den, l_t = (args[11], args[12]) if method == 4 else (args[11], args[13])
    masks, n = (args[13], args[14]) if method == 4 else (args[14], args[15])
    dots = [(gx * u1 + gy * u2) / den for u1, u2 in us]
    fbs = _hold(b, masks, n, l_t, den, dots, layout)
    assert not any(bool(fb.any()) for fb in fbs)
    rb, ok = csad_rank_image_plain(b, masks, l_t, den, layout)
    gok = args[12] > GRAD_IS_ZERO if method == 6 else torch.ones_like(ok)
    if method == 6:
        assert bool((~gok).any())
    for (u1, u2), dot in zip(us, dots):
        med, _ = csad_ranked_image_select_plain(rb, ok, b, masks, n, l_t, den, dot,
                                                layout)
        v1 = torch.where(gok, u1 - gx * med / den, u1)
        v2 = torch.where(gok, u2 - gy * med / den, u2)
        w1, w2 = csad_vstep_plain(u1, u2, b, gx, gy, den, l_t, masks, n)
        assert torch.equal(_bits(v1), _bits(torch.where(gok, w1, u1)))
        assert torch.equal(_bits(v2), _bits(torch.where(gok, w2, u2)))


# adversarial images: case -> (values b takes, values l_t takes, values dot
# takes after the first iteration's 0)
CASES = {
    "ties-and-zeros": ([-0.5, -0.25, -0.0, 0.0, 0.25, 0.5], [0.25, -0.25, 0.5],
                       [0.0, -0.0, 0.25, -0.5]),
    "ties-with-b": ([-1.0, -0.5, 0.0, 0.5, 1.0], [0.25, 0.5], [0.0, 0.5, -1.0]),
    "zeros-at-dot": ([0.5, -0.5, 0.25, 0.0, -0.0, 1.0], [0.25, -0.25],
                     [0.5, 0.25, -0.0, 0.0]),
    "non-finite": ([0.25, -0.25, 0.0, 1.5], [0.3, -0.3],
                   [0.0, 1.5, np.inf, -np.inf, np.nan]),
}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("h,w", SHAPES)
def test_image_select_adversarial(h, w, case, layout):
    """Ties within A and between A and B, zeros of both signs, NaN and
    +-inf b at inside neighbours of pixels on the image edge (those take the
    sort every iteration), NaN and +-inf dots (that iteration only): the
    image model equals the sort bit for bit and sends exactly the
    non-finite pixels to it."""
    pool, lts, dpool = CASES[case]
    rng = np.random.default_rng(700 + h + w + len(case))
    masks, n = image_masks(h, w, "cpu")
    b = torch.where(masks, torch.as_tensor(np.float32(pool)[rng.integers(
        0, len(pool), (N_D, h, w))]), torch.zeros(()))
    edge = [(0, 0), (0, w - 1), (h - 1, w // 2), (h // 2, 0)]
    for (y, x), v in zip(edge, (np.inf, -np.inf, np.nan, np.inf)):
        j = int(torch.nonzero(masks[:, y, x])[0])   # an inside neighbour
        b[j, y, x] = float(v)
    lt = torch.as_tensor(np.float32(lts)[rng.integers(0, len(lts), (h, w))])
    dots = [torch.zeros((h, w))] + [
        torch.as_tensor(np.float32(dpool)[rng.integers(0, len(dpool), (h, w))])
        for _ in range(3)]
    fbs = _hold(b, masks, n, lt, torch.ones((h, w)), dots, layout)
    cells = {(y, x) for y, x in edge}
    for fb, dot in zip(fbs, dots):
        got = {(y, x) for y, x in fb.nonzero().tolist()}
        assert cells <= got
        assert got - cells == {(y, x) for y, x in (~torch.isfinite(dot)).nonzero()
                               .tolist()} - cells

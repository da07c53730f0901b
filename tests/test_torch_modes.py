"""The growing's ordering modes and fills in the port's lanes, on the CPU
(no JAX; each mode is held against JAX in ``test_torch_ordering.py`` and the
``test_torch_*_slice.py`` files): pairs mode at N = 2 under relax, the dense
fill, the bilateral pre-fill and relax_late with polish, each pair bit for
bit its own ``match_growing``; one lane-batched sweep under exactmin and
defer bit for bit the one-lane sweeps; method 8 (whose lanes drain one
after the other) under polish, relax and the bilateral pre-fill; and
``local_faldoi``'s ordering flags, which must give ``match_growing``'s
result with the same arguments."""

import os

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

H, W = 30, 40
BSZ = 64
# seeds a lane (fwd, bwd) of each pair
COUNTS = ((14, 30), (35, 11))


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


@pytest.fixture(scope="module")
def pairs():
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    out = []
    for k, (nf, nb) in enumerate(COUNTS):
        i0, i1, gf, gb = syn.make_pair(H, W, seed=161 + k)
        a, b = prepare_pair(i0, i1, device="cpu")
        rng = np.random.default_rng(162 + k)
        go = syn.make_seeds(gf, syn.random_seed_positions(H, W, nf, rng), rng)
        ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, nb, rng), rng)
        out.append(dict(frames=(a, b), planes=(i0, i1), seeds=(go, ba)))
    return out


MODES = {
    "relax": dict(relax=True),
    "dense": dict(fill="dense"),
    "bilateral": dict(bilateral=True, warm_band=0),
    "relax_late_polish": dict(relax_late=True, polish=1, warm_band=0),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_pairs_equal_single_pairs_under_mode(pairs, mode):
    from faldoi_tpu_torch.core.match_growing import (
        match_growing, match_growing_pairs,
    )

    kw = MODES[mode]
    prm = P.Parameters()
    prm.iterations_of = 2
    singles = []
    for p in pairs:
        st = {}
        out = match_growing(*p["seeds"], *p["frames"], prm, bsz=BSZ, stats=st,
                            **kw)
        singles.append(([t.numpy() for t in out], st["sweeps"]))
    st = {}
    outs = match_growing_pairs([p["seeds"] for p in pairs],
                               [p["frames"] for p in pairs], prm, bsz=BSZ,
                               stats=st, **kw)
    for k, (got, (want, want_sweeps)) in enumerate(zip(outs, singles)):
        for a, b in zip(got, want):                  # flow, energy, occ
            assert same_bits(a.numpy(), b), (mode, k)
        assert np.isfinite(want[0]).all()            # 100% fill
        mine = [(s["it"], s["lane"], s["sweeps"]) for s in st["sweeps"]
                if s["pair"] == k]
        assert mine == [(s["it"], s["lane"], s["sweeps"]) for s in want_sweeps]


@pytest.mark.parametrize("modes", [dict(exactmin=7), dict(exactmin=8,
                                                          exactmin_band="2"),
                                   dict(defer=0.05, defer_win=9, floor_scale=1),
                                   dict(relax=True, floor=BSZ, defer=0.05),
                                   dict(fill="dense", exactmin=6,
                                        exactmin_band="1")])
def test_lane_sweep_equals_one_lane_sweeps(pairs, modes):
    """Two lanes of different pairs mid-growth (three sweeps from their
    seeds), one of them not swept: ``sweep_lanes`` under the modes equals
    each lane's ``sweep_body`` bit for bit."""
    from faldoi_tpu_torch.core.functionals import (
        make_solver_consts, stack_solver_consts,
    )
    from faldoi_tpu_torch.core.local_step import (
        init_state, insert_seeds, lane_state, stack_states, sweep_body,
        sweep_lanes,
    )
    from faldoi_tpu_torch.models import method_local_params

    kw = dict(modes)
    fs = kw.pop("floor_scale", 64)
    scs, sts = [], []
    sal = torch.ones(H * W + 1)
    for p in pairs:
        a, b = p["frames"]
        sc = make_solver_consts(a, b, *method_local_params(0, 5), 0.01, 11, 0)
        st = insert_seeds(init_state(H, W, "cpu"), p["seeds"][0], sc, sal, 1, 4,
                          seed_bsz=16)
        for _ in range(3):
            st, _ = sweep_body(st, sc, torch.ones(H, W), sal, 0, H, W, 5, BSZ,
                               1, 4, 64)
        scs.append(sc)
        sts.append(st)
    trust = torch.ones((3, H, W))
    trust[0, 5:12, 8:20] = 0
    stack = stack_states(sts + [sts[0]])
    sals = torch.ones((3, H * W + 1))
    got, counts = sweep_lanes(stack, stack_solver_consts(scs + [scs[0]]), trust,
                              sals, 1, H, W, 5, BSZ, 1, 4, fs, lanes=[0, 1],
                              **kw)
    assert sum(counts) > 0
    for lane in range(2):
        want, acc = sweep_body(sts[lane], scs[lane], trust[lane], sals[lane], 1,
                               H, W, 5, BSZ, 1, 4, fs, **kw)
        assert acc == counts[lane]
        for x, y in zip(lane_state(got, lane), want):
            assert same_bits(x.numpy(), y.numpy())
    for x, y in zip(lane_state(got, 2), sts[0]):    # not swept: untouched
        assert same_bits(x.numpy(), y.numpy())


def test_cli_ordering_flags(pairs, tmp_path):
    """``local_faldoi -warm_band 0 -relax_late 1 -polish 1 -fill dense
    -exactmin 9 -exactmin_band 2 -defer 0.5 -defer_win 13`` gives
    ``match_growing``'s flow with the same arguments, bit for bit."""
    from faldoi_tpu_torch.cli import local_faldoi
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.io.flo import read_flo, write_flo

    p = pairs[0]
    names = []
    for k, im in enumerate(p["planes"]):
        names.append(str(tmp_path / f"f{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    ims = tmp_path / "ims.txt"
    ims.write_text("\n".join(names) + "\n")
    seeds = [str(tmp_path / f"{k}.flo") for k in ("go", "ba")]
    for path, s in zip(seeds, p["seeds"]):
        write_flo(path, s)
    out = str(tmp_path / "out.flo")
    flags = ["-warm_band", "0", "-relax_late", "1", "-polish", "1", "-fill",
             "dense", "-exactmin", "9", "-exactmin_band", "2", "-defer", "0.5",
             "-defer_win", "13"]
    assert local_faldoi.main([str(ims), *seeds, out, str(tmp_path / "s.tiff"),
                              "-loc_it", "1", "-bsz", str(BSZ), "-device", "cpu",
                              *flags]) == 0
    planes = [np.round(im).astype(np.uint8).astype(np.float32)
              for im in p["planes"]]
    a, b = prepare_pair(*planes, device="cpu")
    prm = P.Parameters()
    prm.iterations_of = 1
    want = match_growing(*p["seeds"], a, b, prm, bsz=BSZ, warm_band=0,
                         relax_late=True, polish=1, fill="dense", exactmin=9,
                         exactmin_band="2", defer=0.5, defer_win=13)[0]
    assert same_bits(read_flo(out), want.numpy())
    assert set(local_faldoi.ORDERING_FLAGS) == {
        "relax_late", "exactmin", "exactmin_band", "defer", "defer_win",
        "polish"}
    assert os.path.getsize(out) > 0


@pytest.fixture(scope="module")
def m8_case():
    """A 20x28 four-frame crop, its seeds and its plain m8 growing (two
    outer iterations)."""
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_quad

    h, w = 20, 28
    i0, i1, i_1, i2, gf, gb, _ = syn.make_quad(h, w, seed=165,
                                              full_shape=(40, 56))
    rng = np.random.default_rng(166)
    go = syn.make_seeds(gf, syn.random_seed_positions(h, w, 12, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(h, w, 12, rng), rng)
    a, b, a_1, b2 = prepare_quad(i0, i1, i_1, i2, device="cpu")
    prm = P.Parameters()
    prm.val_method = P.M_TVL1_OCC
    prm.iterations_of = 2
    args = (go, ba, a, b, prm)
    kw = dict(bsz=BSZ, i_1n=a_1, i2n=b2)
    return args, kw, match_growing(*args, **kw)[0]


@pytest.mark.parametrize("modes", [dict(polish=1), dict(relax=True),
                                   dict(bilateral=True, fill="dense")])
def test_method_8_growing_under_modes(m8_case, modes):
    """Method 8's growing (four frames, its lanes drained one after the
    other, chi carried) under the modes: 100% fill, the occlusion mask
    binary, and a flow other than the plain growing's (the bilateral
    pre-fill alone would not move it; the dense fill does)."""
    from faldoi_tpu_torch.core.match_growing import match_growing

    args, kw, plain = m8_case
    st = {}
    flow, _, occ = match_growing(*args, stats=st, **kw, **modes)
    assert torch.isfinite(flow).all()
    assert set(torch.unique(occ).tolist()) <= {0.0, 1.0}
    assert not torch.equal(flow, plain)
    if "polish" in modes:
        assert {"polish_it1", "polish_final"} <= set(st["seconds"])

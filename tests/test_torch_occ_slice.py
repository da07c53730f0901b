"""The TV-L1-with-occlusions slice (method 8) of the port against
faldoi_tpu's fused run, and its entry points on the CPU.

* Seeds -> ``match_growing`` (four frames, the chi planes flowing, the PD
  cap ``iterations_of``) -> ``global_refine(8)`` on a 33x45 crop of the
  synthetic four-frame sequence, against JAX's ``match_growing`` and
  ``global_refine`` (5 warps of at most 20 PD iterations, where the CLI's
  default is 400: the port's twin takes ~0.02 s an iteration here): by the
  rg and var EPE and the agreement of the occlusion masks (the growing's
  ``out_chi``, and the global chi).
* ``local_faldoi -m 8`` -> ``global_faldoi -m 8 ... occl_in occl_out`` on
  ``.npy`` frames; a two-frame list falls back to method 0, as in JAX.
* ``faldoi_deep_occ`` with the ``deepmatching`` binary stubbed: the flows
  and both masks.

JAX runs in the repo's exact configuration (``FALDOI_TOPK=exact
FALDOI_WSCATTER=exact FALDOI_WSCATTER_R=5 FALDOI_BLOCKGATHER=0
FALDOI_WARP_PREC=highest``, set for the whole module before the first JAX
trace; 33x45 is traced by no other m8 test file).  Its m8 growing compiles
for ~1 min and runs for ~1 min on the CPU: it runs once for the comparison
and once more for its own spread.

Gates: rg EPE <= 0.01 px and var EPE <= 0.01 px (ROADMAP's var gate), the
masks equal at >= 99% of the pixels.  Measured: rg 0.00062 px, var 0.0080
px, the growing's masks equal at 99.87% of the pixels and the global ones
at 100%, both as close to the known occlusions (95.96%).  JAX's own growing
moves by rg 0.00071 px and keeps 99.87% of its mask when the seeds move by
1e-6 px (``test_jax_m8_growing_spread``, a second JAX run on the compiled
program), so the port sits within JAX's own spread.  Methods 0-7
are held to JAX by their own slice tests."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W, SEED, BSZ = 33, 45, 121, 256
GLB_ITERS = 20          # the global step's PD cap a warp (-glb_iters)


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def _seeds(gf, gb, h, w, n, seed):
    rng = np.random.default_rng(seed)
    go = syn.make_seeds(gf, syn.random_seed_positions(h, w, n, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(h, w, n, rng), rng)
    return go, ba


@pytest.fixture(scope="module")
def quad():
    """The 33x45 crop's four frames, known flows and occlusions, seeds."""
    i0, i1, i_1, i2, gf, gb, occ = syn.make_quad(H, W, seed=SEED,
                                                 full_shape=(80, 100))
    return (i0, i1, i_1, i2), gf, occ, _seeds(gf, gb, H, W, 25, SEED + 1)


def _jax_growing(frames, go, ba):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_quad as jquad

    ja = jquad(*frames)
    jprm = JP.Parameters()
    jprm.val_method = 8
    jrg, _, jocc = jmatch(go, ba, ja[0], ja[1], jprm, bsz=BSZ, mode="fused",
                          i0_planes=frames[0], i1_planes=frames[1],
                          i_1n=ja[2], i2n=ja[3])
    return np.asarray(jrg), np.asarray(jocc)


@pytest.fixture(scope="module")
def jax_grown(quad):
    frames, _, _, (go, ba) = quad
    return _jax_growing(frames, go, ba)


def test_jax_m8_growing_spread(quad, jax_grown):
    """JAX's own m8 growing when the seeds move by 1e-6 px: the scale the
    port's gates sit above (measured rg 0.00071 px, 99.87% of the mask
    kept)."""
    frames, _, _, (go, ba) = quad
    noise = np.float32(1e-6)
    rg, occ = _jax_growing(frames, go + noise, ba - noise)
    assert 0 < syn.epe(rg, jax_grown[0]) < 0.01
    assert (occ == jax_grown[1]).mean() >= 0.99


def test_m8_slice_matches_jax(quad, jax_grown):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.preprocess import prepare_triple as jtriple
    from faldoi_tpu.models import global_refine as jrefine
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.occlusion import occ_global_loop, occ_patch_loop
    from faldoi_tpu_torch.core.preprocess import prepare_quad, prepare_triple
    from faldoi_tpu_torch.models import global_refine

    (i0, i1, i_1, i2), gf, occ, (go, ba) = quad
    jrg, jocc = jax_grown
    jg = JP.init_params(None, JP.GLOBAL_STEP)
    jg.val_method, jg.iterations_of = 8, GLB_ITERS
    ju1, ju2, jchi = jrefine(8, *jtriple(i0, i1, i_1), jnp.asarray(jrg[..., 0]),
                             jnp.asarray(jrg[..., 1]), jg, occ_init=jocc)
    jvar = np.stack([np.asarray(ju1), np.asarray(ju2)], -1)

    ta = prepare_quad(i0, i1, i_1, i2, device="cpu")
    prm = P.Parameters()
    prm.val_method = 8
    stats = {}
    before = (occ_patch_loop.launches, occ_global_loop.launches)
    rg, _, pocc = match_growing(go, ba, ta[0], ta[1], prm, bsz=BSZ, stats=stats,
                                i0_planes=i0, i1_planes=i1, i_1n=ta[2],
                                i2n=ta[3])
    gprm = P.init_params(None, P.GLOBAL_STEP)
    gprm.val_method, gprm.iterations_of = 8, GLB_ITERS
    a, b, c = prepare_triple(i0, i1, i_1, device="cpu")
    u1, u2, chi = global_refine(8, a, b, rg[..., 0].contiguous(),
                                rg[..., 1].contiguous(), gprm, stats=stats,
                                i_1n=c, occ_init=pocc.numpy())
    assert (occ_patch_loop.launches, occ_global_loop.launches) == before
    rg, pocc = rg.numpy(), pocc.numpy()
    var, chi = torch.stack([u1, u2], -1).numpy(), chi.numpy()
    assert np.isfinite(jrg).all() and np.isfinite(rg).all()       # 100% fill
    assert syn.epe(rg, jrg) <= 0.01
    assert (pocc == jocc).mean() >= 0.99
    assert set(np.unique(pocc)) == {0.0, 1.0}
    assert np.isfinite(var).all() and syn.epe(var, jvar) <= 0.01
    assert (chi == np.asarray(jchi)).mean() >= 0.99
    assert set(np.unique(chi)) <= {0.0, 1.0}
    # both found the moving rectangle's occlusions as well as each other
    assert abs((pocc == occ).mean() - (jocc == occ).mean()) <= 0.01
    assert len(stats["sweeps"]) == 2 * prm.iterations_of + 1
    assert len(stats["global_iters"]) == P.PAR_DEFAULT_NWARPS_GLOBAL


@pytest.fixture(scope="module")
def quad_dir(tmp_path_factory):
    """A 20x28 four-frame crop as .npy frames, 2- and 4-frame lists, seeds."""
    from faldoi_tpu_torch.io.flo import write_flo

    d = tmp_path_factory.mktemp("occ_cli")
    *frames, gf, gb, _ = syn.make_quad(20, 28, seed=141, full_shape=(40, 56))
    names = []
    for k, im in enumerate(frames):
        names.append(str(d / f"f{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    (d / "ims4.txt").write_text("\n".join(names) + "\n")
    (d / "ims2.txt").write_text("\n".join(names[:2]) + "\n")
    go, ba = _seeds(gf, gb, 20, 28, 12, 142)
    write_flo(str(d / "go.flo"), go)
    write_flo(str(d / "ba.flo"), ba)
    return d, gf


def test_stage_clis_run_m8_on_cpu(quad_dir):
    """local_faldoi -m 8 writes the flow, the energy and the occlusion mask
    (.npy and .png); global_faldoi -m 8 starts chi from that mask, runs
    -glb_iters PD iterations a warp at most and writes the final mask."""
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.io.flo import read_flo
    from faldoi_tpu_torch.io.image import read_image_split

    d, gf = quad_dir
    rg, var = str(d / "rg.flo"), str(d / "var.flo")
    for occ in ("occ_rg.npy", "occ_rg.png"):
        stats = {}
        assert local_faldoi.main([str(d / "ims4.txt"), str(d / "go.flo"),
                                  str(d / "ba.flo"), rg, str(d / "sim.tiff"),
                                  str(d / occ), "-m", "8", "-loc_it", "1",
                                  "-bsz", "64", "-device", "cpu"],
                                 stats=stats) == 0
        assert len(stats["sweeps"]) == 3
    m_npy = np.load(d / "occ_rg.npy")
    assert np.array_equal(read_image_split(str(d / "occ_rg.png"))[0], m_npy)
    assert set(np.unique(m_npy)) <= {0, 1}
    assert global_faldoi.main([str(d / "ims4.txt"), rg, var,
                               str(d / "occ_rg.png"), str(d / "occ_var.png"),
                               "-m", "8", "-glb_iters", "20", "-device", "cpu"],
                              stats=stats) == 0
    assert len(stats["global_iters"]) == P.PAR_DEFAULT_NWARPS_GLOBAL
    assert all(0 < n <= 20 for n in stats["global_iters"])
    flow = read_flo(var)
    assert np.isfinite(read_flo(rg)).all() and np.isfinite(flow).all()
    assert syn.epe(flow, gf) < 3.0      # a sanity bound: 12 seeds, 1 iteration
    mask = read_image_split(str(d / "occ_var.png"))[0]
    assert mask.shape == (20, 28) and set(np.unique(mask)) <= {0.0, 1.0}


def test_stage_clis_fall_back_to_m0_with_two_frames(quad_dir, capsys):
    """With a two-frame list, method 8 runs method 0 (as JAX does): the
    same flow as -m 0, and global_faldoi writes no occlusion output."""
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.io.flo import read_flo

    d, _ = quad_dir
    outs = []
    for m in ("8", "0"):
        rg, var = str(d / f"rg2_{m}.flo"), str(d / f"var2_{m}.flo")
        assert local_faldoi.main([str(d / "ims2.txt"), str(d / "go.flo"),
                                  str(d / "ba.flo"), rg, str(d / "s.tiff"),
                                  "-m", m, "-loc_it", "1", "-bsz", "64",
                                  "-device", "cpu"]) == 0
        assert global_faldoi.main([str(d / "ims2.txt"), rg, var,
                                   str(d / "go.flo"), str(d / f"o{m}.png"),
                                   "-m", m, "-w", "1", "-device", "cpu"]) == 0
        outs.append(read_flo(var))
        assert not (d / f"o{m}.png").exists()
    assert "changed to TV-l2 coupled" in capsys.readouterr().err
    assert np.array_equal(outs[0], outs[1])


def _dm_stub(gf, gb, h, w):
    """deepmatch_both's stand-in: DeepMatching lines at 30 random sources a
    direction, their targets moved by the known flow."""
    rng = np.random.default_rng(143)

    def write(dest, flow):
        out = []
        for y, x in zip(rng.integers(0, h, 30), rng.integers(0, w, 30)):
            u, v = flow[y, x]
            out.append(f"{x} {y} {x + u:.0f} {y + v:.0f} 4.5 {len(out)}\n")
        Path(dest).write_text("".join(out))

    def deepmatch_both(im0, im1, m1, m2, *args, **kwargs):
        write(m1, gf)
        write(m2, gb)

    return deepmatch_both


def test_faldoi_deep_occ_on_cpu(tmp_path, monkeypatch):
    """faldoi_deep_occ on a four-frame list: -vm 8 and -fb_thresh 13 by
    default, the flows and both occlusion masks; a two-frame list is
    refused."""
    import faldoi_tpu_torch.cli.faldoi_deep_occ as docc
    from faldoi_tpu_torch.io.flo import read_flo
    from faldoi_tpu_torch.io.image import read_image_split

    h, w = 24, 32
    *frames, gf, gb, _ = syn.make_quad(h, w, seed=144, full_shape=(48, 64))
    names = []
    for k, im in enumerate(frames):
        names.append(str(tmp_path / f"frame_{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    (tmp_path / "ims4.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "ims2.txt").write_text("\n".join(names[:2]) + "\n")
    monkeypatch.setattr(docc, "deepmatch_both", _dm_stub(gf, gb, h, w))
    args = docc.build_argparser()
    args.set_defaults(vm="8", fb_thresh="13")
    parsed = args.parse_args([str(tmp_path / "ims4.txt")])
    assert (parsed.vm, parsed.fb_thresh) == ("8", "13")
    res = str(tmp_path / "out") + os.sep
    stats = {}
    assert docc.main([str(tmp_path / "ims4.txt"), "-device", "cpu", "-bsz", "64",
                      "-local_iter", "1", "-glob_iter", "10", "-res_path", res],
                     stats=stats) == 0
    for f in ("frame_0_dm_rg.flo", "frame_0_dm_var.flo"):
        assert np.isfinite(read_flo(res + f)).all()
    for f in ("frame_0_dm_rg_occ.png", "frame_0_dm_var_occ.png"):
        m = read_image_split(res + f)[0]
        assert m.shape == (h, w) and set(np.unique(m)) <= {0.0, 1.0}
    assert set(stats["stages"]) >= {"deepmatching", "local step", "global step"}
    assert len(stats["global_iters"]) == P.PAR_DEFAULT_NWARPS_GLOBAL
    assert docc.main([str(tmp_path / "ims2.txt"), "-device", "cpu",
                      "-res_path", res]) == 1


def test_m8_entry_points_import_neither_jax_nor_pil():
    """The m8 entry point and its modules import no JAX, no faldoi_tpu and no
    imaging library (the card's machine has none)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import faldoi_tpu_torch.cli.faldoi_deep_occ\n"
            "import faldoi_tpu_torch.cli.local_faldoi, faldoi_tpu_torch.cli.global_faldoi\n"
            "import faldoi_tpu_torch.core.occlusion, faldoi_tpu_torch.core.match_growing\n"
            "bad = [m for m in ('jax', 'faldoi_tpu', 'PIL', 'imageio')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)

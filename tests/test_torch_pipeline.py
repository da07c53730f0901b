"""The front of the port's pipeline against faldoi_tpu's: sparse seeds, the
match-list tools, the built-in SIFT matcher, DeepMatching rescoring, and the
two drivers (``faldoi_sift``, ``faldoi_deep``) from frames to final flow.

Text artifacts must equal JAX's byte for byte; the drivers' flows are held
by EPE against JAX's (rg <= 0.05 px, var <= 0.01 px, 100% fill in both).
The drivers run method 1 (weighted TV-L1) at bsz 256 on a 64x96 PNG pair,
JAX in the repo's exact configuration (``FALDOI_GROW_BSZ=256``); each JAX
driver runs once, in a module-scoped fixture.  The pair is a translation by
(2, -1) px of a textured canvas sprinkled with Gaussian blobs: the built-in
SIFT needs ~20 px of margin around a keypoint, so a 64x96 frame of the
smooth synthetic texture alone yields only 2-3 matches, too few to grow
from.  No matcher binary exists here: ``faldoi_sift`` takes its built-in
matcher in both packages, and
``faldoi_deep``'s ``deepmatch_both`` is stubbed in both by ``monkeypatch``
with the golden DeepMatching positions (``tests/golden/deep_mt_{1,2}.txt``)
that fall in the frame, their targets moved by the pair's known flow."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import synthetic as syn
from faldoi_tpu_torch.io.flo import read_flo

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "golden"
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest", "FALDOI_GROW_BSZ": "256"}
H, W = 64, 96
PAIR_SEED = 3
FLOW = (2.0, -1.0)         # the pair's translation, px


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def _save_png(path, planes):
    from PIL import Image

    Image.fromarray(np.round(planes).astype(np.uint8).transpose(1, 2, 0)).save(path)
    return str(path)


def _same_text(a, b):
    assert Path(a).read_text() == Path(b).read_text(), (a, b)


# --- sparse seeds ---------------------------------------------------------

def test_sparse_flow_matches_jax(tmp_path):
    from faldoi_tpu.core.sparse import sparse_flow as jsparse
    from faldoi_tpu_torch.cli import sparse_flow as cli
    from faldoi_tpu_torch.core.sparse import parse_matches, sparse_flow

    rng = np.random.default_rng(50)
    w, h = 40, 30
    m = np.column_stack([rng.uniform(-3, w + 3, 300), rng.uniform(-3, h + 3, 300)])
    m = np.column_stack([m, m + rng.normal(0, 2, m.shape)])
    m[10] = m[5] + [0.3, 0.2, 1.0, -1.0]            # same pixel, later wins
    m[11] = [w, 3, w + 1, 3]                        # x == w: out of range
    m[12] = [2, -0.5, 2, 0]                         # y < 0: out of range
    lines = [" ".join(f"{v:.4f}" for v in row) for row in m]
    lines[20] += " 5.5 7"                           # extra columns are cut
    lines.insert(30, "1 2 3")                       # short lines are skipped
    path = tmp_path / "m.txt"
    path.write_text("\n".join(lines) + "\n")
    want = jsparse(str(path), w, h)
    got = sparse_flow(str(path), w, h)
    np.testing.assert_array_equal(got, want)
    pm = parse_matches(str(path))
    assert pm.shape == (300, 4)
    fin = np.isfinite(got).all(-1)
    assert 0 < fin.sum() < 300                      # dropped and overwritten
    i, j = np.floor(pm[10, :2]).astype(int)
    np.testing.assert_array_equal(got[j, i], pm[10, 2:] - pm[10, :2])
    assert cli.main([str(path), str(w), str(h), str(tmp_path / "s.flo")]) == 0
    np.testing.assert_array_equal(read_flo(str(tmp_path / "s.flo")), want)
    assert cli.main([str(path), str(w)]) == 1


# --- match-list tools -----------------------------------------------------

def _run_both(tmp_path, name, files, fn):
    """Run the JAX and the port tool on their own copies of ``files``;
    returns (jax output path, port output path)."""
    import faldoi_tpu.matchers.matchlists as J
    import faldoi_tpu_torch.matchers.matchlists as T

    outs = []
    for mod, sub in ((J, "jax"), (T, "port")):
        d = tmp_path / sub / name
        d.mkdir(parents=True)
        paths = [str(shutil.copy(f, d / Path(f).name)) for f in files]
        outs.append(fn(getattr(mod, name), paths))
    assert Path(outs[0]).name == Path(outs[1]).name
    return outs


def test_match_list_tools_match_jax(tmp_path):
    rng = np.random.default_rng(51)
    sift = tmp_path / "a_sift_mt_1.txt"             # match_cli's 6+ columns
    sift.write_text("".join(
        " ".join(f"{v:.3f}" for v in rng.uniform(0, 400, 6)) + " 0.5\n"
        for _ in range(40)))
    dm = str(GOLDEN / "deep_mt_1.txt")
    sal = str(GOLDEN / "deep_mt_1_saliency.txt")
    cut = str(GOLDEN / "deep_mt_1_saliency_out_cut.txt")
    cut2 = str(GOLDEN / "deep_mt_2_saliency_out.txt")
    for a, b in (_run_both(tmp_path, "cut_matching_list", [sift],
                           lambda f, p: f(p[0])),
                 _run_both(tmp_path, "cut_deep_list", [dm], lambda f, p: f(p[0])),
                 _run_both(tmp_path, "delete_outliers", [sal],
                           lambda f, p: f(p[0], 0.045)),
                 _run_both(tmp_path, "joint_matches", [cut, cut2],
                           lambda f, p: f(p[0], p[1]))):
        _same_text(a, b)
        assert Path(b).read_text()


# --- frames: gray, SIFT, rescoring ----------------------------------------

@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_gray_formula_equals_pil(tmp_path, mode):
    from PIL import Image

    from faldoi_tpu_torch.io.image import pil_gray, read_image_split

    rng = np.random.default_rng(52)
    nch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = rng.integers(0, 256, (37, 53, nch), dtype=np.uint8)
    arr[0, :8, :3 if nch > 1 else 1] = [[0], [255], [1], [254], [127], [128],
                                        [64], [191]]
    img = Image.fromarray(arr[..., 0] if nch == 1 else arr, mode)
    img.save(tmp_path / "f.png")
    want = np.asarray(img.convert("L"))
    np.testing.assert_array_equal(pil_gray(read_image_split(str(tmp_path / "f.png"))),
                                  want)
    np.save(tmp_path / "f.npy", arr[..., 0] if nch == 1 else arr)
    np.testing.assert_array_equal(pil_gray(read_image_split(str(tmp_path / "f.npy"))),
                                  want)


def test_sift_matches_files_match_jax(tmp_path):
    from faldoi_tpu.matchers.sift import sift_matches_files as jsift
    from faldoi_tpu_torch.matchers.sift import sift_matches_files

    i0, i1, _, _ = syn.make_pair(160, 256, seed=53)
    f0, f1 = (_save_png(tmp_path / f"f{k}.png", im) for k, im in enumerate((i0, i1)))
    jsift(f0, f1, str(tmp_path / "j1.txt"), str(tmp_path / "j2.txt"), nspo=15)
    sift_matches_files(f0, f1, str(tmp_path / "p1.txt"), str(tmp_path / "p2.txt"),
                       nspo=15)
    for k in (1, 2):
        _same_text(tmp_path / f"j{k}.txt", tmp_path / f"p{k}.txt")
    assert len((tmp_path / "p1.txt").read_text().splitlines()) >= 10


def test_confidence_values_match_jax(tmp_path):
    from faldoi_tpu.matchers.rescore import confidence_values as jconf
    from faldoi_tpu_torch.matchers.rescore import confidence_values

    i0, i1, _, _ = syn.make_pair(436, 1024, seed=54)
    f0, f1 = (_save_png(tmp_path / f"f{k}.png", im) for k, im in enumerate((i0, i1)))
    outs = []
    for sub, fn in (("jax", jconf), ("port", confidence_values)):
        d = tmp_path / sub
        d.mkdir()
        m = shutil.copy(GOLDEN / "deep_mt_1.txt", d / "deep_mt_1.txt")
        outs.append(fn(f0, f1, str(m), str(d) + os.sep))
    assert Path(outs[1]).name == "deep_mt_1_saliency.txt"
    _same_text(*outs)
    assert len(Path(outs[1]).read_text().splitlines()) == 1703


# --- the drivers ----------------------------------------------------------

def _blob_pair(seed, n=60, margin=4):
    """Frames (3, H, W) of a textured canvas with ``n`` Gaussian blobs,
    frame 1 = frame 0 moved by FLOW; and the known fwd/bwd flows."""
    rng = np.random.default_rng(seed)
    ch, cw = H + 2 * margin, W + 2 * margin
    c = syn.make_pair(ch, cw, seed=seed)[0].astype(np.float64)
    yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float64)
    for _ in range(n):
        cy, cx, s = rng.uniform(0, ch), rng.uniform(0, cw), rng.uniform(1.5, 3)
        amp = rng.choice([-1, 1]) * rng.uniform(50, 100)
        c += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    c = np.clip(c, 0, 255)
    u, v = int(FLOW[0]), int(FLOW[1])
    i0 = c[:, margin:margin + H, margin:margin + W]
    i1 = c[:, margin - v:margin - v + H, margin - u:margin - u + W]
    gf = np.broadcast_to(np.float32(FLOW), (H, W, 2)).copy()
    return i0, i1, gf, -gf


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The 64x96 PNG pair, its frame list, and its known flows."""
    d = tmp_path_factory.mktemp("frames")
    i0, i1, gf, gb = _blob_pair(PAIR_SEED)
    names = [_save_png(d / f"frame_{k}.png", im) for k, im in enumerate((i0, i1))]
    (d / "ims.txt").write_text("\n".join(names) + "\n")
    return str(d / "ims.txt"), gf, gb


def _flows(res, tag):
    return (read_flo(os.path.join(res, f"frame_0_{tag}_rg.flo")),
            read_flo(os.path.join(res, f"frame_0_{tag}_var.flo")))


def _check_flows(port_res, jax_res, tag, gf):
    (prg, pvar), (jrg, jvar) = _flows(port_res, tag), _flows(jax_res, tag)
    assert np.isfinite(prg).all() and np.isfinite(jrg).all()    # 100% fill
    assert np.isfinite(pvar).all()
    assert syn.epe(prg, jrg) <= 0.05
    assert syn.epe(pvar, jvar) <= 0.01
    assert syn.epe(pvar, gf) < 0.1


@pytest.fixture(scope="module")
def jax_sift(exact_env, frames, tmp_path_factory):
    from faldoi_tpu.cli import faldoi_sift

    res = str(tmp_path_factory.mktemp("jax_sift")) + os.sep
    assert faldoi_sift.main([frames[0], "-vm", "1", "-res_path", res]) == 0
    return res


def test_faldoi_sift_matches_jax(jax_sift, frames, tmp_path):
    from faldoi_tpu_torch.cli import faldoi_sift

    res = str(tmp_path / "port") + os.sep
    empty = tmp_path / "no_binaries"
    empty.mkdir()
    stats = {}
    assert faldoi_sift.main([frames[0], "-vm", "1", "-device", "cpu", "-bsz",
                             "256", "-res_path", res, "-bin_dir", str(empty)],
                            stats=stats) == 0
    assert stats["matcher"].startswith("built-in")
    assert min(stats["matches"]) >= 10
    texts = sorted(f for f in os.listdir(jax_sift) if f.endswith(".txt"))
    assert texts == ["frame_0_sift_mt_1.txt", "frame_1_sift_mt_2.txt"]
    assert sorted(os.listdir(res)) == sorted(os.listdir(jax_sift))
    for f in texts:
        _same_text(jax_sift + f, res + f)
    for f in ("frame_0_sift_mt_1.flo", "frame_1_sift_mt_2.flo"):
        np.testing.assert_array_equal(read_flo(res + f), read_flo(jax_sift + f))
    _check_flows(res, jax_sift, "sift", frames[1])
    assert [s["it"] for s in stats["sweeps"]] == [0, 0, 1, 1, 2, 2, 3]
    assert set(stats["stages"]) >= {"sift matching", "local step", "global step"}


def _dm_stub(gf, gb):
    """deepmatch_both's stand-in: the golden DM lines whose source falls in
    the frame, their targets moved by the known flow."""

    def write(src, dest, flow):
        out = []
        for line in (GOLDEN / src).read_text().splitlines():
            x0, y0, _, _, score, idx = line.split()
            x, y = int(x0), int(y0)
            if x < W and y < H:
                u, v = flow[y, x]
                out.append(f"{x} {y} {x + u:.0f} {y + v:.0f} {score} {idx}\n")
        Path(dest).write_text("".join(out))

    def deepmatch_both(im0, im1, m1, m2, *args, **kwargs):
        write("deep_mt_1.txt", m1, gf)
        write("deep_mt_2.txt", m2, gb)

    return deepmatch_both


@pytest.fixture(scope="module")
def jax_deep(exact_env, frames, tmp_path_factory):
    import faldoi_tpu.cli.faldoi_deep as jdeep

    res = str(tmp_path_factory.mktemp("jax_deep")) + os.sep
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdeep, "deepmatch_both", _dm_stub(frames[1], frames[2]))
        assert jdeep.main([frames[0], "-vm", "1", "-res_path", res]) == 0
    return res


def test_faldoi_deep_matches_jax(jax_deep, frames, tmp_path, monkeypatch):
    import faldoi_tpu_torch.cli.faldoi_deep as pdeep

    monkeypatch.setattr(pdeep, "deepmatch_both", _dm_stub(frames[1], frames[2]))
    res = str(tmp_path / "port") + os.sep
    trace = tmp_path / "trace"
    assert pdeep.main([frames[0], "-vm", "1", "-device", "cpu", "-bsz", "256",
                       "-res_path", res, "-trace", str(trace)]) == 0
    assert (trace / "trace.json").stat().st_size > 0       # torch.profiler
    texts = sorted(f for f in os.listdir(jax_deep) if f.endswith(".txt"))
    assert len(texts) == 8          # 2 x (dm, saliency, _out, _out_cut)
    assert sorted(os.listdir(res)) == sorted(os.listdir(jax_deep))
    for f in texts:
        _same_text(jax_deep + f, res + f)
    _check_flows(res, jax_deep, "dm", frames[1])


def test_faldoi_deep_needs_a_deepmatching_binary(frames, tmp_path):
    from faldoi_tpu_torch.cli import faldoi_deep

    with pytest.raises(FileNotFoundError, match="deepmatching"):
        faldoi_deep.main([frames[0], "-device", "cpu", "-res_path",
                          str(tmp_path) + os.sep, "-bin_dir", str(tmp_path)])


def test_entry_points_import_neither_jax_nor_pil():
    """The drivers, matchers and the probe path import no JAX, no
    faldoi_tpu and no imaging library (the card's machine has none)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import faldoi_tpu_torch.cli.faldoi_sift\n"
            "import faldoi_tpu_torch.cli.faldoi_deep\n"
            "import faldoi_tpu_torch.cli.sparse_flow\n"
            "import faldoi_tpu_torch.cli.kernel_probe\n"
            "import faldoi_tpu_torch.matchers.sift, faldoi_tpu_torch.matchers.rescore\n"
            "import faldoi_tpu_torch.ops.probes, faldoi_tpu_torch.profiling\n"
            "bad = [m for m in ('jax', 'faldoi_tpu', 'PIL', 'imageio')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=GOLDEN.parent.parent)

"""The occlusion mask of the port's local step against faldoi_tpu's.

JAX sets ``out_chi = 1`` at every pixel of the forward lane that the FB
pruning distrusts, at each requeue, warm and cold, and (methods 0-7) no
sweep resets it; the CLI writes it as ``occlusions.png``.  The port keeps
the union of the forward lane's pruned masks and writes it the same way.
Method 0 with the warm requeue runs through both ``local_faldoi`` CLIs on
a PNG pair, whose ``occlusions.png`` must decode to the same array; method
1 with the cold requeue (a dial with no CLI flag in the port) through both
``match_growing`` functions, each mask written by its own package's
``save_image_int`` and decoded.  JAX runs in the repo's exact
configuration at bsz 256 (``FALDOI_GROW_BSZ``), at 31x43, a frame shape no
other test file traces."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import synthetic as syn
from faldoi_tpu_torch.io.flo import write_flo

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest", "FALDOI_GROW_BSZ": "256"}
H, W = 31, 43
LOC_IT = "2"


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A PNG pair with seeds on disk."""
    from PIL import Image

    d = tmp_path_factory.mktemp("occ")
    i0, i1, gf, gb = syn.make_pair(H, W, seed=81)
    rng = np.random.default_rng(82)
    names = []
    for k, im in enumerate((i0, i1)):
        names.append(str(d / f"f{k}.png"))
        Image.fromarray(np.round(im).astype(np.uint8).transpose(1, 2, 0)).save(names[-1])
    (d / "ims.txt").write_text("\n".join(names) + "\n")
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 25, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 25, rng), rng)
    write_flo(str(d / "go.flo"), go)
    write_flo(str(d / "ba.flo"), ba)
    return d, go, ba


def test_m0_warm_occlusions_png_match_jax(case):
    from faldoi_tpu.cli import local_faldoi as jcli
    from faldoi_tpu_torch.cli import local_faldoi

    d = case[0]
    args = [str(d / "ims.txt"), str(d / "go.flo"), str(d / "ba.flo")]
    assert jcli.main(args + [str(d / "jrg.flo"), str(d / "jsim.tiff"),
                             str(d / "jocc.png"), "-loc_it", LOC_IT]) == 0
    assert local_faldoi.main(args + [str(d / "rg.flo"), str(d / "sim.tiff"),
                                     str(d / "occ.png"), "-loc_it", LOC_IT,
                                     "-bsz", "256", "-device", "cpu"]) == 0
    got, want = _png(d / "occ.png"), _png(d / "jocc.png")
    assert got.dtype == want.dtype and got.shape == (H, W)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < H * W and set(np.unique(got)) <= {0, 1}


def test_m1_cold_occlusions_match_jax(case, tmp_path):
    from faldoi_tpu import params as JP
    from faldoi_tpu.core.match_growing import match_growing as jmatch
    from faldoi_tpu.core.preprocess import prepare_pair as jprepare
    from faldoi_tpu.io.image import read_image_split as jread
    from faldoi_tpu.io.image import save_image_int as jsave
    from faldoi_tpu_torch import params as P
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.io.image import save_image_int

    d, go, ba = case
    planes = [jread(str(d / f"f{k}.png")) for k in (0, 1)]
    jprm = JP.Parameters()
    jprm.val_method, jprm.iterations_of = JP.M_TVL1_W, int(LOC_IT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FALDOI_GROW_WARM_BAND", "0")
        _, _, jocc = jmatch(go, ba, *jprepare(*planes), jprm, bsz=256,
                            mode="fused")
    prm = P.Parameters()
    prm.val_method, prm.iterations_of = P.M_TVL1_W, int(LOC_IT)
    _, _, occ = match_growing(go, ba, *prepare_pair(*planes, device="cpu"), prm,
                              bsz=256, warm_band=0)
    jsave(str(tmp_path / "jocc.png"), np.asarray(jocc).astype(np.int32))
    save_image_int(str(tmp_path / "occ.png"), occ.numpy().astype(np.int32))
    got, want = _png(tmp_path / "occ.png"), _png(tmp_path / "jocc.png")
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < H * W

"""The port's whole main path against faldoi_tpu's, and its boundaries.

The slice: ``prepare_pair`` -> ``match_growing`` (m0, fused semantics,
bsz 256) -> ``tvl2_global`` on a synthetic 46x62 pair with 40 seeds per
direction (a shape no other test traces, so the JAX jit caches are built
under this module's exact configuration).  Growth is chaotic at the last
bit, so the slice is held by EPE against JAX: rg <= 0.05 px, var <= 0.01 px,
and both must fill 100% of the pixels.  The JAX growing runs once, in a
module-scoped fixture."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them (their spin-waits make the small ops
# of the port's CPU path tens of times slower)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EXACT_ENV = {"FALDOI_TOPK": "exact", "FALDOI_WSCATTER": "exact",
             "FALDOI_WSCATTER_R": "5", "FALDOI_BLOCKGATHER": "0",
             "FALDOI_WARP_PREC": "highest"}
H, W = 46, 62


@pytest.fixture(scope="module", autouse=True)
def exact_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in EXACT_ENV.items():
            mp.setenv(k, v)
        yield


@pytest.fixture(scope="module")
def pair():
    i0, i1, gf, gb = syn.make_pair(H, W, seed=3)
    rng = np.random.default_rng(5)
    go = syn.make_seeds(gf, syn.random_seed_positions(H, W, 40, rng), rng)
    ba = syn.make_seeds(gb, syn.random_seed_positions(H, W, 40, rng), rng)
    return i0, i1, go, ba, gf


@pytest.fixture(scope="module")
def jax_slice(exact_env, pair):
    from faldoi_tpu.core.global_step import tvl2_global
    from faldoi_tpu.core.match_growing import match_growing
    from faldoi_tpu.core.preprocess import prepare_pair

    i0, i1, go, ba, _ = pair
    a, b = prepare_pair(i0, i1)
    from faldoi_tpu import params as JP

    flow, _, _ = match_growing(go, ba, a, b, JP.Parameters(), bsz=256,
                               mode="fused")
    u1, u2 = tvl2_global(a, b, jnp.asarray(flow[..., 0]),
                         jnp.asarray(flow[..., 1]))
    return flow, np.stack([np.asarray(u1), np.asarray(u2)], -1)


@pytest.fixture(scope="module")
def port_slice(pair):
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair

    i0, i1, go, ba, _ = pair
    a, b = prepare_pair(i0, i1, device="cpu")
    stats = {}
    flow, _ = match_growing(go, ba, a, b, P.Parameters(), bsz=256, stats=stats)
    u1, u2 = tvl2_global(a, b, flow[..., 0], flow[..., 1])
    return flow.numpy(), torch.stack([u1, u2], -1).numpy(), stats


def test_slice_matches_jax(jax_slice, port_slice, pair):
    jrg, jvar = jax_slice
    prg, pvar, stats = port_slice
    assert np.isfinite(jrg).all() and np.isfinite(prg).all()    # 100% fill
    assert syn.epe(prg, jrg) <= 0.05
    assert syn.epe(pvar, jvar) <= 0.01
    # the drains ran in the fused order: 3 x (fwd, bwd) + final fwd
    assert [(s["it"], s["lane"]) for s in stats["sweeps"]] == [
        (0, "fwd"), (0, "bwd"), (1, "fwd"), (1, "bwd"), (2, "fwd"),
        (2, "bwd"), (3, "fwd")]
    # and both are a sane estimate of the known flow
    gf = pair[4]
    assert syn.epe(pvar, gf) < 1.0 and syn.epe(jvar, gf) < 1.0


def test_port_imports_neither_jax_nor_pil():
    code = ("import sys\n"
            "import faldoi_tpu_torch, faldoi_tpu_torch.models\n"
            "import faldoi_tpu_torch.core.match_growing\n"
            "import faldoi_tpu_torch.core.global_step\n"
            "import faldoi_tpu_torch.cli.local_faldoi\n"
            "import faldoi_tpu_torch.cli.global_faldoi\n"
            "import faldoi_tpu_torch.synthetic\n"
            "bad = [m for m in ('jax', 'faldoi_tpu', 'PIL', 'imageio')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    for src in (REPO / "faldoi_tpu_torch").rglob("*.py"):
        text = src.read_text()
        assert "import jax" not in text and "from jax" not in text, src


def test_params_equal_the_jax_packages():
    from faldoi_tpu import params as JP

    for name, value in vars(JP).items():
        if name.isupper():
            assert getattr(P, name) == value, name
    assert P.Parameters() == P.Parameters(**vars(JP.Parameters()))
    assert vars(P.init_params(None, P.LOCAL_STEP)) == vars(
        JP.init_params(None, JP.LOCAL_STEP))


def test_cuda_device_raises_without_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test is about hosts without")
    from faldoi_tpu_torch.core.preprocess import prepare_pair
    from faldoi_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        prepare_pair(pair[0], pair[1])          # the default device is cuda
    assert resolve_device("cpu").type == "cpu"


def test_cli_round_trip(tmp_path, pair):
    """local_faldoi then global_faldoi on tmp files, -device cpu: the
    artifacts equal the library calls'; other methods fail cleanly."""
    from PIL import Image

    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.core.global_step import tvl2_global
    from faldoi_tpu_torch.core.match_growing import match_growing
    from faldoi_tpu_torch.core.preprocess import prepare_pair, prepare_triple
    from faldoi_tpu_torch.io.flo import read_flo, write_flo
    from faldoi_tpu_torch.io.image import read_image_split

    i0, i1, go, ba, _ = pair
    crop = (slice(0, 30), slice(0, 40))
    names = []
    for k, im in enumerate((i0, i1)):
        path = tmp_path / f"f{k}.png"
        Image.fromarray(np.round(im[:, crop[0], crop[1]]).astype(np.uint8)
                        .transpose(1, 2, 0)).save(path)
        names.append(str(path))
    (tmp_path / "ims.txt").write_text("\n".join(names) + "\n")
    write_flo(str(tmp_path / "go.flo"), go[crop])
    write_flo(str(tmp_path / "ba.flo"), ba[crop])
    ims, out, sim, var = (str(tmp_path / x) for x in
                          ("ims.txt", "rg.flo", "sim.tiff", "var.flo"))
    assert local_faldoi.main([ims, str(tmp_path / "go.flo"),
                              str(tmp_path / "ba.flo"), out, sim,
                              "-device", "cpu"]) == 0
    assert global_faldoi.main([ims, out, var, "-device", "cpu"]) == 0

    planes = [read_image_split(n) for n in names]
    a, b = prepare_pair(*planes, device="cpu")
    flow, ene = match_growing(go[crop], ba[crop], a, b, P.Parameters())
    np.testing.assert_array_equal(read_flo(out), flow.numpy())
    np.testing.assert_allclose(read_image_split(sim)[0], ene.numpy())
    g0, g1, _ = prepare_triple(planes[0], planes[1], planes[1], device="cpu")
    u1, u2 = tvl2_global(g0, g1, flow[..., 0].contiguous(),
                         flow[..., 1].contiguous())
    np.testing.assert_array_equal(read_flo(var),
                                  torch.stack([u1, u2], -1).numpy())
    assert local_faldoi.main([ims, str(tmp_path / "go.flo"),
                              str(tmp_path / "ba.flo"), out, sim, "-m", "4",
                              "-device", "cpu"]) != 0
    assert global_faldoi.main([ims, out, var, "-m", "2", "-device", "cpu"]) != 0

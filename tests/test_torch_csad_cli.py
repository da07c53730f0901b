"""The port's stage and frames-to-flow CLIs with methods 4-7 and the
growing's throttle flags, on the CPU: ``local_faldoi -m k`` then ``global_faldoi -m k``
exit 0 for k = 4..7 with finite flows, and every throttle flag reaches
``match_growing`` (``local_faldoi``) or is passed on to ``local_faldoi``
(``faldoi_sift``, ``faldoi_deep``)."""

import numpy as np
import pytest
import torch

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch import synthetic as syn

# pytest-xdist runs several workers on few cores; torch's intra-op
# threads would oversubscribe them
torch.set_num_threads(1)

SH, SW = 16, 24
THROTTLE_ARGV = ["-delta", "0.1", "-delta_rel", "0.25", "-floor", "512",
                 "-floor_scale", "8", "-fs_hi", "4", "-qhi", "1000",
                 "-fs_late", "2", "-warm_band", "0", "-block", "16",
                 "-fill", "patch_rb"]
THROTTLES = dict(delta=0.1, delta_rel=0.25, floor=512, floor_scale=8,
                 floor_scale_hi=4, queue_hi=1000, floor_scale_late=2,
                 warm_band=0, block=16, fill="patch_rb")
DEFAULTS = dict(delta=0.05, delta_rel=0.5, floor=None, floor_scale=64,
                floor_scale_hi=0, queue_hi=1 << 30, floor_scale_late=None,
                warm_band=10, block=0, fill="patch")


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A 16x24 crop pair as .npy frames, with seeds, for the stage CLIs."""
    from faldoi_tpu_torch.io.flo import write_flo

    d = tmp_path_factory.mktemp("csad_cli")
    i0, i1, gf, gb = syn.make_pair(SH, SW, seed=131)
    rng = np.random.default_rng(132)
    names = []
    for k, im in enumerate((i0, i1)):
        names.append(str(d / f"f{k}.npy"))
        np.save(names[-1], np.round(im).astype(np.uint8).transpose(1, 2, 0))
    (d / "ims.txt").write_text("\n".join(names) + "\n")
    write_flo(str(d / "go.flo"), syn.make_seeds(
        gf, syn.random_seed_positions(SH, SW, 12, rng), rng))
    write_flo(str(d / "ba.flo"), syn.make_seeds(
        gb, syn.random_seed_positions(SH, SW, 12, rng), rng))
    return d, gf


@pytest.mark.parametrize("method", [P.M_TVCSAD, P.M_TVCSAD_W, P.M_NLTVCSAD,
                                    P.M_NLTVCSAD_W])
def test_stage_clis_run_csad_on_cpu(cli_case, method):
    from faldoi_tpu_torch.cli import global_faldoi, local_faldoi
    from faldoi_tpu_torch.io.flo import read_flo

    d, gf = cli_case
    rg, var = str(d / f"rg{method}.flo"), str(d / f"var{method}.flo")
    stats = {}
    assert local_faldoi.main([str(d / "ims.txt"), str(d / "go.flo"),
                              str(d / "ba.flo"), rg, str(d / f"sim{method}.tiff"),
                              "-m", str(method), "-loc_it", "1", "-bsz", "64",
                              "-device", "cpu"], stats=stats) == 0
    assert len(stats["sweeps"]) == 3
    assert global_faldoi.main([str(d / "ims.txt"), rg, var, "-m", str(method),
                               "-device", "cpu"], stats=stats) == 0
    assert len(stats["global_iters"]) == P.PAR_DEFAULT_NWARPS_GLOBAL
    flow = read_flo(var)
    assert np.isfinite(read_flo(rg)).all() and np.isfinite(flow).all()
    assert syn.epe(flow, gf) < 3.0


@pytest.mark.parametrize("given", [False, True], ids=["defaults", "flags"])
def test_local_cli_passes_the_throttles(cli_case, monkeypatch, given):
    """Each throttle flag of ``local_faldoi`` reaches ``match_growing`` as
    its keyword argument; without the flags, JAX's defaults do."""
    from faldoi_tpu_torch.cli import local_faldoi
    from faldoi_tpu_torch.core import match_growing as mg

    seen = {}

    def fake(go, ba, i0n, i1n, prm, *args, **kw):
        seen.update(kw)
        h, w = i0n.shape
        z = torch.zeros((h, w))
        return torch.zeros((h, w, 2)), z, z

    monkeypatch.setattr(mg, "match_growing", fake)
    d, _ = cli_case
    assert local_faldoi.main([str(d / "ims.txt"), str(d / "go.flo"),
                              str(d / "ba.flo"), str(d / "t.flo"),
                              str(d / "t.tiff"), "-m", "4", "-device", "cpu"]
                             + (THROTTLE_ARGV if given else [])) == 0
    want = THROTTLES if given else DEFAULTS
    assert {k: seen[k] for k in want} == want


@pytest.mark.parametrize("cli", ["faldoi_sift", "faldoi_deep"])
def test_frames_to_flow_clis_pass_the_throttles_on(cli):
    """The frames-to-flow CLIs take the throttle flags and pass the given
    ones on to ``local_faldoi`` as given."""
    import importlib

    from faldoi_tpu_torch.cli.faldoi_sift import throttle_argv
    from faldoi_tpu_torch.cli.local_faldoi import THROTTLE_FLAGS

    mod = importlib.import_module(f"faldoi_tpu_torch.cli.{cli}")
    args = mod.build_argparser().parse_args(["ims.txt", "-vm", "6"]
                                            + THROTTLE_ARGV)
    assert throttle_argv(args) == THROTTLE_ARGV
    assert len(THROTTLE_FLAGS) == len(THROTTLE_ARGV) // 2
    assert throttle_argv(mod.build_argparser().parse_args(["ims.txt"])) == []

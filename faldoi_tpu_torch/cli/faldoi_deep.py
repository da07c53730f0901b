"""End-to-end FALDOI driver with DeepMatching seeds on the port — reference
"Algorithm 2" (``scripts_python/faldoi_deep.py``), the contract of
``faldoi_tpu.cli.faldoi_deep`` plus ``-device`` and ``-bin_dir``::

    python -m faldoi_tpu_torch.cli.faldoi_deep imgs.txt [-vm 0|1] ... \
        [-threshold 0.045] [-nt 4] [-downscale 2] [-max_scale 1.414] \
        [-rot_plus 45] [-rot_minus 45] [-device cuda|cpu] [-bsz n] [-bin_dir dir]

The forward and backward ``deepmatching`` runs go as concurrent subprocesses
(the binary is looked up in ``-bin_dir``, else on ``PATH``; the port ships
none).  Their 6-column outputs ``{core1}_dm_mt_1.txt`` / ``{core2}_dm_mt_2.txt``
are rescored by the structure-tensor confidence (``*_saliency.txt``),
outlier-filtered (``*_saliency_out.txt``, default threshold 0.045), cut to 4
columns (``*_saliency_out_cut.txt``) and rasterised (``*_dm_mt_{1,2}.flo``);
then the local (``{core1}_dm_rg.flo``, ``{core1}_dm_sim.tiff``) and global
(``{core1}_dm_var.flo``) steps run on ``-device``.
"""

from __future__ import annotations

import argparse
import math
import os

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.cli.faldoi_sift import _run_pair, find_binary, run_local_global


def build_argparser():
    p = argparse.ArgumentParser(description="FALDOI optical flow, DeepMatching seeds")
    p.add_argument("file_images")
    p.add_argument("-vm", default="0")
    p.add_argument("-wr", default="5")
    p.add_argument("-local_iter", default=str(P.LOCAL_ITER))
    p.add_argument("-patch_iter", default=str(P.MAX_ITERATIONS_LOCAL))
    p.add_argument("-split_img", default="0")
    p.add_argument("-h_parts", default="3")
    p.add_argument("-v_parts", default="2")
    p.add_argument("-threshold", default="0.045",
                   help="outlier threshold on the DM confidence")
    p.add_argument("-fb_thresh", default=str(P.FB_TOL))
    p.add_argument("-partial_res", default="0")
    p.add_argument("-warps", default=str(P.PAR_DEFAULT_NWARPS_GLOBAL))
    p.add_argument("-glob_iter", default=str(P.MAX_ITERATIONS_GLOBAL))
    p.add_argument("-nt", default="4", help="deepmatching threads")
    p.add_argument("-downscale", default="2")
    p.add_argument("-max_scale", default=str(math.sqrt(2)))
    p.add_argument("-rot_plus", default="45")
    p.add_argument("-rot_minus", default="45")
    p.add_argument("-res_path", default="./")
    p.add_argument("-energy_params", default="")
    p.add_argument("-verbose", default="0")
    p.add_argument("-trace", default="", help="torch.profiler trace logdir")
    p.add_argument("-device", default="cuda", help="cuda or cpu")
    p.add_argument("-bsz", default="4096", help="the growing's batch size")
    p.add_argument("-bin_dir", default="",
                   help="directory of the deepmatching binary "
                        "(default: look it up on PATH)")
    return p


def _dm_cmd(dm, im0, im1, nt, downscale, max_scale, rot_minus, rot_plus):
    return [
        dm, im0, im1,
        "-nt", str(nt), "-downscale", str(downscale),
        "-max_scale", str(max_scale),
        "-rot_range", f"-{rot_minus}", f"+{rot_plus}",
    ]


def deepmatch_both(im0, im1, m1, m2, nt, downscale, max_scale,
                   rot_minus, rot_plus, bin_dir=""):
    """Fwd + bwd deepmatching as CONCURRENT subprocesses with the thread
    budget split between them (reference: multiprocessing.Pool with
    nt_fwd/nt_bwd, faldoi_deep.py:284-314; no gains beyond ~18 threads)."""
    dm = find_binary(bin_dir, "deepmatching")
    if not dm or not os.path.isfile(dm):
        raise FileNotFoundError(
            "deepmatching binary not found (pass -bin_dir DIR or put it on PATH)")
    nt = min(int(nt), 18)
    nt_fwd = max(nt - nt // 2, 1)
    nt_bwd = max(nt // 2, 1)
    _run_pair([
        (_dm_cmd(dm, im0, im1, nt_fwd, downscale, max_scale, rot_minus, rot_plus), m1),
        (_dm_cmd(dm, im1, im0, nt_bwd, downscale, max_scale, rot_minus, rot_plus), m2),
    ])


def main(argv=None, stats=None):
    """Run the driver; ``stats`` as in ``faldoi_sift.main``."""
    args = build_argparser().parse_args(argv)
    verbose = args.verbose not in ("0", "false", "False")
    from faldoi_tpu_torch.core.preprocess import read_frame_list
    from faldoi_tpu_torch.core.sparse import sparse_flow
    from faldoi_tpu_torch.io.flo import write_flo
    from faldoi_tpu_torch.io.image import read_image_split
    from faldoi_tpu_torch.matchers.matchlists import cut_deep_list, delete_outliers
    from faldoi_tpu_torch.matchers.rescore import confidence_values
    from faldoi_tpu_torch.profiling import StageTimer

    stats = {} if stats is None else stats
    timer = StageTimer(enabled=verbose)
    frames = read_frame_list(args.file_images)
    im0, im1 = frames[0], frames[1]

    res = args.res_path
    os.makedirs(res, exist_ok=True)
    core1 = os.path.splitext(os.path.basename(im0))[0]
    core2 = os.path.splitext(os.path.basename(im1))[0]
    height_im, width_im = read_image_split(im1).shape[1:]

    m1 = os.path.join(res, f"{core1}_dm_mt_1.txt")
    m2 = os.path.join(res, f"{core2}_dm_mt_2.txt")
    with timer.stage("deepmatching"):
        deepmatch_both(im0, im1, m1, m2, args.nt, args.downscale,
                       args.max_scale, args.rot_minus, args.rot_plus,
                       args.bin_dir)

    # confidence -> outlier filter -> 4-column cut (faldoi_deep.py:331-334)
    with timer.stage("match rescore/prune"):
        cuts = []
        for a, b, m in ((im0, im1, m1), (im1, im0, m2)):
            sal = confidence_values(a, b, m, res + os.sep)
            out = delete_outliers(sal, float(args.threshold))
            cuts.append(cut_deep_list(out))

    sp1 = os.path.join(res, f"{core1}_dm_mt_1.flo")
    sp2 = os.path.join(res, f"{core2}_dm_mt_2.flo")
    with timer.stage("sparse flow"):
        write_flo(sp1, sparse_flow(cuts[0], width_im, height_im))
        write_flo(sp2, sparse_flow(cuts[1], width_im, height_im))

    rc = run_local_global(
        args, sp1, sp2, os.path.join(res, f"{core1}_dm_rg.flo"),
        os.path.join(res, f"{core1}_dm_sim.tiff"),
        os.path.join(res, f"{core1}_dm_var.flo"), timer, stats)
    stats["stages"] = dict(timer.spans)
    timer.report()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end FALDOI with occlusion estimation (method 8) on the port
— reference ``scripts_python/faldoi_deep_occ.py``, the contract of
``faldoi_tpu.cli.faldoi_deep_occ`` plus ``faldoi_deep``'s ``-device``,
``-bsz``, ``-bin_dir`` and throttle flags::

    python -m faldoi_tpu_torch.cli.faldoi_deep_occ imgs4.txt [-vm 8] \
        [-fb_thresh 13] [faldoi_deep's flags]

The frame list holds four frames, I0, I1, I-1, I2.  DeepMatching runs on
(I0, I1) both ways (``faldoi_deep.deepmatch_both``), the matches are
rescored, filtered, cut and rasterised as in ``faldoi_deep``; then the local
step writes ``{core1}_dm_rg.flo``, ``{core1}_dm_sim.tiff`` and the local
occlusion mask ``{core1}_dm_rg_occ.png``, and the global step, started from
that mask, writes ``{core1}_dm_var.flo`` and ``{core1}_dm_var_occ.png``.
The defaults differ from ``faldoi_deep`` in ``-vm 8`` and ``-fb_thresh 13``
(faldoi_deep_occ.py:43-49, scripts_python/README.txt:88-91).
"""

from __future__ import annotations

import os
import sys

from faldoi_tpu_torch.cli.faldoi_deep import build_argparser, deepmatch_both


def main(argv=None, stats=None):
    """Run the pipeline; ``stats`` as in ``faldoi_sift.main``."""
    parser = build_argparser()
    parser.set_defaults(vm="8", fb_thresh="13")
    args = parser.parse_args(argv)
    verbose = args.verbose not in ("0", "false", "False")
    from faldoi_tpu_torch.cli.faldoi_sift import run_local_global
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
    if len(frames) != 4:
        print("occlusion estimation needs 4 frames: I0, I1, I-1, I2",
              file=sys.stderr)
        return 1
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

    occ = (os.path.join(res, f"{core1}_dm_rg_occ.png"),
           os.path.join(res, f"{core1}_dm_var_occ.png"))
    rc = run_local_global(
        args, sp1, sp2, os.path.join(res, f"{core1}_dm_rg.flo"),
        os.path.join(res, f"{core1}_dm_sim.tiff"),
        os.path.join(res, f"{core1}_dm_var.flo"), timer, stats, occ=occ)
    stats["stages"] = dict(timer.spans)
    timer.report()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end FALDOI driver with SIFT seeds on the port — reference
"Algorithm 1" (``scripts_python/faldoi_sift.py``), the contract of
``faldoi_tpu.cli.faldoi_sift`` plus ``-device`` and ``-bin_dir``::

    python -m faldoi_tpu_torch.cli.faldoi_sift imgs.txt [-vm 0..8] [-wr 5] \
        [-local_iter n] [-patch_iter n] [-fb_thresh eps] [-partial_res v] \
        [-warps n] [-glob_iter n] [-nsp n] [-res_path dir/] \
        [-energy_params file] [-verbose v] [-trace dir] \
        [-device cuda|cpu] [-bsz n] [-bin_dir dir] [throttles]

``[throttles]`` are the growing's flags of ``local_faldoi`` (``-delta``,
``-delta_rel``, ``-floor``, ``-floor_scale``, ``-fs_hi``, ``-qhi``,
``-fs_late``, ``-warm_band``, ``-block``, ``-fill``), passed to it as given;
each is the counterpart of JAX's ``FALDOI_GROW_*`` knob of its name.

Artifacts (``core1``/``core2`` are the frames' base names):
``{core1}_sift_mt_1.txt`` / ``{core2}_sift_mt_2.txt`` (4-column matches),
``{core1}_sift_mt_1.flo`` / ``{core2}_sift_mt_2.flo`` (sparse seeds),
``{core1}_sift_rg.flo`` + ``{core1}_sift_sim.tiff`` (local step) and
``{core1}_sift_var.flo`` (global step).

The matches come from the vendored ``sift_cli``/``match_cli`` binaries when
they run here (looked up in ``-bin_dir``, else on ``PATH``), and from the
built-in matcher (``faldoi_tpu_torch.matchers.sift``) otherwise, as in JAX;
the driver prints which one ran.  This is a choice of host matcher; the
local and global steps run on ``-device``.  Frames may be PNG or ``.npy``;
their size comes from the frames' planes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from faldoi_tpu_torch import params as P


def build_argparser():
    p = argparse.ArgumentParser(description="FALDOI optical flow, SIFT seeds")
    p.add_argument("file_images", help="txt file with the input frame paths")
    p.add_argument("-vm", default="0", help="variational method id (0-8)")
    p.add_argument("-wr", default="5", help="windows radius")
    p.add_argument("-local_iter", default=str(P.LOCAL_ITER))
    p.add_argument("-patch_iter", default=str(P.MAX_ITERATIONS_LOCAL))
    p.add_argument("-split_img", default="0")
    p.add_argument("-h_parts", default="3")
    p.add_argument("-v_parts", default="2")
    p.add_argument("-fb_thresh", default=str(P.FB_TOL))
    p.add_argument("-partial_res", default="0")
    p.add_argument("-warps", default=str(P.PAR_DEFAULT_NWARPS_GLOBAL))
    p.add_argument("-glob_iter", default=str(P.MAX_ITERATIONS_GLOBAL))
    p.add_argument("-nsp", default="15", help="SIFT scales per octave")
    p.add_argument("-res_path", default="./", help="output directory")
    p.add_argument("-energy_params", default="", help="9-line params file")
    p.add_argument("-verbose", default="0")
    p.add_argument("-trace", default="", help="torch.profiler trace logdir")
    p.add_argument("-device", default="cuda", help="cuda or cpu")
    p.add_argument("-bsz", default="4096", help="the growing's batch size")
    p.add_argument("-bin_dir", default="",
                   help="directory of the vendored matcher binaries "
                        "(default: look them up on PATH)")
    add_throttle_args(p)
    return p



def add_throttle_args(p):
    """The throttle flags, passed on to ``local_faldoi`` when given (its
    defaults are JAX's)."""
    from faldoi_tpu_torch.cli.local_faldoi import THROTTLE_FLAGS

    for name, knob in THROTTLE_FLAGS.items():
        p.add_argument("-" + name, default=None,
                       help=f"growing throttle, local_faldoi -{name} "
                            f"(JAX: {knob})")


def throttle_argv(args) -> list:
    """The throttle flags that were given, as ``local_faldoi`` arguments."""
    from faldoi_tpu_torch.cli.local_faldoi import THROTTLE_FLAGS

    out = []
    for name in THROTTLE_FLAGS:
        val = getattr(args, name)
        if val is not None:
            out += ["-" + name, val]
    return out


def find_binary(bin_dir: str, name: str) -> str:
    """Path of a vendored binary: in ``bin_dir`` if given, else on PATH
    ("" when absent)."""
    if bin_dir:
        return os.path.join(bin_dir, name)
    return shutil.which(name) or ""


def _runnable(path):
    if not path or not os.path.isfile(path):
        return False
    try:
        r = subprocess.run([path], capture_output=True, timeout=10)
        # 126/127: loader/permission failures (e.g. the vendored binaries
        # need libpng12 / newer ISAs than the host provides)
        return r.returncode not in (126, 127)
    except (OSError, subprocess.TimeoutExpired):
        return False


def _run_pair(jobs):
    """Run [(cmd, stdout_path), ...] concurrently; raise on any failure.

    All siblings are waited on (and reaped) before raising, and stdout
    handles are always closed — a mid-loop Popen failure terminates the
    already-started processes instead of orphaning them."""
    procs = []
    try:
        for cmd, out in jobs:
            fh = open(out, "w")
            try:
                procs.append((subprocess.Popen(cmd, stdout=fh), fh, cmd))
            except Exception:
                fh.close()
                raise
        rcs = [(p.wait(), cmd) for p, _fh, cmd in procs]
        for rc, cmd in rcs:
            if rc != 0:
                raise subprocess.CalledProcessError(rc, cmd)
    finally:
        for p, fh, _cmd in procs:
            if p.poll() is None:
                p.terminate()
                p.wait()
            fh.close()


def compute_sift_matches(im0, im1, nsp, res, core1, core2, bin_dir=""):
    """sift_cli x2 + match_cli x2 + column reorder (faldoi_sift.py:235-284)
    when the vendored binaries run, else the built-in matcher.  Returns the
    two 4-column match files and the name of the matcher that ran."""
    from faldoi_tpu_torch.matchers.matchlists import cut_matching_list

    sift_cli = find_binary(bin_dir, "sift_cli")
    match_cli = find_binary(bin_dir, "match_cli")
    d1 = os.path.join(res, f"{core1}_sift_desc_1.txt")
    d2 = os.path.join(res, f"{core2}_sift_desc_2.txt")
    m1 = os.path.join(res, f"{core1}_sift_mt_1.txt")
    m2 = os.path.join(res, f"{core2}_sift_mt_2.txt")

    if _runnable(sift_cli) and _runnable(match_cli):
        # fwd/bwd run as concurrent subprocesses, as the reference drivers'
        # multiprocessing.Pool(2) does (scripts_python/faldoi_sift.py:240-262)
        _run_pair([([sift_cli, im, "-ss_nspo", str(nsp)], d)
                   for im, d in ((im0, d1), (im1, d2))])
        _run_pair([([match_cli, a, b], m)
                   for a, b, m in ((d1, d2, m1), (d2, d1, m2))])
        return cut_matching_list(m1), cut_matching_list(m2), f"sift_cli ({sift_cli})"

    from faldoi_tpu_torch.matchers.sift import sift_matches_files

    c1, c2 = sift_matches_files(im0, im1, m1, m2, nspo=int(nsp))
    return c1, c2, "built-in (faldoi_tpu_torch.matchers.sift)"


def count_lines(path: str) -> int:
    with open(path) as fh:
        return sum(1 for ln in fh if ln.strip())


def run_local_global(args, sp1, sp2, rg, sim, var, timer, stats, occ=()):
    """The local and global stage CLIs on the seeds (shared by the
    frames-to-flow entry points); returns the first non-zero exit code, or
    0.  ``occ``: the occlusion masks (rg_occ, var_occ) of method 8, or ()."""
    from faldoi_tpu_torch.cli import global_faldoi as global_cli
    from faldoi_tpu_torch.cli import local_faldoi as local_cli
    from faldoi_tpu_torch.profiling import device_trace

    with device_trace(args.trace or None):
        with timer.stage("local step"):
            rc = local_cli.main(
                [args.file_images, sp1, sp2, rg, sim, *occ[:1],
                 "-m", args.vm, "-wr", args.wr, "-p", args.energy_params,
                 "-loc_it", args.local_iter, "-max_pch_it", args.patch_iter,
                 "-split_img", args.split_img, "-h_parts", args.h_parts,
                 "-v_parts", args.v_parts, "-fb_thresh", args.fb_thresh,
                 "-partial_res", args.partial_res, "-verbose", args.verbose,
                 "-device", args.device, "-bsz", args.bsz,
                 *throttle_argv(args)], stats=stats)
        if rc:
            return rc
        with timer.stage("global step"):
            rc = global_cli.main(
                [args.file_images, rg, var, *occ,
                 "-m", args.vm, "-w", args.warps, "-p", args.energy_params,
                 "-glb_iters", args.glob_iter, "-verbose", args.verbose,
                 "-device", args.device], stats=stats)
    return rc


def main(argv=None, stats=None):
    """Run the driver.  ``stats`` (a dict, optional) receives the stage
    seconds (``"stages"``), the matcher and match counts, and the growing's
    and global step's counters."""
    args = build_argparser().parse_args(argv)
    verbose = args.verbose not in ("0", "false", "False")
    from faldoi_tpu_torch.core.preprocess import read_frame_list
    from faldoi_tpu_torch.core.sparse import sparse_flow
    from faldoi_tpu_torch.io.flo import write_flo
    from faldoi_tpu_torch.io.image import read_image_split
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

    with timer.stage("sift matching"):
        cut1, cut2, matcher = compute_sift_matches(
            im0, im1, args.nsp, res, core1, core2, args.bin_dir)
    stats["matcher"] = matcher
    stats["matches"] = [count_lines(cut1), count_lines(cut2)]
    print(f"(sift) matcher: {matcher}; {stats['matches'][0]} fwd / "
          f"{stats['matches'][1]} bwd matches", file=sys.stderr)

    sp1 = os.path.join(res, f"{core1}_sift_mt_1.flo")
    sp2 = os.path.join(res, f"{core2}_sift_mt_2.flo")
    with timer.stage("sparse flow"):
        write_flo(sp1, sparse_flow(cut1, width_im, height_im))
        write_flo(sp2, sparse_flow(cut2, width_im, height_im))

    rc = run_local_global(
        args, sp1, sp2, os.path.join(res, f"{core1}_sift_rg.flo"),
        os.path.join(res, f"{core1}_sift_sim.tiff"),
        os.path.join(res, f"{core1}_sift_var.flo"), timer, stats)
    stats["stages"] = dict(timer.spans)
    timer.report()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

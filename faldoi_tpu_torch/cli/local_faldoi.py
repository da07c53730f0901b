"""CLI for the local step on the port — the contract of
``faldoi_tpu.cli.local_faldoi`` (local_faldoi.cpp:1756-2111) plus ``-device``:

    python -m faldoi_tpu_torch.cli.local_faldoi ims.txt in0.flo in1.flo \
        out.flo sim_map.tiff [occlusions.png] [sal0.tiff sal1.tiff] \
        [-m method] [-wr radius] [-p params] [-loc_it n] [-max_pch_it n] \
        [-split_img 0/1] [-h_parts n] [-v_parts n] [-fb_thresh eps] \
        [-partial_res v] [-verbose v] [-device cuda|cpu] [-bsz n] \
        [-delta d] [-delta_rel r] [-floor n] [-floor_scale n] [-fs_hi n] \
        [-qhi n] [-fs_late n] [-warm_band px] [-block n] [-fill f] \
        [-relax_late 0/1] [-exactmin px] [-exactmin_band 0/1/2] [-defer px] \
        [-defer_win px] [-polish n]

Methods 0-8: TV-L1, NLTV-L1, TV-CSAD and NLTV-CSAD, each plain and
weighted, and TV-L1 with occlusions (8), which takes a four-frame list (I0,
I1, I-1, I2; with two frames it falls back to method 0, as JAX does).
``occlusions.png`` holds the forward growing's chi for method 8, and for the
others the pixels that the FB pruning distrusted in any outer iteration, as
JAX writes them (``.npy`` as well, without an imaging library).  ``-partial_res 1`` writes the forward growing's snapshots to
``partial_results/partial_fwd_{30,70,80,95}_iter_{it}.flo`` under the working
directory, as the JAX CLI does.  ``-bsz`` is the growing's batch size (the
counterpart of JAX's ``FALDOI_GROW_BSZ``; default 4096, as there).

The growing's throttles (``match_growing``'s arguments), each the
counterpart of a JAX environment knob, with JAX's defaults:

* ``-delta`` (``FALDOI_GROW_DELTA``, 0.05) and ``-delta_rel``
  (``FALDOI_GROW_DELTA_REL``, 0.5): the acceptance band e_min + max(delta,
  delta_rel * e_min);
* ``-floor`` (``FALDOI_GROW_FLOOR``, 4096): the cap of the rank floor;
* ``-floor_scale`` (``FALDOI_GROW_FLOOR_SCALE``, 64): the floor's divisor in
  outer iteration 0, min(floor, queue // floor_scale);
* ``-fs_hi`` (``FALDOI_GROW_FS_HI``, 0 = off) and ``-qhi``
  (``FALDOI_GROW_QHI``, 2^30): the divisor once the queue holds qhi
  candidates;
* ``-fs_late`` (``FALDOI_GROW_FS_LATE``; default min(floor_scale, 16)): the
  divisor of the requeue and final drains;
* ``-warm_band`` (``FALDOI_GROW_WARM_BAND``, 10 px; 0 = the cold requeue);
* ``-block`` (``FALDOI_GROW_BLOCK``, 0 = off): block-local bands on
  block x block tiles;
* ``-fill`` (``FALDOI_GROW_FILL``, ``patch``): the patch fill, ``patch``
  (exact for methods 4-7, red-black otherwise), ``patch_exact`` or
  ``patch_rb``, or ``dense`` (one whole-image nearest fill a sweep).

The ordering modes (``match_growing``'s arguments), each the counterpart of
a JAX environment knob, off by default:

* ``-relax_late`` (``FALDOI_GROW_RELAX_LATE``, 0): label-correcting relax in
  the drains of iterations >= 1 and the final one;
* ``-exactmin`` (``FALDOI_GROW_EXACTMIN``, 0 = off) and ``-exactmin_band``
  (``FALDOI_GROW_EXACTMIN_BAND``, 0): accept only the candidates that hold
  their exactmin x exactmin window's minimum, with no band (0), the delta
  band (1) or the band or the rank floor (2);
* ``-defer`` (``FALDOI_GROW_DEFER``, 0 = off) and ``-defer_win``
  (``FALDOI_GROW_DEFER_WIN``, 0 = the patch side): defer the accepts whose
  window holds a lower accept while its flows spread by more than defer px;
* ``-polish`` (``FALDOI_GROW_POLISH``, 0): re-polish passes of every fixed
  pixel after the drains of iterations >= 1 and after the final drain.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.cli.global_faldoi import (
    NOT_PORTED, PORTED_METHODS, pick_option,
)


# the growing's throttle flags: name -> JAX's environment knob
THROTTLE_FLAGS = {
    "delta": "FALDOI_GROW_DELTA", "delta_rel": "FALDOI_GROW_DELTA_REL",
    "floor": "FALDOI_GROW_FLOOR", "floor_scale": "FALDOI_GROW_FLOOR_SCALE",
    "fs_hi": "FALDOI_GROW_FS_HI", "qhi": "FALDOI_GROW_QHI",
    "fs_late": "FALDOI_GROW_FS_LATE", "warm_band": "FALDOI_GROW_WARM_BAND",
    "block": "FALDOI_GROW_BLOCK", "fill": "FALDOI_GROW_FILL",
}
# the growing's ordering-mode flags: name -> JAX's environment knob
ORDERING_FLAGS = {
    "relax_late": "FALDOI_GROW_RELAX_LATE", "exactmin": "FALDOI_GROW_EXACTMIN",
    "exactmin_band": "FALDOI_GROW_EXACTMIN_BAND", "defer": "FALDOI_GROW_DEFER",
    "defer_win": "FALDOI_GROW_DEFER_WIN", "polish": "FALDOI_GROW_POLISH",
}


def throttle_options(args) -> dict:
    """Take the throttle flags out of ``args``: ``match_growing``'s keyword
    arguments (see the module's docstring)."""
    floor = pick_option(args, "floor", "")
    fs_late = pick_option(args, "fs_late", "")
    return dict(
        delta=float(pick_option(args, "delta", "0.05")),
        delta_rel=float(pick_option(args, "delta_rel", "0.5")),
        floor=int(floor) if floor else None,
        floor_scale=int(pick_option(args, "floor_scale", "64")),
        floor_scale_hi=int(pick_option(args, "fs_hi", "0")),
        queue_hi=int(pick_option(args, "qhi", str(1 << 30))),
        floor_scale_late=int(fs_late) if fs_late else None,
        warm_band=int(pick_option(args, "warm_band", "10")),
        block=int(pick_option(args, "block", "0")),
        fill=pick_option(args, "fill", "patch"))


def ordering_options(args) -> dict:
    """Take the ordering-mode flags out of ``args``: ``match_growing``'s
    keyword arguments (see the module's docstring)."""
    return dict(
        relax_late=pick_option(args, "relax_late", "0") not in ("0", ""),
        exactmin=int(pick_option(args, "exactmin", "0")),
        exactmin_band=pick_option(args, "exactmin_band", "0"),
        defer=float(pick_option(args, "defer", "0")),
        defer_win=int(pick_option(args, "defer_win", "0")),
        polish=int(pick_option(args, "polish", "0")))


def main(argv=None, stats=None):
    """Run the CLI; ``stats`` (a dict, optional) receives the growing's
    counters (``match_growing(stats=)``)."""
    from faldoi_tpu_torch.core.preprocess import (
        prepare_pair, prepare_quad, read_frame_list,
    )
    from faldoi_tpu_torch.io.flo import read_flo, write_flo
    from faldoi_tpu_torch.io.image import (
        read_image_split, save_image_float, save_image_int,
    )

    args = list(sys.argv[1:] if argv is None else argv)
    wr = int(pick_option(args, "wr", str(P.PAR_DEFAULT_WINSIZE)))
    method = int(pick_option(args, "m", str(P.M_TVL1)))
    file_params = pick_option(args, "p", "")
    loc_it = int(pick_option(args, "loc_it", str(P.LOCAL_ITER)))
    max_pch_it = int(pick_option(args, "max_pch_it", str(P.MAX_ITERATIONS_LOCAL)))
    split_img = int(pick_option(args, "split_img", "0"))
    h_parts = int(pick_option(args, "h_parts", str(P.HOR_PARTS)))
    v_parts = int(pick_option(args, "v_parts", str(P.VER_PARTS)))
    fb_thresh = float(pick_option(args, "fb_thresh", str(P.FB_TOL)))
    partial_res = int(pick_option(args, "partial_res", "0"))
    verbose = pick_option(args, "verbose", "0") not in ("0", "false", "False")
    device = pick_option(args, "device", "cuda")
    bsz = int(pick_option(args, "bsz", "4096"))
    throttles = throttle_options(args)
    throttles.update(ordering_options(args))

    if len(args) < 5 or len(args) > 8:
        print(__doc__, file=sys.stderr)
        return 1

    names = read_frame_list(args[0])
    go = read_flo(args[1])
    ba = read_flo(args[2])
    out_path, sim_path = args[3], args[4]
    occ_path = None
    sal_paths = None
    if len(args) == 6:
        occ_path = args[5]
    elif len(args) == 7:
        sal_paths = (args[5], args[6])
    elif len(args) == 8:
        occ_path = args[5]
        sal_paths = (args[6], args[7])

    if method == P.M_TVL1_OCC and len(names) == 2:
        print("Since only two images given, method is changed to TV-l2 coupled",
              file=sys.stderr)
        method = P.M_TVL1
    if method not in PORTED_METHODS:
        print(f"ERROR: unknown method {method} ({NOT_PORTED})", file=sys.stderr)
        return 2

    prm = P.init_params(file_params, P.LOCAL_STEP)
    prm.val_method = method
    prm.w_radio = wr
    prm.iterations_of = loc_it
    prm.max_iter_patch = max_pch_it
    prm.split_img = split_img
    prm.h_parts = h_parts
    prm.v_parts = v_parts
    prm.epsilon = fb_thresh
    prm.part_res = partial_res
    prm.verbose = verbose

    planes = [read_image_split(n) for n in names]
    hw = planes[0].shape[1:]
    for pl in planes[1:]:
        if pl.shape[1:] != hw:
            print("ERROR: input images size mismatch", file=sys.stderr)
            return 1
    for name, fl in (("in0", go), ("in1", ba)):
        if fl.ndim != 3 or fl.shape[2] != 2 or fl.shape[:2] != hw:
            print(f"ERROR: input flow field size mismatch ({name}: {fl.shape} "
                  f"vs frames {hw})", file=sys.stderr)
            return 1
    sal = [None, None]
    if sal_paths:
        sal = [read_image_split(s)[0] for s in sal_paths]
        if sal[0].shape != hw or sal[1].shape != hw:
            print("ERROR: saliency size mismatch", file=sys.stderr)
            return 1

    from faldoi_tpu_torch.core.match_growing import match_growing

    t0 = time.time()
    quad = {}
    if method == P.M_TVL1_OCC:
        i0n, i1n, i_1n, i2n = prepare_quad(*planes[:4], device=device)
        quad = dict(i_1n=i_1n, i2n=i2n)
    else:
        i0n, i1n = prepare_pair(planes[0], planes[1], device=device)
    flow, ene, occ = match_growing(
        go, ba, i0n, i1n, prm, sal[0], sal[1], bsz=bsz, stats=stats,
        snapshot_dir="partial_results" if partial_res else None,
        i0_planes=planes[0], i1_planes=planes[1], **throttles, **quad)
    flow, ene, occ = flow.cpu().numpy(), ene.cpu().numpy(), occ.cpu().numpy()
    if verbose:
        print(f"(local) match growing took {time.time() - t0:.2f}s on "
              f"{i0n.device}", file=sys.stderr)
    write_flo(out_path, flow)
    save_image_float(sim_path, ene)
    if occ_path is not None:
        save_image_int(occ_path, occ.astype(np.int32))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

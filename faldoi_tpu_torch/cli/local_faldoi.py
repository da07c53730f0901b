"""CLI for the local step on the port — the contract of
``faldoi_tpu.cli.local_faldoi`` (local_faldoi.cpp:1756-2111) plus ``-device``:

    python -m faldoi_tpu_torch.cli.local_faldoi ims.txt in0.flo in1.flo \
        out.flo sim_map.tiff [occlusions.png] [sal0.tiff sal1.tiff] \
        [-m method] [-wr radius] [-p params] [-loc_it n] [-max_pch_it n] \
        [-split_img 0/1] [-h_parts n] [-v_parts n] [-fb_thresh eps] \
        [-partial_res v] [-verbose v] [-device cuda|cpu] [-bsz n]

Methods 0 (TV-L1) and 1 (weighted TV-L1) are ported; other methods exit
with code 2.  ``-partial_res 1`` writes the forward growing's snapshots to
``partial_results/partial_fwd_{30,70,80,95}_iter_{it}.flo`` under the working
directory, as the JAX CLI does.  ``-bsz`` is the growing's batch size (the
counterpart of JAX's ``FALDOI_GROW_BSZ``; default 4096, as there).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from faldoi_tpu_torch import params as P
from faldoi_tpu_torch.cli.global_faldoi import PORTED_METHODS, pick_option


def main(argv=None, stats=None):
    """Run the CLI; ``stats`` (a dict, optional) receives the growing's
    counters (``match_growing(stats=)``)."""
    from faldoi_tpu_torch.core.preprocess import prepare_pair, read_frame_list
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
        print(f"ERROR: method {method} not ported yet (the port runs methods "
              "0, TV-L1, and 1, weighted TV-L1)", file=sys.stderr)
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
    i0n, i1n = prepare_pair(planes[0], planes[1], device=device)
    flow, ene = match_growing(
        go, ba, i0n, i1n, prm, sal[0], sal[1], bsz=bsz, stats=stats,
        snapshot_dir="partial_results" if partial_res else None)
    flow, ene = flow.cpu().numpy(), ene.cpu().numpy()
    if verbose:
        print(f"(local) match growing took {time.time() - t0:.2f}s on "
              f"{i0n.device}", file=sys.stderr)
    write_flo(out_path, flow)
    save_image_float(sim_path, ene)
    if occ_path is not None:
        save_image_int(occ_path, np.zeros(ene.shape, np.int32))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

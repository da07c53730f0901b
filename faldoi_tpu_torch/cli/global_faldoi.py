"""CLI for the global variational refinement on the port — the contract of
``faldoi_tpu.cli.global_faldoi`` (``global_faldoi.cpp:1846-2213``) plus
``-device``:

    python -m faldoi_tpu_torch.cli.global_faldoi ims.txt in_flow.flo out.flo \
        [occl_input.png occl_out.png] [-m method] [-w warps] [-p params_file] \
        [-glb_iters iters] [-verbose v] [-device cuda|cpu]

Methods 0-8: 0 (TV-L1), 1 (weighted TV-L1, whose global step is the TV-L1
one), 2 (NLTV-L1), 3 (weighted NLTV-L1, whose global step is the NLTV-L1
one), 4 (TV-CSAD), 5 (weighted TV-CSAD, the TV-CSAD global step), 6
(NLTV-CSAD), 7 (weighted NLTV-CSAD, the NLTV-CSAD global step) and 8 (TV-L1
with occlusions) from a four-frame list (I0, I1, I-1, I2; with two frames
method 8 falls back to 0): it starts chi from ``occl_input.png`` (read as a
float plane) and writes the final chi to ``occl_out.png`` (0/1), its PD cap
per warp is ``-glb_iters``.  The other methods write no ``occl_out``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from faldoi_tpu_torch import params as P

# the methods the port runs
PORTED_METHODS = tuple(range(P.M_TVL1_OCC + 1))
NOT_PORTED = ("the methods are 0-8: TV-L1, NLTV-L1, TV-CSAD and NLTV-CSAD, "
              "each plain and weighted, and TV-L1 with occlusions")


def pick_option(args, name, default):
    """Erase-style flag parser (utils_preprocess.cpp:21-35)."""
    flag = "-" + name
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            val = args[i + 1]
            del args[i : i + 2]
            return val
    return default


def main(argv=None, stats=None):
    """Run the CLI; ``stats`` (a dict, optional) receives the global step's
    counters (``*_global(stats=)``) and ``global_seconds``, the host's
    seconds for reading the inputs, preparing the frames (the card has
    finished them), the solve with its download, and writing the result."""
    from faldoi_tpu_torch.core.preprocess import prepare_triple, read_frame_list
    from faldoi_tpu_torch.io.flo import read_flo, write_flo
    from faldoi_tpu_torch.io.image import read_image_split, save_image_int

    args = list(sys.argv[1:] if argv is None else argv)
    warps = int(pick_option(args, "w", str(P.PAR_DEFAULT_NWARPS_GLOBAL)))
    method = int(pick_option(args, "m", str(P.M_TVL1)))
    file_params = pick_option(args, "p", "")
    glb_iters = int(pick_option(args, "glb_iters", str(P.MAX_ITERATIONS_GLOBAL)))
    verbose = pick_option(args, "verbose", "0") not in ("0", "false", "False")
    device = pick_option(args, "device", "cuda")

    if len(args) not in (3, 5):
        print(__doc__, file=sys.stderr)
        return 1

    t_read = time.perf_counter()
    names = read_frame_list(args[0])
    in_flow = read_flo(args[1])
    outfile = args[2]
    # occl_out: only method 8 has an occlusion output (as in JAX)
    occ_in = args[3] if len(args) == 5 else None
    occ_out = args[4] if len(args) == 5 else None

    i0p = read_image_split(names[0])
    i1p = read_image_split(names[1])
    i_1p = read_image_split(names[2] if len(names) == 4 else names[1])
    if i1p.shape != i0p.shape or i_1p.shape != i0p.shape:
        print("ERROR: input images size mismatch", file=sys.stderr)
        return 1
    hw = i0p.shape[1:]
    if in_flow.ndim != 3 or in_flow.shape[2] != 2 or in_flow.shape[:2] != hw:
        print(f"ERROR: input flow field size mismatch ({in_flow.shape} vs "
              f"frames {hw})", file=sys.stderr)
        return 1

    if method == P.M_TVL1_OCC and len(names) == 2:
        print("Since only two images given, method is changed to TV-l2 coupled",
              file=sys.stderr)
        method = P.M_TVL1
    if method not in PORTED_METHODS:
        print(f"ERROR: unknown method {method} ({NOT_PORTED})", file=sys.stderr)
        return 2

    prm = P.init_params(file_params, P.GLOBAL_STEP)
    prm.warps = warps
    prm.val_method = method
    prm.iterations_of = glb_iters
    prm.verbose = verbose

    from faldoi_tpu_torch.models import global_refine

    occ0 = read_image_split(occ_in)[0] if occ_in is not None else None
    if occ0 is not None and occ0.shape != hw:
        print("ERROR: input occlusion mask size mismatch", file=sys.stderr)
        return 1
    t_prep = time.perf_counter()
    i0n, i1n, i_1n = prepare_triple(i0p, i1p, i_1p, device=device)
    dev = i0n.device
    u1 = torch.as_tensor(np.ascontiguousarray(in_flow[:, :, 0]), device=dev)
    u2 = torch.as_tensor(np.ascontiguousarray(in_flow[:, :, 1]), device=dev)
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    u1, u2, chi = global_refine(method, i0n, i1n, u1, u2, prm, stats=stats,
                                i0_planes=i0p, i_1n=i_1n, occ_init=occ0)
    out = torch.stack([u1, u2], dim=-1).cpu().numpy()
    chi = None if chi is None else chi.cpu().numpy()
    t_write = time.perf_counter()
    if verbose:
        print(f"(global) solve took {t_write - t0:.3f}s on {dev}",
              file=sys.stderr)
    write_flo(outfile, out)
    if occ_out is not None and chi is not None:
        save_image_int(occ_out, chi.astype(np.int32))
    if stats is not None:
        stats["global_seconds"] = dict(
            read=t_prep - t_read, prepare=t0 - t_prep, solve=t_write - t0,
            write=time.perf_counter() - t_write)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

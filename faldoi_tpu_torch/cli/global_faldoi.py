"""CLI for the global variational refinement on the port — the contract of
``faldoi_tpu.cli.global_faldoi`` (``global_faldoi.cpp:1846-2213``) plus
``-device``:

    python -m faldoi_tpu_torch.cli.global_faldoi ims.txt in_flow.flo out.flo \
        [occl_input.png occl_out.png] [-m method] [-w warps] [-p params_file] \
        [-glb_iters iters] [-verbose v] [-device cuda|cpu]

Methods 0 (TV-L1) and 1 (weighted TV-L1, whose global step is the TV-L1 one)
are ported; other methods exit with code 2.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from faldoi_tpu_torch import params as P

# the methods this slice of the port runs
PORTED_METHODS = (P.M_TVL1, P.M_TVL1_W)


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
    counters (``tvl2_global(stats=)``) and ``global_seconds``, the host's
    seconds for reading the inputs, preparing the frames (the card has
    finished them), the solve with its download, and writing the result."""
    from faldoi_tpu_torch.core.preprocess import prepare_triple, read_frame_list
    from faldoi_tpu_torch.io.flo import read_flo, write_flo
    from faldoi_tpu_torch.io.image import read_image_split

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
    # args[4], occl_out: method 0 has no occlusion output, so it is not
    # written (as in JAX)
    occ_in = args[3] if len(args) == 5 else None

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
        print(f"ERROR: method {method} not ported yet (the port runs methods "
              "0, TV-L1, and 1, weighted TV-L1)", file=sys.stderr)
        return 2

    prm = P.init_params(file_params, P.GLOBAL_STEP)
    prm.warps = warps
    prm.val_method = method
    prm.iterations_of = glb_iters
    prm.verbose = verbose

    from faldoi_tpu_torch.models import global_refine

    if occ_in is not None and read_image_split(occ_in).shape[1:] != hw:
        print("ERROR: input occlusion mask size mismatch", file=sys.stderr)
        return 1
    t_prep = time.perf_counter()
    i0n, i1n, _ = prepare_triple(i0p, i1p, i_1p, device=device)
    dev = i0n.device
    u1 = torch.as_tensor(np.ascontiguousarray(in_flow[:, :, 0]), device=dev)
    u2 = torch.as_tensor(np.ascontiguousarray(in_flow[:, :, 1]), device=dev)
    if stats is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    u1, u2 = global_refine(method, i0n, i1n, u1, u2, prm, stats=stats)
    out = torch.stack([u1, u2], dim=-1).cpu().numpy()
    t_write = time.perf_counter()
    if verbose:
        print(f"(global) solve took {t_write - t0:.3f}s on {dev}",
              file=sys.stderr)
    write_flo(outfile, out)
    if stats is not None:
        stats["global_seconds"] = dict(
            read=t_prep - t_read, prepare=t0 - t_prep, solve=t_write - t0,
            write=time.perf_counter() - t_write)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

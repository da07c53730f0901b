"""CLI: rasterise a 4-column match list into a sparse .flo seed field, the
contract of the reference ``sparse_flow`` binary (sparse_flow.cpp:50-72)::

    python -m faldoi_tpu_torch.cli.sparse_flow matches.txt columns rows out.flo
"""

from __future__ import annotations

import sys

from faldoi_tpu_torch.core.sparse import sparse_flow
from faldoi_tpu_torch.io.flo import write_flo


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 4:
        print("usage: sparse_flow matches.txt columns rows out.flo", file=sys.stderr)
        return 1
    write_flo(args[3], sparse_flow(args[0], int(args[1]), int(args[2])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

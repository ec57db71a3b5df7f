"""Worker body of a tester sweep on a grid, for tests and scripts:

    python -m slate_tpu_torch.testing.sweep_checks <rank> <rendezvous>
        <ranks> <tester arguments...>

launched by :func:`testing.multiproc.launch`. The worker joins the
process group (gloo for ``--device cpu``, else NCCL, as
:func:`multiproc.init` chooses), runs ``tester.run`` on the tester
arguments (so ``--grid 2x2`` takes the world's ranks) and emits the
rows as one record ``rows`` (:func:`multiproc.emit`). Nothing here
imports JAX.
"""

from __future__ import annotations

import io
import sys

from . import multiproc as mp


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rank, rdzv, nprocs, rest = int(argv[0]), argv[1], int(argv[2]), argv[3:]
    from . import tester
    args = tester.parser().parse_args(rest)
    mp.init(rank, rdzv, nprocs, device=args.device)
    import torch.distributed as dist
    table = io.StringIO()
    rows = tester.run(args, out=table)
    mp.emit("rows", rows=rows, table=table.getvalue())
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The distributed core (counterpart of ``slate_tpu/dist/``):
algorithms whose communication schedule is itself the algorithm, the
capability the reference builds on MPI rank trees (ttqrt binary
reduction, geqrf.cc:161; rank-parallel stedc, stedc_solve.cc:97-171;
row-local dsteqr2.f):

  tree.py      - log-depth pairwise / grouped combine engine and the
                 row-local apply shape
  tsqr.py      - grid TSQR (chunk QR, tree R-combine, implicit-Q apply)
  stedc.py     - distributed Cuppen divide & conquer
  steqr2.py    - row-local QR-iteration transform accumulation
  tuneshare.py - rank 0's tuning-table broadcast and best-entry merge
  shard_ooc.py - the sharded out-of-core stream: block-cyclic panel
                 ownership, each rank staging its own panels through
                 linalg/stream.py, factor frames over the tree
  elastic.py   - throughput-driven re-ownership of the sharded stream's
                 panels, shrink-to-fit after a lost rank, and the
                 remap-record mirror the serving daemon reads

Consumers: qr.gels_tsqr and the grid geqrf's tall-skinny route,
eig.stedc and eig.steqr2 on a grid, the out-of-core drivers' grid route
(linalg/ooc.py through MethodOOC), testing.multiproc.startup.
"""

from . import (elastic, shard_ooc, stedc, steqr2, tree,  # noqa: F401
               tsqr, tuneshare)
from .elastic import remap_records, reset_remap_records  # noqa: F401
from .elastic import shrink_to_fit                        # noqa: F401
from .shard_ooc import (shard_geqrf_ooc, shard_getrf_ooc,  # noqa: F401
                        shard_potrf_ooc)
from .steqr2 import steqr2_qr_dist       # noqa: F401
from .stedc import stedc_solve_dist      # noqa: F401
from .tsqr import tsqr as tsqr_mesh      # noqa: F401
from .tsqr import tsqr_qt                # noqa: F401
from .tree import row_apply, tree_combine  # noqa: F401
from .tuneshare import share_tuning_table  # noqa: F401

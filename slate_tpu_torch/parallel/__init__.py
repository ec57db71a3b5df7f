"""The process grid and its collectives over ``torch.distributed``
(counterpart of ``slate_tpu/parallel/``): ``mesh`` (ProcessGrid,
make_grid), ``sharding`` (the 2D block-cyclic layout), ``collectives``
(the explicit collectives on local blocks) and ``owner`` (the drivers'
owner-computes steps). Left out on purpose: ``smap``, a shim across JAX
versions.
"""

from . import collectives, mesh, owner, sharding  # noqa: F401
from .mesh import ProcessGrid, make_grid, single_device_grid  # noqa: F401
from .sharding import distribute_cyclic, undistribute  # noqa: F401

"""Process grid over a ``torch.distributed`` process group (counterpart
of ``slate_tpu/parallel/mesh.py``; reference gridinfo / GridOrder,
BaseMatrix.hh:161).

The reference's grid is a ``jax.sharding.Mesh`` with axes ('p', 'q')
over the devices of one SPMD program. In PyTorch every rank is a
process, so the port's grid is a p x q arrangement of the ranks of the
default process group: rank ``ranks[k]`` sits at grid position
``(k // q, k % q)``, the position of device ``k`` in the reference's
mesh (``devices[:p*q].reshape(p, q)``). Port rank k is therefore
compared with reference device k.

A grid holds the subgroups its collectives run over: the whole grid
(axis ('p', 'q')), its row (axis 'q': the ranks of one grid row) and
its column (axis 'p'). :func:`make_grid` creates them with
``dist.new_group`` in the same order on every rank, so it must be
called by every rank of the world, as ``new_group`` must. Several grids
may be built over one world (2 x 2, 1 x 4 and 4 x 1 over four ranks);
a group of a given rank list is made once and shared.

Each grid also holds its device and its backend. The default device is
the card, ``cuda:<LOCAL_RANK % device_count>`` (the rank when
``LOCAL_RANK`` is unset). The backend is the initialized process
group's, chosen at ``init_process_group`` (``testing.multiproc.init``:
NCCL for a CUDA device, gloo for ``device="cpu"``, or ``backend=``);
``grid.backend`` reads it and nothing switches it. Under gloo a CUDA
device works too (several ranks on one card, which NCCL refuses): the
in-core drivers use only ``broadcast`` and ``all_reduce``, the two
operations gloo takes on CUDA tensors, and the point-to-point rounds of
the tree engine and ``ring_shift`` go through a host copy
(``collectives.exchange``).

:func:`single_device_grid` is 1 x 1 and needs no process group; its
collectives are the identity.

``matrix_sharding``, ``replicated`` and ``row_sharding`` return layout
descriptors (:class:`ShardLayout`): the reference's PartitionSpecs, which
``parallel.sharding.local_block`` reads. Left out on purpose:
``parallel/smap.py``, a shim across JAX versions of ``shard_map``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..core.enums import GridOrder
from ..core.func import process_2d_grid
from ..utils.backend import DeviceLike, resolve_device

#: a mesh axis: 'p' (down a grid column), 'q' (along a grid row) or
#: the flattened ('p', 'q') of the whole grid
Axis = Union[str, Tuple[str, ...]]

WHOLE = ("p", "q")


class ShardLayout(NamedTuple):
    """A layout descriptor: the reference's PartitionSpec over this
    grid. spec[d] names the mesh axis (or axes) dimension d is split
    over, None for a dimension that is not split."""
    grid: "ProcessGrid"
    spec: Tuple


def _near_square_factors(n: int) -> Tuple[int, int]:
    p = int(math.isqrt(n))
    while n % p:
        p -= 1
    return p, n // p


def _axis_key(axis: Axis) -> Tuple[str, ...]:
    key = (axis,) if isinstance(axis, str) else tuple(axis)
    if key not in (("p",), ("q",), WHOLE):
        raise ValueError("axis must be 'p', 'q' or ('p', 'q'), got %r"
                         % (axis,))
    return key


class ProcessGrid:
    """A p x q grid over ranks of the default process group (module
    doc). ``rank`` is this process's world rank, ``index`` its
    position in the grid (row-major), None for a rank outside it."""

    def __init__(self, p: int, q: int, order: GridOrder,
                 ranks: Sequence[int], rank: int, device: torch.device,
                 backend: Optional[str],
                 groups: Optional[Dict[Tuple[str, ...], object]] = None
                 ) -> None:
        self.p, self.q, self.order = int(p), int(q), order
        self.ranks = tuple(int(r) for r in ranks)
        self.rank = int(rank)
        self.device = device
        self.backend = backend
        self._groups = groups or {}

    def __repr__(self) -> str:
        return "ProcessGrid(%dx%d, rank %d, %s, %s)" % (
            self.p, self.q, self.rank, self.device, self.backend)

    @property
    def nprocs(self) -> int:
        return self.p * self.q

    @property
    def index(self) -> Optional[int]:
        return self.ranks.index(self.rank) if self.rank in self.ranks \
            else None

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's grid position (r, c)."""
        k = self.index
        if k is None:
            raise ValueError("rank %d is not in %r" % (self.rank, self))
        return k // self.q, k % self.q

    def axis_size(self, axis: Axis) -> int:
        key = _axis_key(axis)
        return self.nprocs if key == WHOLE else \
            (self.p if key == ("p",) else self.q)

    def axis_index(self, axis: Axis) -> int:
        """This rank's position along `axis` (the reference's
        ``axis_index``; ('p', 'q') flattens row-major)."""
        key = _axis_key(axis)
        r, c = self.coords
        return r * self.q + c if key == WHOLE else \
            (r if key == ("p",) else c)

    def axis_ranks(self, axis: Axis) -> Tuple[int, ...]:
        """World ranks of this rank's group along `axis`, in axis
        order."""
        key = _axis_key(axis)
        r, c = self.coords
        if key == WHOLE:
            return self.ranks
        if key == ("p",):
            return self.ranks[c::self.q]
        return self.ranks[r * self.q:(r + 1) * self.q]

    def group(self, axis: Axis = WHOLE):
        """The process group of this rank's `axis` group; None on a
        grid without a process group (single_device_grid)."""
        return self._groups.get(_axis_key(axis))

    def distributed(self) -> bool:
        return bool(self._groups)

    def tile_rank_func(self):
        """The reference tileRank lambda for this grid."""
        return process_2d_grid(self.order, self.p, self.q)

    def gridinfo(self):
        """(order, p, q, coords) with coords {world rank: (r, c)} over
        every rank of the grid (reference BaseMatrix::gridinfo)."""
        coords = {rk: (k // self.q, k % self.q)
                  for k, rk in enumerate(self.ranks)}
        return self.order, self.p, self.q, coords

    def matrix_sharding(self) -> ShardLayout:
        """Rows over 'p', columns over 'q' (contiguous blocks)."""
        return ShardLayout(self, ("p", "q"))

    def replicated(self) -> ShardLayout:
        return ShardLayout(self, ())

    def row_sharding(self) -> ShardLayout:
        """Rows over the whole grid (tall-skinny panels)."""
        return ShardLayout(self, (WHOLE, None))


#: process groups by (default group, rank tuple), made once per world
_GROUPS: Dict[Tuple[int, Tuple[int, ...]], object] = {}
_WORLDS: list = []


def _group(ranks: Tuple[int, ...]):
    """The process group over `ranks`, made on first use: every rank of
    the world calls this in the same order (make_grid's loops)."""
    world = dist.distributed_c10d._get_default_group()
    if world not in _WORLDS:
        _WORLDS.append(world)       # keeps id(world) unique while cached
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    key = (id(world), ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
    return _GROUPS[key]


def _default_device() -> torch.device:
    """cuda:<LOCAL_RANK % device_count> (the world rank when LOCAL_RANK
    is unset); raises without a card (utils.backend.resolve_device)."""
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


_NO_GROUP = ("make_grid: a %dx%d grid needs an initialized torch.distributed "
             "process group (testing.multiproc.init or "
             "torch.distributed.init_process_group)")


def make_grid(p: Optional[int] = None, q: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None,
              order: GridOrder = GridOrder.Col, *,
              device: DeviceLike = None) -> ProcessGrid:
    """A ProcessGrid over `ranks` (the reference's `devices`; default:
    every rank of the initialized process group), with the reference's
    factoring (near-square when neither p nor q is given) and errors.
    Collective over the world: every rank must call it (module doc).

    Without an initialized process group only a 1 x 1 grid exists (the
    single-device grid on `device`). The backend is the group's;
    `device` defaults to the card (``cuda:<local rank>``) and must be a
    CUDA device under NCCL."""
    if not dist.is_initialized() and ranks is None \
            and (p or 1) * (q or 1) > 1:
        raise ValueError(_NO_GROUP % ((p or 1), (q or 1)))
    if not dist.is_initialized():
        nd = len(ranks) if ranks is not None else 1
    else:
        nd = len(ranks) if ranks is not None else dist.get_world_size()
    if p is None and q is None:
        p, q = _near_square_factors(nd)
    elif p is None:
        if q <= 0 or nd % q:
            raise ValueError(f"q={q} does not divide {nd} devices")
        p = nd // q
    elif q is None:
        if p <= 0 or nd % p:
            raise ValueError(f"p={p} does not divide {nd} devices")
        q = nd // p
    if p <= 0 or q <= 0 or p * q > nd:
        raise ValueError(f"grid {p}x{q} needs {p*q} devices, have {nd}")
    if not dist.is_initialized():
        if p * q > 1:
            raise ValueError(_NO_GROUP % (p, q))
        return single_device_grid(device, order)
    world_backend = dist.get_backend()
    dev = _default_device() if device is None \
        else resolve_device(device)
    if world_backend == "nccl" and dev.type != "cuda":
        raise ValueError("make_grid: NCCL needs a CUDA device, got %s"
                         % dev)
    members = tuple(int(r) for r in (ranks if ranks is not None
                                     else range(dist.get_world_size())))
    members = members[:p * q]
    groups = {WHOLE: _group(members)}
    rows = [_group(members[r * q:(r + 1) * q]) for r in range(p)]
    cols = [_group(members[c::q]) for c in range(q)]
    me = dist.get_rank()
    if me in members:
        k = members.index(me)
        groups[("q",)] = rows[k // q]
        groups[("p",)] = cols[k % q]
    return ProcessGrid(p, q, order, members, me, dev, world_backend,
                       groups)


def option_grid(opts, what: str) -> Optional[ProcessGrid]:
    """``Option.Grid`` from `opts`: None, or a ProcessGrid this rank
    belongs to; anything else raises naming the driver `what`."""
    from ..core.options import Option, get_option
    grid = get_option(opts, Option.Grid, None)
    if grid is None:
        return None
    if not isinstance(grid, ProcessGrid):
        raise TypeError("%s: Option.Grid must be a ProcessGrid "
                        "(parallel.make_grid), got %s"
                        % (what, type(grid).__name__))
    if grid.index is None:
        raise ValueError("%s: rank %d is not in %r" % (what, grid.rank,
                                                       grid))
    return grid


def single_device_grid(device: DeviceLike = None,
                       order: GridOrder = GridOrder.Col) -> ProcessGrid:
    """A 1 x 1 grid on `device` (the card unless named) with no process
    group: its collectives are the identity."""
    return ProcessGrid(1, 1, order, (0,), 0, resolve_device(device), None)

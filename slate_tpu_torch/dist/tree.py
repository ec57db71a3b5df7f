"""Log-depth pairwise-combine engine over grid axes (counterpart of
``slate_tpu/dist/tree.py``): the role of the reference's cross-rank
ttqrt binary reduction tree (geqrf.cc:161,220, internal_ttqrt.cc) and
hypercube ReduceList patterns (internal_comm.cc:72).

The engine is the butterfly (all-combine) form of the tree: at each
round, the ranks along the axis form groups of `g`, exchange their
current values with the g-1 partners, and every member computes the
same combine of the group's values in mesh-position order. After
ceil(log_g(size)) rounds every rank holds the full combination,
associated left to right, so structured combines (the stacked-R QR of
dist/tsqr.py) give the same bits on every rank without a broadcast
down. `fanin` (the group size; reference ttqrt is 2) is a tunable.

The exchanges are ``isend`` / ``irecv`` within the axis group, posted
together (``parallel.collectives.exchange``: NCCL on the card, gloo on
the CPU, gloo with CUDA tensors through a host copy) and counted as the reference's g-1
``collective-permute`` a round. The functions that run inside the
reference's ``shard_map`` take the grid here and run on this rank's
block. ``row_apply`` is the row-local shape: this rank's row block,
the other operands whole, no communication (the reference's dsteqr2.f
play); row-sharded results come back as this rank's row block
(:func:`row_block` says which rows).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from ..parallel.collectives import _count, exchange
from ..parallel.mesh import WHOLE, Axis, ProcessGrid

AxisName = Axis


def axis_size(grid: ProcessGrid, axis: AxisName) -> int:
    """Rank count along `axis` ('p', 'q', or ('p', 'q') for the whole
    grid)."""
    return grid.axis_size(axis)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Zero-pad x's leading dimension to `rows` (zero rows are exact for
    the consumers: QR leaves, rotation-chain row blocks)."""
    if x.shape[0] == rows:
        return x
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


def row_block(grid: ProcessGrid, rows: int, axis: AxisName = WHOLE
              ) -> slice:
    """This rank's rows of a `rows`-row tensor split evenly over
    `axis` (rows must divide)."""
    size = grid.axis_size(axis)
    if rows % size:
        raise ValueError("%d rows do not split over %d ranks"
                         % (rows, size))
    h = rows // size
    i = grid.axis_index(axis)
    return slice(i * h, (i + 1) * h)


def group_values(grid: ProcessGrid, x: torch.Tensor, axis: AxisName,
                 size: int, span: int, g: int) -> list:
    """The values held by the `g` members of this rank's combine group,
    in group-position order (element my_pos is this rank's own `x`).
    Group structure at a round: ranks whose flattened axis index
    differs only in the digit (idx // span) % g."""
    idx = grid.axis_index(axis)
    pos = (idx // span) % g
    base = idx - pos * span
    _count("collective-permute", g - 1)
    if g == 1:
        return [x]
    # the member at position (pos + o) % g sends to position pos
    bufs = exchange(grid, x,
                    [base + ((pos - o) % g) * span for o in range(1, g)],
                    [base + ((pos + o) % g) * span for o in range(1, g)],
                    axis)
    return [x if j == pos else bufs[(j - pos) % g - 1] for j in range(g)]


def round_schedule(size: int, fanin: int = 2) -> list:
    """The (span, g) rounds of the combine tree for `size` ranks: per
    round g = the largest group size <= fanin that divides the
    remaining count (a prime tail degenerates to one wide combine)."""
    if size < 1:
        raise ValueError(f"axis size {size} < 1")
    fanin = max(int(fanin), 2)
    rounds = []
    span = 1
    while span < size:
        rem = size // span
        g = min(fanin, rem)
        while g > 1 and rem % g:
            g -= 1
        if g <= 1:
            g = next(k for k in range(fanin + 1, rem + 1) if rem % k == 0)
        rounds.append((span, g))
        span *= g
    return rounds


def schedule_ppermutes(size: int, fanin: int = 2) -> int:
    """Exchanges one tree traversal schedules (g-1 a round): the exact
    per-call comms count of anything built on the tree."""
    return sum(g - 1 for _, g in round_schedule(size, fanin))


def record_schedule(op: str, size: int, fanin: int) -> None:
    """Publish one tree traversal's scheduled comms to the obs bus, and
    the ``ppermute`` fault-injection site (announced before the obs
    gate, so a seeded plan can fail traversal k deterministically)."""
    from ..resil import faults as _faults
    if _faults.active() is not None:
        _faults.check("ppermute", op=op, size=size, fanin=fanin)
    from ..obs import events as obs_events
    if not obs_events.enabled():
        return
    from ..obs import metrics as obs_metrics
    n = schedule_ppermutes(size, fanin)
    obs_metrics.inc("comms.ppermute.scheduled", n)
    obs_events.instant("comms:%s" % op, cat="comms", ppermutes=n,
                       size=size, fanin=fanin)


def complete_schedule(op: str, x: torch.Tensor) -> float:
    """Wait for the device work behind `x` (a traversal's result) and
    publish the wait as ``comms.ppermute.wait_seconds``. Returns the
    wait in seconds."""
    t0 = time.perf_counter()
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    from ..obs import events as obs_events
    if obs_events.enabled():
        from ..obs import metrics as obs_metrics
        obs_metrics.inc("comms.ppermute.wait_seconds", dt)
    return dt


def tree_combine(grid: ProcessGrid, x: torch.Tensor,
                 combine: Callable[[Sequence], torch.Tensor],
                 axis: AxisName, size: int, fanin: int = 2
                 ) -> torch.Tensor:
    """Log-depth grouped combine along `axis`: after the last round
    every rank holds `combine` over all `size` leaves, associated left
    to right by mesh position."""
    for span, g in round_schedule(size, fanin):
        x = combine(group_values(grid, x, axis, size, span, g))
    return x


def row_apply(grid: ProcessGrid, f: Callable, x: torch.Tensor,
              *replicated, axis: AxisName = WHOLE) -> torch.Tensor:
    """f on this rank's row block of x (the rows split evenly over
    `axis`), the other operands whole: no communication. Returns this
    rank's block of the result."""
    return f(x[row_block(grid, x.shape[0], axis)], *replicated)


"""Owner-computes steps of the grid drivers: the port's counterpart of
the reference's per-step sharding constraints
(``slate_tpu/parallel/sharding.py: constrain``).

Every rank passes and holds the same global matrix (the reference's
every device sees the same global array; here it is also stored whole
on every rank: ROADMAP queue 3). The work is divided by the 2D
block-cyclic map (``process_2d_grid``): element (i, j) belongs to grid
position ((i // mb) % p, (j // nb) % q), and a rank updates only the
elements it owns. A driver's block step is then:

  1. :func:`gather`: the current panel on every rank, by a masked
     all_reduce (each rank adds what it owns, zeros elsewhere; exact);
  2. one owner (:meth:`Owner.rank_of` the panel's diagonal element)
     computes what every rank must agree on (a panel factor, its
     pivots, a diagonal inverse) and broadcasts it, so no rank
     recomputes it: :func:`publish`, and :func:`step` for steps 1-2
     together. The other ranks receive into buffers made from one spec
     of the outputs' shapes and dtypes, which the owner's outputs are
     checked against, so every rank issues the same collectives;
  3. :func:`update`: each rank's trailing update of its own tiles.

What a step finalizes (an L column, a U or R row) reaches every rank in
step 1 or 2, so the result is the same on every rank, bit for bit,
without a final gather. :func:`product` forms a whole product the same
way: each rank its own tiles, then a gather. Each rank counts the
operations of its trailing updates (:func:`flops`): the FLOP-balance
evidence the reference reads from XLA's per-partition cost model.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .collectives import all_reduce, broadcast_many
from .mesh import ProcessGrid

#: the shapes and dtypes of an owner's outputs, one (shape, dtype) each
Spec = Sequence[Tuple[Tuple[int, ...], torch.dtype]]

_lock = threading.Lock()
_FLOPS = [0]


def flops() -> int:
    """Operations of this process's owner-computes updates since the
    last reset (2 m n k per real product, 8 m n k complex)."""
    with _lock:
        return _FLOPS[0]


def reset_flops() -> None:
    with _lock:
        _FLOPS[0] = 0


def _add_flops(m: int, n: int, k: int, complex_: bool) -> None:
    with _lock:
        _FLOPS[0] += (8 if complex_ else 2) * m * n * k


class Owner:
    """The block-cyclic ownership of an (M, N) matrix in (mb, nb)
    tiles on `grid`, seen from this rank."""

    def __init__(self, grid: ProcessGrid, shape: Tuple[int, int],
                 mb: int, nb: int, device) -> None:
        self.grid, self.mb, self.nb = grid, int(mb), int(nb)
        self.shape = (int(shape[0]), int(shape[1]))
        r, c = grid.coords
        self.rows = (torch.arange(self.shape[0], device=device)
                     // self.mb) % grid.p == r
        self.cols = (torch.arange(self.shape[1], device=device)
                     // self.nb) % grid.q == c

    def rank_of(self, i: int, j: int) -> int:
        """Grid index (row-major) of the owner of element (i, j)."""
        return ((i // self.mb) % self.grid.p) * self.grid.q \
            + (j // self.nb) % self.grid.q

    def row_index(self, r0: int, r1: int) -> torch.Tensor:
        return r0 + torch.nonzero(self.rows[r0:r1]).reshape(-1)

    def col_index(self, c0: int, c1: int) -> torch.Tensor:
        return c0 + torch.nonzero(self.cols[c0:c1]).reshape(-1)


def gather(owner: Owner, a: torch.Tensor, rs: slice, cs: slice
           ) -> torch.Tensor:
    """The current a[rs, cs] on every rank: each element from its
    owner (a masked all_reduce over the grid; a copy without a process
    group)."""
    blk = a[rs, cs]
    if not owner.grid.distributed():
        return blk.clone()
    mask = owner.rows[rs][:, None] & owner.cols[cs][None, :]
    return all_reduce(owner.grid, torch.where(mask, blk, 0))


def gather_rows(owner: Owner, a: torch.Tensor, rows: torch.Tensor,
                cs: slice) -> torch.Tensor:
    """The current a[rows, cs] (rows an index tensor) on every rank."""
    blk = a[rows, cs]
    if not owner.grid.distributed():
        return blk
    mask = owner.rows[rows][:, None] & owner.cols[cs][None, :]
    return all_reduce(owner.grid, torch.where(mask, blk, 0))


def publish(owner: Owner, src: int, compute: Callable[[], Sequence],
            spec: Spec) -> List[torch.Tensor]:
    """compute()'s outputs on every rank: grid index `src` runs it, the
    others receive (one broadcast per dtype). `spec` gives each output's
    (shape, dtype): the other ranks' buffers are made from it and the
    owner's outputs must match it (module doc)."""
    want = [(tuple(int(d) for d in shape), dt) for shape, dt in spec]
    if owner.grid.index == src:
        outs = list(compute())
        got = [(tuple(t.shape), t.dtype) for t in outs]
        if got != want:
            raise RuntimeError("owner step: outputs %s, spec %s"
                               % (got, want))
    else:
        dev = owner.rows.device
        outs = [torch.empty(shape, dtype=dt, device=dev)
                for shape, dt in want]
    return broadcast_many(owner.grid, outs, src)


def step(owner: Owner, a: torch.Tensor, rs: slice, cs: slice,
         compute: Callable[[torch.Tensor], Sequence], spec: Spec,
         src: Optional[int] = None) -> List[torch.Tensor]:
    """Steps 1-2 of a block step (module doc): the current a[rs, cs]
    gathered on every rank, compute(panel) on the owner of its first
    element (or on grid index `src`), the outputs published."""
    col = gather(owner, a, rs, cs)
    if src is None:
        src = owner.rank_of(rs.start or 0, cs.start or 0)
    return publish(owner, src, lambda: compute(col), spec)


def update(owner: Owner, a: torch.Tensor, r0: int, r1: int, c0: int,
           c1: int, L: torch.Tensor, U: torch.Tensor) -> None:
    """a[i, j] -= (L @ U)[i - r0, j - c0] for the (i, j) in
    [r0, r1) x [c0, c1) this rank owns, in place; L is (r1 - r0, w), U
    (w, c1 - c0). The product is formed and then subtracted (two
    roundings, as the reference's ``a.at[...].add(-upd)``)."""
    if r1 <= r0 or c1 <= c0 or L.shape[1] == 0:
        return
    g, w = owner.grid, L.shape[1]
    cplx = a.is_complex()
    if g.p == 1 and g.q == 1:
        _add_flops(r1 - r0, c1 - c0, w, cplx)
        a[r0:r1, c0:c1] -= L @ U
        return
    ri, ci = owner.row_index(r0, r1), owner.col_index(c0, c1)
    if ri.numel() == 0 or ci.numel() == 0:
        return
    _add_flops(ri.numel(), ci.numel(), w, cplx)
    prod = L[ri - r0] @ U[:, ci - c0]
    a[ri[:, None], ci[None, :]] = a[ri[:, None], ci[None, :]] - prod


def owned_block(owner: Owner, a: torch.Tensor, r0: int, r1: int,
                c0: int, c1: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(rows, cols, a[rows][:, cols]) of this rank's elements in
    [r0, r1) x [c0, c1): index tensors and a copy of the block."""
    ri, ci = owner.row_index(r0, r1), owner.col_index(c0, c1)
    return ri, ci, a[ri[:, None], ci[None, :]]


def count_product(m: int, n: int, k: int, complex_: bool) -> None:
    """Count one owner-computes product that a driver forms itself."""
    _add_flops(m, n, k, complex_)


def product(owner: Owner, a: torch.Tensor, b: torch.Tensor, alpha=1.0,
            beta=0.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha a @ b + beta c (a @ b without `c`) on every rank: each rank
    forms its own tiles of the (M, N) result under `owner`'s map, and
    the tiles are gathered by a masked all_reduce."""
    M, N = owner.shape
    ri, ci = owner.row_index(0, M), owner.col_index(0, N)
    out = torch.zeros_like(c) if c is not None else torch.zeros(
        (M, N), dtype=torch.promote_types(a.dtype, b.dtype),
        device=a.device)
    if ri.numel() and ci.numel():
        _add_flops(ri.numel(), ci.numel(), a.shape[1], out.is_complex())
        blk = a[ri] @ b[:, ci]
        out[ri[:, None], ci[None, :]] = blk if c is None \
            else alpha * blk + beta * c[ri][:, ci]
    return all_reduce(owner.grid, out)

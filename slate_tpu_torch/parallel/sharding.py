"""2D block-cyclic tile distribution (counterpart of
``slate_tpu/parallel/sharding.py``; reference func.hh:178-185
``process_2d_grid``, BaseMatrix.hh:161 gridinfo).

The reference distributes tile (i, j) to rank (i % p, j % q). Its
``to_cyclic`` / ``from_cyclic`` permute tile rows and columns so that
the contiguous P('p', 'q') blocks of the permuted array ARE the
block-cyclic assignment; the same permutations are here, on tensors.
``distribute_cyclic`` returns this rank's local shard (the bytes
reference device (r, c) holds after its ``distribute_cyclic``);
``undistribute`` gathers the shards and un-permutes.

``local_block`` cuts this rank's block of a global tensor under a
layout (``ProcessGrid.matrix_sharding()`` and its siblings), and
``assemble`` is its inverse, a gather over the grid.

Left out on purpose: ``constrain`` and ``panel_spec``, the reference's
per-step sharding constraints. XLA places each step's FLOPs by the
constraint; in the port the drivers run owner-computes loops instead
(``parallel/owner.py``): every rank holds the global matrix and
updates only the tiles the block-cyclic map gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.tiles import TiledMatrix
from .collectives import all_reduce
from .mesh import WHOLE, ShardLayout, ProcessGrid


def cyclic_tile_order(nt: int, p: int) -> np.ndarray:
    """Storage order of logical tile indices for a p-fold cyclic
    distribution: the tiles rank 0 owns (i % p == 0) first, then rank
    1's, ... (func.hh:178: rank = i % p)."""
    return np.concatenate([np.arange(r, nt, p) for r in range(max(p, 1))])


def _row_perm(npad: int, b: int, p: int) -> np.ndarray:
    order = cyclic_tile_order(npad // b, p)
    return (order[:, None] * b + np.arange(b)[None, :]).reshape(-1)


def _index(perm: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(perm, dtype=torch.int64, device=like.device)


def to_cyclic(a: torch.Tensor, mb: int, nb: int, p: int, q: int
              ) -> torch.Tensor:
    """Permute a padded (M, N) tensor into 2D block-cyclic storage
    order for a p x q grid: its contiguous P('p', 'q') blocks then hold
    logical tile (i, j) on rank (i % p, j % q)."""
    M, N = a.shape
    out = a
    if p > 1 and M // mb > 1:
        out = out[_index(_row_perm(M, mb, p), a)]
    if q > 1 and N // nb > 1:
        out = out[:, _index(_row_perm(N, nb, q), a)]
    return out


def from_cyclic(a: torch.Tensor, mb: int, nb: int, p: int, q: int
                ) -> torch.Tensor:
    """Inverse of :func:`to_cyclic`."""
    M, N = a.shape
    out = a
    if p > 1 and M // mb > 1:
        out = out[_index(np.argsort(_row_perm(M, mb, p)), a)]
    if q > 1 and N // nb > 1:
        out = out[:, _index(np.argsort(_row_perm(N, nb, q)), a)]
    return out


def cyclic_sharding(grid: ProcessGrid) -> ShardLayout:
    """The layout to pair with :func:`to_cyclic` storage: contiguous
    P('p', 'q') on the permuted tensor is block-cyclic on the tiles."""
    return grid.matrix_sharding()


def _spans(grid: ProcessGrid, spec: Tuple, shape: Tuple[int, ...]):
    """(start, stop) of this rank's block along each dimension."""
    spans = []
    for d, n in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            spans.append((0, n))
            continue
        size = grid.axis_size(axis)
        if n % size:
            raise ValueError("dimension %d of size %d does not split over "
                             "%r (%d ranks)" % (d, n, axis, size))
        h = n // size
        pos = grid.axis_index(axis)
        spans.append((pos * h, (pos + 1) * h))
    return spans


def local_block(grid: ProcessGrid, x: torch.Tensor,
                layout: Optional[ShardLayout] = None) -> torch.Tensor:
    """This rank's block of the global tensor `x` under `layout`
    (default ``grid.matrix_sharding()``): what reference device (r, c)
    holds of an array with that sharding."""
    spec = (layout or grid.matrix_sharding()).spec
    idx = tuple(slice(a, b) for a, b in _spans(grid, spec, tuple(x.shape)))
    return x[idx]


def assemble(grid: ProcessGrid, block: torch.Tensor,
             shape: Tuple[int, ...],
             layout: Optional[ShardLayout] = None) -> torch.Tensor:
    """The global tensor of `shape` whose blocks under `layout` the
    ranks hold (the inverse of :func:`local_block`): a gather over the
    grid, counted as ``all-gather``. Replicated dimensions must agree."""
    spec = (layout or grid.matrix_sharding()).spec
    out = torch.zeros(shape, dtype=block.dtype, device=block.device)
    out[tuple(slice(a, b) for a, b in _spans(grid, spec, shape))] = block
    if not any(s is not None for s in spec):
        return out
    axes = [s for s in spec if s is not None]
    axis = axes[0] if len(axes) == 1 and axes[0] != WHOLE else WHOLE
    return all_reduce(grid, out, axis, kind="all-gather")


def distribute_cyclic(A: TiledMatrix, grid: ProcessGrid) -> TiledMatrix:
    """A with its storage permuted to 2D block-cyclic order and cut to
    this rank's P('p', 'q') block (reference fromScaLAPACK / the 2D
    block-cyclic constructors, Matrix.hh:73). `m` and `n` stay the
    global sizes; :func:`undistribute` recovers the logical layout."""
    perm = to_cyclic(A.data, A.mb, A.nb, grid.p, grid.q)
    return dataclasses.replace(A, data=local_block(grid, perm))


def undistribute(A: TiledMatrix, grid: ProcessGrid) -> TiledMatrix:
    """Inverse of :func:`distribute_cyclic`: gather the shards, then
    un-permute."""
    shape = (A.data.shape[0] * grid.p, A.data.shape[1] * grid.q)
    full = assemble(grid, A.data, shape)
    return dataclasses.replace(
        A, data=from_cyclic(full, A.mb, A.nb, grid.p, grid.q))

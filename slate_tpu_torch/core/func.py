"""Distribution functions (counterpart of ``slate_tpu/core/func.py``;
reference include/slate/func.hh:39-265).

The reference parameterizes tile -> rank and tile -> device maps with
lambdas; the defaults are 2D block-cyclic grids. A user can ask which
grid coordinate owns a tile; ``parallel.ProcessGrid.tile_rank_func``
gives a grid's map, and the grid drivers' owner-computes loops
(``parallel/owner.py``) divide their work by the same 2D block-cyclic
rule. Pure Python, the same maps as the reference's.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .enums import GridOrder

TileRankFunc = Callable[[Tuple[int, int]], int]
TileSizeFunc = Callable[[int], int]


def uniform_blocksize(n: int, nb: int) -> TileSizeFunc:
    """Reference func.hh:39 — tile i size, ragged last tile."""
    def size(i: int) -> int:
        return min(nb, n - i * nb)
    return size


def process_2d_grid(order: GridOrder, p: int, q: int) -> TileRankFunc:
    """2D block-cyclic tile→rank map (reference func.hh:178-185)."""
    def rank(ij: Tuple[int, int]) -> int:
        i, j = ij
        if order is GridOrder.Col:
            return int(i % p + (j % q) * p)
        return int((i % p) * q + j % q)
    return rank


def process_1d_grid(order: GridOrder, size: int) -> TileRankFunc:
    """1D cyclic map (column of processes if Col)."""
    def rank(ij: Tuple[int, int]) -> int:
        i, j = ij
        return int(i % size) if order is GridOrder.Col else int(j % size)
    return rank


def device_2d_grid(order: GridOrder, p: int, q: int) -> TileRankFunc:
    """Reference func.hh:100-121: the tile -> local-device map, the same
    map as the process grid's."""
    return process_2d_grid(order, p, q)


def device_1d_grid(order: GridOrder, size: int) -> TileRankFunc:
    """Reference func.hh:146."""
    return process_1d_grid(order, size)


def transpose_grid(f: TileRankFunc) -> TileRankFunc:
    """Reference func.hh:229."""
    def rank(ij: Tuple[int, int]) -> int:
        i, j = ij
        return f((j, i))
    return rank


def is_2d_cyclic_grid(mt: int, nt: int, f: TileRankFunc
                      ) -> Tuple[bool, GridOrder, int, int]:
    """Detect whether f is a 2D block-cyclic grid on an mt x nt tile grid
    (reference func.hh:265). Returns (is_cyclic, order, p, q)."""
    if mt <= 0 or nt <= 0:
        return (True, GridOrder.Col, 1, 1)
    # p = first i whose rank repeats rank(0,0) going down the column
    r00 = f((0, 0))
    p = mt
    for i in range(1, mt):
        if f((i, 0)) == r00:
            p = i
            break
    q = nt
    for j in range(1, nt):
        if f((0, j)) == r00:
            q = j
            break
    order = GridOrder.Col
    if mt > 1 and p > 1:
        order = GridOrder.Col if f((1, 0)) == r00 + 1 else GridOrder.Row
    expect = process_2d_grid(order, p, q)
    ok = all(f((i, j)) == expect((i, j))
             for i in range(mt) for j in range(nt))
    return (ok, order, p, q)

"""Distributed Cuppen divide & conquer for the symmetric tridiagonal
eigenproblem (counterpart of ``slate_tpu/dist/stedc.py``): the
reference's rank-parallel stedc (stedc_solve.cc:97-171 splitting across
ranks, stedc.cc:70-97 distributed workspace, stedc_merge.cc cross-rank
back-transform).

The phase functions are the one-device driver's (linalg/stedc.py:
stedc_split / stedc_leaves / stedc_merge); this driver adds the
placement over the grid:

  * leaf solves and the lower merge levels: the subproblem batch is
    split over the flattened ('p', 'q') grid, each rank solves and
    merges its own subproblems whole, and the results are gathered (of
    a batch that does not split, rank 0's whole result is broadcast);
  * top merge levels (fewer pairs than ranks): the O(n^3) bulk, the G @
    U rotation compose and the Q @ (G U) back-transform, runs through
    :func:`matmul_sharded` (each rank one block of the product, full k,
    gathered); the O(n) deflation and secular phases
    run on every rank, as the reference's run replicated per rank.

Every rank returns the same (w, V).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..obs.events import instrument_driver
from ..core.tiles import ceil_div
from ..parallel.collectives import all_reduce, broadcast_many
from ..parallel.mesh import ProcessGrid
from ..parallel.owner import Owner, product


def matmul_sharded(grid: ProcessGrid, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """a @ b with rank (r, c) forming the block of rows r and columns c
    in tiles of (ceil(m/p), ceil(n/q)) from a full-k product (no split
    reduction), the blocks gathered to every rank (owner.product: the
    tiles are exact for any m and n)."""
    m, n = a.shape[0], b.shape[1]
    o = Owner(grid, (m, n), max(ceil_div(m, grid.p), 1),
              max(ceil_div(n, grid.q), 1), a.device)
    return product(o, a, b)


def _batch_split(grid: ProcessGrid, f: Callable, *xs):
    """f over a leading batch split evenly over the grid's ranks, the
    outputs gathered. A batch that does not split is formed whole on
    every rank and rank 0's result broadcast, so all ranks agree."""
    B, P = xs[0].shape[0], grid.nprocs
    if B % P:
        outs = f(*xs)
        return tuple(broadcast_many(grid, list(outs), 0))
    h = B // P
    i = grid.index
    outs = f(*(x[i * h:(i + 1) * h] for x in xs))
    full = []
    for y in outs:
        z = torch.zeros((B,) + tuple(y.shape[1:]), dtype=y.dtype,
                        device=y.device)
        z[i * h:(i + 1) * h] = y
        full.append(all_reduce(grid, z, kind="all-gather"))
    return tuple(full)


def _merge_sharded(grid: ProcessGrid, D1, V1, D2, V2, rho
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Cuppen merge with the back-transform products distributed
    by matmul_sharded (module doc)."""
    from ..linalg.stedc import stedc_merge
    return stedc_merge(D1, V1, D2, V2, rho,
                       product=lambda x, y: matmul_sharded(grid, x, y))


@instrument_driver("stedc_dist")
def stedc_solve_dist(grid: ProcessGrid, d: torch.Tensor, e: torch.Tensor,
                     leaf: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid stedc_solve: same mathematics, scheduled placement
    (module doc). Returns (w, V) ascending, the same on every rank."""
    from ..linalg.stedc import (stedc_leaves, stedc_merge, stedc_solve,
                                stedc_split)
    from ..obs import events as obs_events
    n = d.shape[0]
    if obs_events.enabled():
        obs_events.instant("comms:stedc_dist", cat="comms", n=int(n),
                           leaf=leaf, nprocs=grid.nprocs)
    if n <= leaf:
        return tuple(broadcast_many(
            grid, list(stedc_solve(d, e, leaf=leaf)), 0))
    dp, ep, N, nl = stedc_split(d, e, leaf)
    w, V = _batch_split(grid, stedc_leaves, dp.reshape(nl, leaf),
                        ep[:N].reshape(nl, leaf)[:, :-1])
    s = leaf
    while s < N:
        rhos = ep[torch.arange(s, N, 2 * s, device=d.device) - 1]
        pairs = V.shape[0] // 2
        if pairs % grid.nprocs == 0:
            w, V = _batch_split(grid, stedc_merge, w[0::2], V[0::2],
                                w[1::2], V[1::2], rhos)
        else:
            merged = [_merge_sharded(grid, w[2 * i], V[2 * i],
                                     w[2 * i + 1], V[2 * i + 1], rhos[i])
                      for i in range(pairs)]
            w = torch.stack([mw for mw, _ in merged])
            V = torch.stack([mv for _, mv in merged])
        s *= 2
    return w[0][:n], V[0][:n, :n]

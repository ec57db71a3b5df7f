"""LAPACK-style info codes (counterpart of ``slate_tpu/linalg/info.py``):
``first_fail``, ``lu_info`` and the guarded blocked Cholesky behind
``potrf(..., return_info=True)``. Conventions are LAPACK's: info == 0
success, info == k > 0 the first failure (1-based). Every info stays a
device tensor; nothing is read back to the host."""

from __future__ import annotations

from typing import Tuple

import torch


def first_fail(bad: torch.Tensor) -> torch.Tensor:
    """1-based index of the first True in bad, else 0 (int32, 0-d)."""
    n = bad.shape[0]
    idx = torch.where(bad, torch.arange(n, device=bad.device),
                      torch.full((), n, device=bad.device))
    first = idx.min() if n else torch.tensor(n, device=bad.device)
    return torch.where(first < n, first + 1,
                       torch.zeros((), dtype=first.dtype,
                                   device=bad.device)).to(torch.int32)


def _chol_block_guarded(s: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked lower Cholesky of one diagonal block that never
    produces NaN: a non-positive or non-finite pivot is recorded (first
    occurrence, 1-based) and replaced by 1, so the loop keeps a defined
    (garbage but finite) state, as LAPACK potrf returns iinfo for the
    tile. Rows above each column keep their values, as the reference's
    masked column write."""
    nb = s.shape[0]
    s = s.clone()
    bad = torch.zeros((), dtype=torch.int32, device=s.device)
    one = torch.ones((), dtype=s.real.dtype, device=s.device)
    for j in range(nb):
        d = s[j, j].real
        isbad = ~(d > 0) | ~torch.isfinite(d)
        bad = torch.where(isbad & (bad == 0), j + 1, bad)
        piv = torch.sqrt(torch.where(isbad, one, d)).to(s.dtype)
        col = s[j + 1:, j] / piv
        s[j, j] = piv
        s[j + 1:, j] = col
        s[j + 1:, j + 1:] -= torch.outer(col, col.conj())
    return s, bad


def cholesky_blocked_info(a: torch.Tensor, nb: int, lookahead: int = 1,
                          grid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked lower Cholesky with exact failure reporting, the
    return_info path of potrf: the blocked loops of the fast path (the
    grid loop under a grid) with the guarded diagonal-block factor, so
    the index of the first leading minor that is not positive definite
    survives. Returns (L, info); L is valid when info == 0."""
    from .blocked import chol_loop, chol_loop_grid, chol_loop_pipelined
    if grid is not None:
        return chol_loop_grid(a, nb, _chol_block_guarded, grid)
    loop = chol_loop_pipelined if lookahead >= 1 else chol_loop
    return loop(a, nb, _chol_block_guarded)


def lu_info(ludata: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """info for a packed LU factor: first exactly-zero or non-finite
    U(k,k) (LAPACK getrf convention)."""
    d = ludata.diagonal()[:min(m, n)]
    return first_fail((d == 0) | ~torch.isfinite(d))

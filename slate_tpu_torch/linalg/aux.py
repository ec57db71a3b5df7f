"""Aux / elementwise drivers (counterpart of ``slate_tpu/linalg/aux.py``;
reference slate.hh:48-159, 428): add, copy, scale, scale_row_col, set,
set_entries and redistribute, over ops/tile_ops.py. The trapezoid ops
take every structured type (they touch the stored triangle only).
``redistribute`` onto a grid is the same copy (every rank holds the
global matrix)."""

from __future__ import annotations

import dataclasses

import torch

from ..core.enums import MatrixType
from ..core.options import OptionsLike
from ..core.tiles import TiledMatrix
from ..ops import tile_ops
from ..ops.masks import bounds_mask

_TRAPEZOID = (MatrixType.Trapezoid, MatrixType.Triangular,
              MatrixType.Symmetric, MatrixType.Hermitian)


def add(alpha, A: TiledMatrix, beta, B: TiledMatrix,
        opts: OptionsLike = None) -> TiledMatrix:
    """B := alpha A + beta B (reference slate.hh:48)."""
    if B.mtype in _TRAPEZOID:
        return tile_ops.tzadd(alpha, A, beta, B)
    return tile_ops.geadd(alpha, A, beta, B)


def copy(A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """B := A, with type conversion (reference slate.hh:62)."""
    if B.mtype in _TRAPEZOID:
        return tile_ops.tzcopy(A, B)
    return tile_ops.gecopy(A, B)


def scale(numer, denom, A: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """A := (numer / denom) A (reference slate.hh:71)."""
    if A.mtype in _TRAPEZOID:
        return tile_ops.tzscale(numer, denom, A)
    return tile_ops.gescale(numer, denom, A)


def scale_row_col(R, C, A: TiledMatrix,
                  opts: OptionsLike = None) -> TiledMatrix:
    """A := diag(R) A diag(C) (reference slate.hh:111)."""
    return tile_ops.gescale_row_col(R, C, A)


def set(offdiag_value, diag_value, A: TiledMatrix,
        opts: OptionsLike = None) -> TiledMatrix:
    """A := offdiag everywhere, diag on the diagonal (slate.hh:121).
    The lambda-set variant (src/set_lambdas.cc) is set_entries."""
    if A.mtype in _TRAPEZOID:
        return tile_ops.tzset(A, offdiag_value, diag_value)
    return tile_ops.geset(A, offdiag_value, diag_value)


def set_entries(fn, A: TiledMatrix) -> TiledMatrix:
    """Lambda-set: A[i, j] = fn(i, j), fn called once on broadcastable
    index tensors (rows (m_pad, 1), columns (1, n_pad)) on A's device
    (reference src/set_lambdas.cc); the padding stays zero."""
    r = A.resolve()
    mp, np_ = r.data.shape
    dev = r.data.device
    ii = torch.arange(mp, device=dev)[:, None]
    jj = torch.arange(np_, device=dev)[None, :]
    vals = torch.as_tensor(fn(ii, jj), dtype=r.dtype, device=dev)
    data = torch.where(bounds_mask(r.data.shape, r.m, r.n, device=dev),
                       vals, torch.zeros((), dtype=r.dtype, device=dev))
    return dataclasses.replace(r, data=data)


def redistribute(A: TiledMatrix, B: TiledMatrix,
                 opts: OptionsLike = None) -> TiledMatrix:
    """Copy A into B's tiling, type and device (reference
    src/redistribute.cc:43-120). Onto a grid (Option.Grid, a
    ``parallel.ProcessGrid``) too it is that copy: every rank of a grid
    holds the global matrix (ROADMAP queue 3), so the new tiling
    changes which tiles each rank updates, not what it stores. For the
    2D block-cyclic storage order use parallel.sharding.to_cyclic /
    distribute_cyclic."""
    from ..parallel.mesh import option_grid
    option_grid(opts, "redistribute")
    r, rb = A.resolve(), B.resolve()
    mp, np_ = rb.data.shape
    d = r.data[:r.m, :r.n].to(device=rb.device, dtype=rb.dtype)
    data = torch.nn.functional.pad(d, (0, np_ - r.n, 0, mp - r.m))
    return dataclasses.replace(rb, data=data)

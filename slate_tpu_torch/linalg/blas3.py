"""BLAS-3 drivers (counterpart of ``slate_tpu/linalg/blas3.py``),
reduced to the LU slice: ``gemm`` and ``trsm``. Each driver is one
dense op on the logical matrix, written back into the output's padded
tiled storage. Other BLAS-3 routines wait for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.enums import Side, Uplo
from ..core.exceptions import DimensionError
from ..core.options import OptionsLike
from ..core.tiles import TiledMatrix


def _logical(A: TiledMatrix) -> torch.Tensor:
    return A.to_dense()


def _store(C: TiledMatrix, new_logical: torch.Tensor) -> TiledMatrix:
    """Write a logical (m, n) result back into C's padded storage."""
    r = C.resolve()
    mp, np_ = r.data.shape
    data = torch.nn.functional.pad(new_logical.to(r.dtype),
                                   (0, np_ - r.shape[1],
                                    0, mp - r.shape[0]))
    return dataclasses.replace(r, data=data)


def gemm(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha op(A) op(B) + beta C (reference src/gemm.cc:72).
    Full f32 precision: the package turns TF32 off at import."""
    m, k = A.shape
    k2, n = B.shape
    if k != k2 or C.shape != (m, n):
        raise DimensionError(f"gemm: {A.shape} x {B.shape} -> {C.shape}")
    c = alpha * (_logical(A) @ _logical(B)) + beta * _logical(C)
    return _store(C, c)


def trsm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """Solve op(A) X = alpha B (Left) or X op(A) = alpha B (Right);
    A triangular (reference src/trsm.cc). to_dense applies the
    triangle mask and bakes Diag.Unit ones onto the diagonal, so the
    solve always sees the logical matrix."""
    from .blocked import trsm_dense
    ra = A.resolve()
    b = _logical(B)
    x = trsm_dense(ra.to_dense(), alpha * b, left=(side is Side.Left),
                   lower=ra.uplo is Uplo.Lower, nb=ra.nb)
    return _store(B, x)

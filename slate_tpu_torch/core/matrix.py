"""Matrix constructors (counterpart of ``slate_tpu/core/matrix.py``).

Each returns a TiledMatrix tagged with the right MatrixType. Data goes
to `device`: the CUDA card unless the caller names another.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.backend import DeviceLike
from .enums import Diag, MatrixType, Uplo
from .exceptions import DimensionError
from .tiles import TiledMatrix


def Matrix(a=None, *, m: int = 0, n: int = 0, mb: int = 256,
           nb: Optional[int] = None, dtype=torch.float32,
           device: DeviceLike = None) -> TiledMatrix:
    """General m x n matrix (reference Matrix.hh:26)."""
    if a is not None:
        return TiledMatrix.from_dense(a, mb, nb, device=device)
    return TiledMatrix.zeros(m, n, mb, nb, dtype, device=device)


def _structured(a, m, n, mb, nb, dtype, mtype, uplo, diag, device,
                kl: int = -1, ku: int = -1,
                square: bool = True) -> TiledMatrix:
    if a is not None:
        t = TiledMatrix.from_dense(a, mb, nb, mtype=mtype, uplo=uplo,
                                   diag=diag, kl=kl, ku=ku, device=device)
    else:
        t = TiledMatrix.zeros(m, n or m, mb, nb, dtype, device=device,
                              mtype=mtype, uplo=uplo, diag=diag, kl=kl,
                              ku=ku)
    if square and t.m != t.n:
        raise DimensionError(f"{mtype.name} matrix must be square, "
                             f"got {t.m}x{t.n}")
    return t


def TrapezoidMatrix(uplo: Uplo, a=None, *, m=0, n=0, mb=256, nb=None,
                    diag=Diag.NonUnit, dtype=torch.float32,
                    device: DeviceLike = None) -> TiledMatrix:
    """Reference TrapezoidMatrix.hh:26: m x n, the `uplo` trapezoid
    stored."""
    return _structured(a, m, n, mb, nb, dtype, MatrixType.Trapezoid, uplo,
                       diag, device, square=False)


def TriangularMatrix(uplo: Uplo, a=None, *, n=0, mb=256, nb=None,
                     diag=Diag.NonUnit, dtype=torch.float32,
                     device: DeviceLike = None) -> TiledMatrix:
    """Reference TriangularMatrix.hh:30."""
    return _structured(a, n, n, mb, nb, dtype, MatrixType.Triangular,
                       uplo, diag, device)


def SymmetricMatrix(uplo: Uplo, a=None, *, n=0, mb=256, nb=None,
                    dtype=torch.float32,
                    device: DeviceLike = None) -> TiledMatrix:
    """Reference SymmetricMatrix.hh:26."""
    return _structured(a, n, n, mb, nb, dtype, MatrixType.Symmetric,
                       uplo, Diag.NonUnit, device)


def HermitianMatrix(uplo: Uplo, a=None, *, n=0, mb=256, nb=None,
                    dtype=torch.float32,
                    device: DeviceLike = None) -> TiledMatrix:
    """Reference HermitianMatrix.hh:26."""
    return _structured(a, n, n, mb, nb, dtype, MatrixType.Hermitian,
                       uplo, Diag.NonUnit, device)


def HermitianBandMatrix(uplo: Uplo, kd: int, a=None, *, n=0, mb=256,
                        nb=None, dtype=torch.float32,
                        device: DeviceLike = None) -> TiledMatrix:
    """Reference HermitianBandMatrix.hh:29: band width kd in the stored
    triangle (kl = kd for Lower, ku = kd for Upper)."""
    kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
    return _structured(a, n, n, mb, nb, dtype, MatrixType.HermitianBand,
                       uplo, Diag.NonUnit, device, kl=kl, ku=ku)


def BandMatrix(kl: int, ku: int, a=None, *, m=0, n=0, mb=256, nb=None,
               dtype=torch.float32,
               device: DeviceLike = None) -> TiledMatrix:
    """General band matrix (reference BandMatrix.hh:26), m x n with kl
    sub- and ku superdiagonals. Storage is dense and tile-aligned, the
    band applied as a mask (``to_dense``); the band drivers restrict
    their work to windows around the diagonal."""
    return _structured(a, m, n, mb, nb, dtype, MatrixType.GeneralBand,
                       Uplo.General, Diag.NonUnit, device, kl=kl, ku=ku,
                       square=False)


def TriangularBandMatrix(uplo: Uplo, kd: int, a=None, *, n=0, mb=256,
                         nb=None, diag=Diag.NonUnit, dtype=torch.float32,
                         device: DeviceLike = None) -> TiledMatrix:
    """Reference TriangularBandMatrix.hh:28: band width kd in the
    stored triangle (kl = kd for Lower, ku = kd for Upper)."""
    kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
    return _structured(a, n, n, mb, nb, dtype, MatrixType.TriangularBand,
                       uplo, diag, device, kl=kl, ku=ku)

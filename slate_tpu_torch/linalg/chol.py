"""Cholesky family (counterpart of ``slate_tpu/linalg/chol.py``) on one
device: potrf / potrs / posv (with ``return_info``), trtri / trtrm /
potri, the band pbtrf / pbtrs / pbsv, and the mixed-precision solves
posv_mixed / posv_mixed_gmres.

``potrf`` with Auto takes the Fused route, one library Cholesky of the
whole matrix (``blocked.chol_diag_factor``: cuSOLVER on the card,
LAPACK on the CPU), as the reference hands it to XLA's ``cholesky``;
``MethodFactor.Tiled`` runs the blocked loop
(``blocked.cholesky_blocked``). A bf16 factor (the lo precision of
posv_mixed) factors the f32 upcast and rounds, because no library has
a bf16 Cholesky (ROADMAP queue 3). No hand kernel runs on these paths:
the reference's Cholesky paths call XLA, not its ``chol_panel`` or
``trtri_lower`` Pallas kernels, whose ports are the public entries in
``ops/kernels.py``.

The band Cholesky pbtrf / pbtrs / pbsv runs the windowed band
algorithms of ``band.py`` on a narrow band and the dense drivers on a
wide one, as the reference.

Under ``Option.Grid`` (a ``parallel.ProcessGrid``) potrf takes the
blocked grid loop whatever the method (the reference's Auto resolves
to Tiled on a grid, chol.py:69; its Fused call is one replicated XLA
program, which a process grid does not have): the owner-computes
``blocked.chol_loop_grid``. potrs and posv pass the grid on to the
grid trsm.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.enums import Diag, MatrixType, Side, Uplo
from ..core.exceptions import slate_assert
from ..core.methods import MethodFactor
from ..core.options import Option, OptionsLike, get_option, get_option_tuned
from ..core.tiles import TiledMatrix, ceil_div, pad_diag_identity, round_up
from ..obs.events import instrument_driver
from ..parallel.mesh import option_grid
from .blas3 import _store, trsm


@instrument_driver("potrf")
def potrf(A: TiledMatrix, opts: OptionsLike = None,
          return_info: bool = False):
    """Cholesky factor A = L L^H (or U^H U); returns a TriangularMatrix
    with A's uplo (reference src/potrf.cc:262). With return_info=True
    returns (L, info): info == 0 on success, k > 0 if the leading minor
    of order k is not positive definite (a 0-d int32 tensor on A's
    device). A HermitianBand A gives a TriangularBand factor with its
    bandwidths (pbtrf's wide-band route)."""
    slate_assert(A.mtype in (MatrixType.Hermitian, MatrixType.Symmetric,
                             MatrixType.HermitianBand),
                 "potrf: A must be Hermitian/symmetric")
    grid = option_grid(opts, "potrf")
    r = A.uniform().resolve()
    nb = r.nb
    method = get_option(opts, Option.MethodFactor, MethodFactor.Auto)
    if grid is not None:
        method = MethodFactor.Tiled
    elif method is MethodFactor.Auto:
        from ..tune.select import tuned_method
        cached = tuned_method("potrf", "factor", opts=opts,
                              option=Option.MethodFactor, n=r.n,
                              dtype=r.dtype)
        method = cached if cached is not None \
            and cached is not MethodFactor.Auto \
            else MethodFactor.select(r.data)
    # square padded storage, a multiple of nb; the factor uses mb = nb
    np_ = ceil_div(max(r.n, 1), nb) * nb
    if method is MethodFactor.Fused and not return_info \
            and r.data.shape == (np_, np_) and r.mb == nb \
            and A.mtype is not MatrixType.HermitianBand:
        # the factorization reads only the stored triangle: hand the raw
        # padded storage (transposed for Upper) without mirroring it
        a = r.data if r.uplo is Uplo.Lower else r.data.mH
        a = pad_diag_identity(a, r.n, r.n)
    else:
        full = A.to_dense()
        a = torch.nn.functional.pad(full, (0, np_ - r.n, 0, np_ - r.m))
        a = pad_diag_identity(a, r.m, r.n)
    info = None
    if method is MethodFactor.Fused and not return_info:
        from .blocked import chol_diag_factor
        L = chol_diag_factor(a)
    else:
        from .blocked import cholesky_blocked
        from .info import cholesky_blocked_info
        lookahead = get_option_tuned(opts, Option.Lookahead, "potrf",
                                     n=r.n, dtype=r.dtype)
        if return_info:
            L, info = cholesky_blocked_info(a, nb, lookahead=lookahead,
                                            grid=grid)
        else:
            L = cholesky_blocked(a, nb, lookahead=lookahead, grid=grid)
    data = L.mH if r.uplo is Uplo.Upper else L
    band = A.mtype is MatrixType.HermitianBand
    out = dataclasses.replace(
        r, data=data, mb=nb, nb=nb,
        mtype=MatrixType.TriangularBand if band else MatrixType.Triangular,
        diag=Diag.NonUnit, kl=r.kl if band else -1, ku=r.ku if band else -1)
    if return_info:
        return out, info
    return out


def potrs(A: TiledMatrix, B: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """Solve with the factor from potrf (reference src/potrs.cc:75-77:
    two triangular solves)."""
    if A.uplo is Uplo.Lower:
        X = trsm(Side.Left, 1.0, A, B, opts)                   # L y = b
        return trsm(Side.Left, 1.0, A.conj_transpose(), X, opts)
    X = trsm(Side.Left, 1.0, A.conj_transpose(), B, opts)      # U^H y = b
    return trsm(Side.Left, 1.0, A, X, opts)


@instrument_driver("posv")
def posv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None,
         return_info: bool = False):
    """Solve A X = B, A Hermitian positive definite (reference
    src/posv.cc:83-91). Returns (factor, X), or (factor, X, info) with
    return_info=True. When info > 0, X is NaN (the reference skips the
    solve; here both branches are computed and one is selected on the
    device, so info is never read back to the host)."""
    from ..utils.trace import phases
    ph = phases(opts)
    if return_info:
        with ph("posv::potrf"):
            L, info = potrf(A, opts, return_info=True)
        with ph("posv::potrs"):
            X = potrs(L, B, opts)
            data = torch.where(info == 0, X.data,
                               torch.full_like(X.data, float("nan")))
        return L, dataclasses.replace(X, data=data), info
    with ph("posv::potrf"):
        L = potrf(A, opts)
    with ph("posv::potrs"):
        X = potrs(L, B, opts)
    return L, X


def trtri(A: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """Triangular inverse (reference src/trtri.cc): the block is
    identity-padded to a multiple of 128 and inverted by
    ``blocked.invert_triangular``."""
    from .blocked import invert_triangular
    r = A.resolve()
    a = r.to_dense()
    n = a.shape[0]
    npd = round_up(max(n, 1), 128)
    if npd != n:
        # inv of blkdiag(A, I) is blkdiag(inv(A), I)
        a = pad_diag_identity(
            torch.nn.functional.pad(a, (0, npd - n, 0, npd - n)), n, n)
    inv = invert_triangular(a, lower=(r.uplo is Uplo.Lower),
                            unit_diagonal=(r.diag is Diag.Unit))[:n, :n]
    return _store(r, inv)


def trtrm(A: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """L := L^H L or U := U U^H on the triangle (reference
    src/trtrm.cc), the second half of potri."""
    r = A.resolve()
    a = r.to_dense()
    prod = a.mH @ a if r.uplo is Uplo.Lower else a @ a.mH
    out = _store(r, prod)
    return dataclasses.replace(out, mtype=MatrixType.Hermitian,
                               diag=Diag.NonUnit)


def potri(A: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """A^{-1} from the potrf factor (reference src/potri.cc: trtri then
    trtrm)."""
    return trtrm(trtri(A, opts), opts)


# -- band Cholesky --------------------------------------------------------

def _use_band_path(A: TiledMatrix, width: int) -> bool:
    from .band import band_is_narrow
    r = A.resolve()
    return band_is_narrow(r.n, r.nb, width)


def pbtrf(A: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """Band Cholesky (reference src/pbtrf.cc, slate.hh:758): the
    windowed O(n kd^2) band algorithm (``band.pbtrf_band``) when the
    band is narrow, the dense potrf otherwise (the factor of a kd-band
    SPD matrix is kd-band triangular either way). The band factor is a
    TriangularBand matrix with A's uplo and bandwidths."""
    from .band import band_width_of, pbtrf_band
    kd = band_width_of(A)
    if A.mtype is MatrixType.HermitianBand and _use_band_path(A, kd):
        r = A.resolve()
        np_ = ceil_div(max(r.n, 1), r.nb) * r.nb
        a = torch.nn.functional.pad(A.to_dense(),
                                    (0, np_ - r.n, 0, np_ - r.m))
        L = pbtrf_band(pad_diag_identity(a, r.m, r.n), r.n, r.nb, kd)
        if r.uplo is Uplo.Upper:
            L = L.mH
        return dataclasses.replace(
            r, data=L, mb=r.nb, nb=r.nb, mtype=MatrixType.TriangularBand,
            diag=Diag.NonUnit, kl=r.kl, ku=r.ku)
    return potrf(A, opts)


def pbtrs(A: TiledMatrix, B: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """Band solve from the pbtrf factor (reference slate.hh:784): two
    windowed band triangular solves, O(n kd nrhs); a dense factor
    (pbtrf's wide-band fallback) takes potrs."""
    from .band import band_trsm_lower, band_width_of
    kd = band_width_of(A)
    if A.mtype is MatrixType.TriangularBand and _use_band_path(A, kd):
        r = A.resolve()
        l = r.to_dense() if r.uplo is Uplo.Lower else r.to_dense().mH
        y = band_trsm_lower(l, B.to_dense(), r.n, r.nb, kd)
        return _store(B, band_trsm_lower(l, y, r.n, r.nb, kd,
                                         conj_trans=True))
    return potrs(A, B, opts)


def pbsv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Band positive-definite solve (reference slate.hh:665): pbtrf,
    then pbtrs. Returns (factor, X)."""
    L = pbtrf(A, opts)
    return L, pbtrs(L, B, opts)


# -- mixed precision --------------------------------------------------------

def _lo_factor(A: TiledMatrix, opts: OptionsLike):
    from .refine import lo_dtype
    r = A.resolve()
    lo = lo_dtype(r.dtype)
    return lo, potrf(dataclasses.replace(r, data=r.data.to(lo)), opts)


@instrument_driver("posv_mixed")
def posv_mixed(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Mixed-precision Cholesky with iterative refinement (reference
    src/posv_mixed.cc): a lo-precision factor (f32 -> bf16, f64 ->
    f32), hi-precision residuals, the full-precision solve as the
    fallback. Returns (factor_lo, X, iters); iters < 0 means the
    fallback produced X."""
    from .refine import iterative_refinement, lo_rhs_solver
    lo, L = _lo_factor(A, opts)
    solve_lo = lo_rhs_solver(B, lo, lambda rhs: potrs(L, rhs, opts))

    def full_solve():
        return potrs(potrf(A, opts), B, opts).to_dense()

    x, iters = iterative_refinement(A, B, solve_lo, full_solve, opts)
    return L, _store(B, x), iters


@instrument_driver("posv_mixed_gmres")
def posv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: OptionsLike = None):
    """Mixed-precision FGMRES-IR Cholesky (reference
    src/posv_mixed_gmres.cc), right-preconditioned by the lo-precision
    Cholesky solve. One right-hand side."""
    from .refine import fgmres_ir, lo_rhs_solver
    slate_assert(B.shape[1] == 1,
                 "posv_mixed_gmres supports one right-hand side")
    lo, L = _lo_factor(A, opts)
    solve_lo = lo_rhs_solver(B, lo, lambda rhs: potrs(L, rhs, opts))

    def full_solve():
        return potrs(potrf(A, opts), B, opts).to_dense()

    x, iters = fgmres_ir(A, B, solve_lo, full_solve,
                         restart_cap=max(A.resolve().mb - 1, 1), opts=opts)
    return L, _store(B, x), iters

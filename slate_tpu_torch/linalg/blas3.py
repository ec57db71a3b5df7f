"""BLAS-3 drivers (counterpart of ``slate_tpu/linalg/blas3.py``):
gemm (and its gemmA / gemmC names), hemm/symm, trmm, trsm (and trsmA /
trsmB), herk/syrk and her2k/syr2k. Each driver is
one dense op on the logical matrix (``to_dense`` applies the structure),
written back into the output's padded tiled storage. The band routines
gbmm / hbmm (the batched window product ``band.band_mm`` on a narrow
band) and tbsm (the windowed band solves, with either pivot
convention) fall back to gemm / hemm / trsm on a wide band.

Under ``Option.Grid`` (a ``parallel.ProcessGrid``), gemm's Auto is
owner-computes: each rank forms its tiles of C (C's 2D block-cyclic
map), and the tiles are gathered, so every rank gets all of C; a
measured tune entry can promote it to SUMMA, as the reference's
(blas3.py:63-73). ``MethodGemm.Summa`` runs
``parallel.collectives.summa_gemm`` on the padded operands' local
blocks (m and n padded to multiples of p*q, k by ``pad_k``), then
gathers C. Without a grid, Summa is the one-device product. trsm runs
the reference's blocked grid loop (``blocked._trsm_left_grid``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.enums import MatrixType, Side, Uplo
from ..core.exceptions import DimensionError, slate_assert
from ..core.enums import Option
from ..core.options import OptionsLike, get_option
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


def _gemm_summa(alpha, a: torch.Tensor, b: torch.Tensor, beta,
                c: torch.Tensor, grid) -> torch.Tensor:
    """MethodGemm.Summa on a grid (reference blas3.py:74-88): m and n
    padded to multiples of p*q, k by pad_k, the per-step SUMMA on the
    local blocks, C gathered."""
    from ..core.tiles import round_up
    from ..parallel import collectives as coll
    from ..parallel.sharding import assemble, local_block
    m, n = c.shape
    pq = grid.p * grid.q
    mp, np_ = round_up(max(m, 1), pq), round_up(max(n, 1), pq)
    a, b = coll.pad_k(grid, a, b)
    ap = torch.nn.functional.pad(a, (0, 0, 0, mp - m))
    bp = torch.nn.functional.pad(b, (0, np_ - n))
    blk = coll.summa_gemm(grid, local_block(grid, ap),
                          local_block(grid, bp))
    prod = assemble(grid, blk, (mp, np_))[:m, :n]
    return alpha * prod + beta * c


def gemm(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha op(A) op(B) + beta C (reference src/gemm.cc:72).
    Full f32 precision: the package turns TF32 off at import.
    ``MethodGemm`` A, C, Auto and Summa are the one-device product; on
    a grid, Auto is owner-computes and Summa the SUMMA schedule (module
    doc)."""
    from ..core.methods import MethodGemm
    from ..parallel.mesh import option_grid
    m, k = A.shape
    k2, n = B.shape
    if k != k2 or C.shape != (m, n):
        raise DimensionError(f"gemm: {A.shape} x {B.shape} -> {C.shape}")
    grid = option_grid(opts, "gemm")
    if grid is None:
        c = alpha * (_logical(A) @ _logical(B)) + beta * _logical(C)
        return _store(C, c)
    method = get_option(opts, Option.MethodGemm, MethodGemm.Auto)
    if method is MethodGemm.Auto:
        from ..tune.select import tuned_method
        from ..parallel.collectives import agree
        cached = tuned_method("gemm", "gemm", opts=opts,
                              option=Option.MethodGemm, n=min(m, n),
                              dtype=C.dtype)
        # the route decides the grid's collectives: grid rank 0's
        if agree(grid, cached is MethodGemm.Summa)[0]:
            method = MethodGemm.Summa
    a, b, c = _logical(A), _logical(B), _logical(C)
    if method is MethodGemm.Summa:
        return _store(C, _gemm_summa(alpha, a, b, beta, c, grid))
    # owner-computes: this rank's tiles of C (its block-cyclic rows and
    # columns), then a gather over the grid
    from ..parallel import owner as own
    r = C.resolve()
    o = own.Owner(grid, tuple(c.shape), r.mb, r.nb, c.device)
    return _store(C, own.product(o, a, b, alpha, beta, c))


def gemmA(alpha, A, B, beta, C, opts=None, **kw):
    """gemmA variant (reference src/gemmA.cc: keeps C traffic low for
    few columns). On one device both variants are the same product."""
    return gemm(alpha, A, B, beta, C, opts, **kw)


def gemmC(alpha, A, B, beta, C, opts=None, **kw):
    """gemmC variant (reference src/gemmC.cc)."""
    return gemm(alpha, A, B, beta, C, opts, **kw)


def gbmm(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """Band A times general B (reference src/gbmm.cc, slate.hh:181). A
    narrow band runs the windowed product (``band.band_mm``: one
    batched product over block-row windows read from the storage,
    O(m (kl + ku + nb) p) operations, the reference's in-band tiles
    only); a wide band, or
    kl / ku sentinels (-1: full), take the dense gemm."""
    from ..core.enums import Op
    from .band import band_is_narrow, band_mm
    m, k = A.shape
    if B.shape[0] != k or C.shape != (m, B.shape[1]):
        raise DimensionError(f"gbmm: {A.shape} x {B.shape} -> {C.shape}")
    # route on metadata only (resolve materialises the transpose);
    # transposed views swap kl / ku and mb / nb
    if A.op is Op.NoTrans:
        kl, ku, nbE = A.kl, A.ku, A.nb
    else:
        kl, ku, nbE = A.ku, A.kl, A.mb
    if A.mtype is MatrixType.GeneralBand and kl >= 0 and ku >= 0 \
            and band_is_narrow(min(A.shape), nbE, max(kl, ku)):
        r = A.resolve()
        prod = band_mm(r.data, r.kl, r.ku, B.to_dense(), r.nb,
                       shape=(r.m, r.n))
        return _store(C, alpha * prod + beta * _logical(C))
    return gemm(alpha, A, B, beta, C, opts)


def hbmm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix, beta,
         C: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """Hermitian-band A (reference src/hbmm.cc, slate.hh:217). A narrow
    band runs the windowed product on the stored triangle's windows
    (``band.band_windows`` mirrors them), kl = ku = kd; the Right side
    reuses it through C = (A^H B^H)^H with A^H = A. kl / ku sentinels
    (-1: full bandwidth) and wide bands take hemm."""
    from ..core.enums import Op
    from .band import band_is_narrow, band_mm
    n = A.shape[0]
    bm, bn = B.shape
    if (bm if side is Side.Left else bn) != n or C.shape != B.shape:
        raise DimensionError(
            f"hbmm: {side} {A.shape} x {B.shape} -> {C.shape}")
    kd = max(A.kl, A.ku)
    nbE = A.nb if A.op is Op.NoTrans else A.mb
    if A.mtype is MatrixType.HermitianBand and A.kl >= 0 and A.ku >= 0 \
            and band_is_narrow(min(A.shape), nbE, kd):
        r = A.resolve()
        b = B.to_dense()
        if side is Side.Right:
            b = b.mH
        prod = band_mm(r.data, kd, kd, b, r.nb, shape=(n, n),
                       uplo=r.uplo)
        if side is Side.Right:
            prod = prod.mH
        return _store(C, alpha * prod + beta * _logical(C))
    return hemm(side, alpha, A, B, beta, C, opts)


def _sided_mm(side: Side, alpha, A, B, beta, C) -> TiledMatrix:
    a, b, c = _logical(A), _logical(B), _logical(C)
    prod = a @ b if side is Side.Left else b @ a
    return _store(C, alpha * prod + beta * c)


def hemm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix, beta,
         C: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha A B + beta C (Left) or alpha B A + beta C (Right), A
    Hermitian (reference src/hemm.cc)."""
    return _sided_mm(side, alpha, A, B, beta, C)


def symm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix, beta,
         C: TiledMatrix, opts: OptionsLike = None) -> TiledMatrix:
    """The symmetric counterpart of hemm (reference src/symm.cc)."""
    return _sided_mm(side, alpha, A, B, beta, C)


def trmm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """B := alpha op(A) B (Left) or alpha B op(A) (Right), A triangular
    (reference src/trmm.cc)."""
    a, b = _logical(A), _logical(B)
    prod = a @ b if side is Side.Left else b @ a
    return _store(B, alpha * prod)


def trsm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """Solve op(A) X = alpha B (Left) or X op(A) = alpha B (Right);
    A triangular (reference src/trsm.cc). to_dense applies the
    triangle mask and bakes Diag.Unit ones onto the diagonal, so the
    solve always sees the logical matrix."""
    from ..parallel.mesh import option_grid
    from .blocked import trsm_dense
    grid = option_grid(opts, "trsm")
    ra, rb = A.resolve(), B.resolve()
    x = trsm_dense(ra.to_dense(), alpha * _logical(B),
                   left=(side is Side.Left), lower=ra.uplo is Uplo.Lower,
                   nb=ra.nb, grid=grid, tiles=(rb.mb, rb.nb))
    return _store(B, x)


def tbsm(side: Side, alpha, A: TiledMatrix, B: TiledMatrix,
         pivots=None, opts: OptionsLike = None) -> TiledMatrix:
    """Triangular-band solve (reference src/tbsm.cc, slate.hh:306),
    with optional pivots from gbtrf. Narrow bands take the
    O(n kd nrhs) windowed sweeps (``band.py``); the rest take trsm.

    `pivots` is either a raw swap vector (the dense getrf convention:
    global swaps, applied as one gather up front) or the LUFactors of
    the windowed band gbtrf, whose block-local pivots are right only
    interleaved with the elimination: for those the lower solve replays
    gbtrs' forward sweep (raw ``F.pivots`` would be wrong whenever a
    pivot crosses a block boundary), and the upper factor needs no
    pivots."""
    from .band import band_is_narrow, band_width_of
    if pivots is not None and getattr(pivots, "band", False):
        F = pivots
        ra = A.resolve()
        if side is Side.Left and ra.uplo is Uplo.Lower:
            from .band import gb_forward_solve
            rf = F.LU.resolve()
            x = gb_forward_solve(rf.data, F.pivots, alpha * B.to_dense(),
                                 rf.n, rf.nb, rf.kl)
            return _store(B, x)
        pivots = None
    elif pivots is not None:
        from .lu import apply_pivots
        B = apply_pivots(pivots, B)
    ra = A.resolve()
    width = band_width_of(ra)
    if side is Side.Left and ra.mtype is MatrixType.TriangularBand \
            and band_is_narrow(ra.n, ra.nb, width):
        from .band import band_trsm_lower, band_trsm_upper
        b = alpha * B.to_dense()
        a = ra.to_dense()
        if ra.uplo is Uplo.Lower:
            x = band_trsm_lower(a, b, ra.n, ra.nb, width,
                                unit_diagonal=False)
        else:
            x = band_trsm_upper(a, b, ra.n, ra.nb, width)
        return _store(B, x)
    return trsm(side, alpha, A, B, opts)


def trsmA(side, alpha, A, B, opts=None):
    """trsmA variant (reference src/trsmA.cc: broadcasts B to A's
    ranks). On one device both variants are the same solve."""
    return trsm(side, alpha, A, B, opts)


def trsmB(side, alpha, A, B, opts=None):
    """trsmB variant (reference src/trsmB.cc)."""
    return trsm(side, alpha, A, B, opts)


# -- rank-k / rank-2k updates ---------------------------------------------

def _conj(alpha):
    return alpha.conjugate() if isinstance(alpha, complex) else alpha


def herk(alpha, A: TiledMatrix, beta, C: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha op(A) op(A)^H + beta C, C Hermitian (reference
    src/herk.cc); alpha and beta real."""
    slate_assert(C.mtype in (MatrixType.Hermitian, MatrixType.Symmetric),
                 "herk: C must be Hermitian")
    a = _logical(A)
    return _store(C, alpha * (a @ a.T.conj()) + beta * _logical(C))


def syrk(alpha, A: TiledMatrix, beta, C: TiledMatrix,
         opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha op(A) op(A)^T + beta C, C symmetric (reference
    src/syrk.cc)."""
    a = _logical(A)
    return _store(C, alpha * (a @ a.T) + beta * _logical(C))


def her2k(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha A B^H + conj(alpha) B A^H + beta C (reference
    src/her2k.cc)."""
    a, b = _logical(A), _logical(B)
    prod = alpha * (a @ b.T.conj()) + _conj(alpha) * (b @ a.T.conj())
    return _store(C, prod + beta * _logical(C))


def syr2k(alpha, A: TiledMatrix, B: TiledMatrix, beta, C: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """C := alpha (A B^T + B A^T) + beta C (reference src/syr2k.cc)."""
    a, b = _logical(A), _logical(B)
    return _store(C, alpha * (a @ b.T + b @ a.T) + beta * _logical(C))

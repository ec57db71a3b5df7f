"""Symmetric-indefinite solvers, Aasen's method (counterpart of
``slate_tpu/linalg/indefinite.py``; reference src/hesv.cc, hetrf.cc,
hetrs.cc and the sysv / sytrf / sytrs aliases).

P A P^T = L T L^H with unit-lower L and Hermitian T. Above n = 2 nb,
``_aasen_blocked`` runs the reference's panel-blocked scheme: per block
column a partial-pivot panel LU (``lu._lu_panel``, with its route
arbitration: the recursive hand kernel when the tune cache routes
``pallas_rec``) nominates pivots, a symmetric permutation (composed by
``lu._compose_swaps``, on the card the ``compose_swaps`` kernel)
applies them, and a block congruence of two large products eliminates
everything below the first subdiagonal block, leaving T block
tridiagonal (bandwidth < 2 nb, LAPACK sytrf_aa), solved by the windowed
band LU (``lu.gbsv``). Up to n = 2 nb the unblocked pivoted
Parlett-Reid reduction runs; its T is tridiagonal. For complex
*symmetric* input the congruence takes the transpose instead of the
conjugate transpose, giving L T L^T.

Left out on purpose: the reference's ``_aasen_scan`` and
``AASEN_SCAN_THRESHOLD``, the fixed-shape form it takes above 64 block
steps to bound XLA's program size. The port runs the blocked loop at
any block count (as ``getrf`` runs its loops where the reference runs
``_lu_scan``); in exact arithmetic both forms compute the same factors.
S and L are updated in place where the reference updates slices
functionally (the same values).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.enums import Diag, MatrixType, Side, Uplo
from ..core.exceptions import slate_assert
from ..core.options import OptionsLike
from ..core.tiles import TiledMatrix, ceil_div
from .blas3 import trsm


class LTLFactors(NamedTuple):
    """P A P^T = L T L^H (L T L^T for complex symmetric): L unit-lower,
    T Hermitian / symmetric and banded, bandwidth < 2 nb from the
    blocked path (GeneralBand-tagged: hetrs takes the windowed band
    solver), tridiagonal from the small-n path. `pivots` is the row
    permutation P as an index vector (a[pivots] == P a)."""
    L: TiledMatrix
    T: TiledMatrix
    pivots: torch.Tensor     # (m_pad,) int32 permutation vector
    hermitian: bool = True


def _band_mask(s: torch.Tensor, width: int) -> torch.Tensor:
    """s with the entries |i - j| > width zeroed."""
    return torch.triu(torch.tril(s, width), -width)


def _swap2(x: torch.Tensor, idx: torch.Tensor, dim: int) -> None:
    """Exchange, in place, the two rows (dim 0) or columns (dim 1) of x
    named by the 2-element index tensor idx."""
    if dim == 0:
        x[idx] = x[idx.flip(0)]
    else:
        x[:, idx] = x[:, idx.flip(0)]


def _parlett_reid_pivoted(a: torch.Tensor, hermitian: bool):
    """Pivoted congruence reduction to tridiagonal: per column j the
    largest |a[i, j]| over i > j is swapped symmetrically to row and
    column j + 1, and one rank-1 congruence eliminates column j below
    it. Returns (T_full, L, perm) with (P a P^T) == L T L^H (L T L^T
    without `hermitian`). The pivot stays on the device: nothing is
    read back to the host."""
    n = a.shape[0]
    dev = a.device
    a = a.clone()
    lm = torch.zeros((n, n), dtype=a.dtype, device=dev)
    perm = torch.arange(n, device=dev)
    rows = torch.arange(n, device=dev)
    ninf = torch.tensor(-float("inf"), device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    for j in range(max(n - 2, 0)):
        tgt = j + 1
        mag = torch.where(rows > j, a[:, j].abs(), ninf)
        idx = torch.stack([rows[tgt], torch.argmax(mag)])
        _swap2(a, idx, 0)
        _swap2(a, idx, 1)
        _swap2(lm, idx, 0)
        perm[idx] = perm[idx.flip(0)]
        colj = a[:, j]
        alpha = colj[tgt]
        safe = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
        m = torch.where(rows > tgt, colj / safe, zero)
        a -= torch.outer(m, a[tgt].clone())
        a -= torch.outer(a[:, tgt].clone(), m.conj() if hermitian else m)
        lm[:, tgt] += m
    return a, lm + torch.eye(n, dtype=a.dtype, device=dev), perm


def _aasen_blocked(a: torch.Tensor, nb: int, hermitian: bool):
    """nb-blocked communication-avoiding Aasen (reference
    hetrf.cc:21-104; LAPACK sytrf_aa): P A P^T = L T L^H with
    unit-lower L and T banded, width < 2 nb. Per block step j (block
    column c0:c1, sub-rows from r0 = c1):
      1. partial-pivot LU of the panel S[r0:, c0:c1] (``lu._lu_panel``)
         nominates pivot rows;
      2. the pivots are applied as one symmetric permutation of the
         trailing rows and columns, of L's filled columns (< r0) and of
         the permutation record;
      3. W = L3 L2^{-1} eliminates S[r1:, c0:c1] (both blocks share the
         panel's U), and the congruence S <- M S M^H, M = I - e3 W e2^T,
         is two products: the column product reads the S the row
         product updated;
      4. W becomes L's block column j + 1.
    Returns (T, L, perm), T masked to its band."""
    from .blocked import invert_triangular
    from .lu import _compose_swaps, _lu_panel
    n = a.shape[0]
    dev = a.device
    nt = ceil_div(n, nb)
    lm = torch.eye(n, dtype=a.dtype, device=dev)
    perm = torch.arange(n, device=dev)
    S = a.clone()

    def conj_t(x):
        return x.mH if hermitian else x.mT

    for j in range(nt - 1):
        c0 = j * nb
        c1 = min(c0 + nb, n)
        r0 = c1
        if n - r0 <= c1 - c0:      # nothing below the subdiagonal block
            break
        packed, piv = _lu_panel(S[r0:, c0:c1])
        perm_l = _compose_swaps(piv, n - r0)
        S[r0:, :] = S[r0:, :][perm_l]
        S[:, r0:] = S[:, r0:][:, perm_l]
        lm[r0:, :r0] = lm[r0:, :r0][perm_l]
        perm[r0:] = perm[r0:][perm_l]
        # packed is in pivoted row order, as the permuted S
        w = c1 - c0
        r1 = min(r0 + w, n)
        L2 = torch.tril(packed[:w], -1) + torch.eye(w, dtype=a.dtype,
                                                    device=dev)
        W = packed[w:] @ invert_triangular(L2, lower=True,
                                           unit_diagonal=True)
        S[r1:, c0:] -= W @ S[r0:r1, c0:]
        S[c0:, r1:] -= S[c0:, r0:r1] @ conj_t(W)
        lm[r1:, r0:r1] = W
    # T: the reduced matrix on its block-tridiagonal band (the roundoff
    # outside is dropped)
    return _band_mask(S, max(2 * nb - 1, 1)), lm, perm


def hetrf(A: TiledMatrix, opts: OptionsLike = None,
          hermitian: bool = True, return_info: bool = False):
    """Aasen L T L^H factorization (reference src/hetrf.cc:21-104,
    slate.hh:854); see the module docstring. A Symmetric complex matrix
    takes the transpose congruence. With return_info=True returns
    (factors, info): info > 0 is the first zero pivot of the LU of T
    (the factor hetrs inverts), from a dedicated LU of T whose factors
    are discarded, as the reference does."""
    slate_assert(A.mtype in (MatrixType.Hermitian, MatrixType.Symmetric),
                 "hetrf: A must be Hermitian/symmetric")
    if A.mtype is MatrixType.Symmetric and A.is_complex:
        hermitian = False
    r = A.resolve()
    n = r.m
    nb = r.mb
    dev = r.device
    if n > 2 * nb:
        t, l, perm = _aasen_blocked(A.to_dense(), nb, hermitian)
        bw = max(2 * nb - 1, 1)
        T = TiledMatrix.from_dense(t, r.mb, r.nb,
                                   mtype=MatrixType.GeneralBand, kl=bw,
                                   ku=bw, device=dev)
    else:
        t, l, perm = _parlett_reid_pivoted(A.to_dense(), hermitian)
        # T keeps the General tag: it is tridiagonal (the mask drops
        # roundoff fill only) and hetrs solves it with a general LU
        T = TiledMatrix.from_dense(_band_mask(t, 1), r.mb, r.nb, device=dev)
    L = TiledMatrix.from_dense(l, r.mb, r.nb, mtype=MatrixType.Triangular,
                               uplo=Uplo.Lower, diag=Diag.Unit, device=dev)
    # extend perm over the padded rows
    mp = r.data.shape[0]
    perm_full = torch.cat([perm, torch.arange(n, mp, device=dev)]
                          ).to(torch.int32)
    F = LTLFactors(L, T, perm_full, hermitian)
    if return_info:
        from .lu import gbtrf, getrf
        fact = gbtrf(T, opts) if T.mtype is MatrixType.GeneralBand \
            else getrf(T, opts)
        return F, fact.info
    return F


def _permute_rows(B: TiledMatrix, perm: torch.Tensor,
                  inverse: bool = False) -> TiledMatrix:
    """B's rows gathered by perm (by its inverse with `inverse`), over
    B's padded storage."""
    r = B.resolve()
    p = torch.argsort(perm) if inverse else perm
    mp = r.data.shape[0]
    if p.shape[0] < mp:
        p = torch.cat([p, torch.arange(p.shape[0], mp, dtype=p.dtype,
                                       device=p.device)])
    elif p.shape[0] > mp:
        # A's padding exceeds B's: the extra entries are identity
        # (targets < n <= mp), so truncation is exact
        p = p[:mp]
    return dataclasses.replace(r, data=r.data[p.long()])


def hetrs(F: LTLFactors, B: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """Solve with hetrf factors (reference src/hetrs.cc, slate.hh:879):
    P b, then L z = ., T y = . (the windowed gbsv when T is band-tagged,
    gesv otherwise), L^H x = . (L^T for complex symmetric), P^T x."""
    from .lu import gbsv, gesv
    X = _permute_rows(B, F.pivots)
    X = trsm(Side.Left, 1.0, F.L, X, opts)
    if F.T.mtype is MatrixType.GeneralBand:
        _, X = gbsv(F.T, X, opts)
    else:
        _, X = gesv(F.T, X, opts)
    Lh = F.L.conj_transpose() if F.hermitian else F.L.transpose()
    X = trsm(Side.Left, 1.0, Lh, X, opts)
    return _permute_rows(X, F.pivots, inverse=True)


def hesv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None
         ) -> Tuple[LTLFactors, TiledMatrix]:
    """Reference slate.hh:827: hetrf, then hetrs."""
    F = hetrf(A, opts)
    return F, hetrs(F, B, opts)


def sytrf(A: TiledMatrix, opts: OptionsLike = None) -> LTLFactors:
    """Reference sytrf: complex symmetric input takes the transpose
    congruence (L T L^T)."""
    return hetrf(A, opts)


def sytrs(F: LTLFactors, B: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """Reference sytrs: hetrs with the factors' congruence."""
    return hetrs(F, B, opts)


def sysv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Reference slate.hh:839."""
    return hesv(A, B, opts)

"""LU family (counterpart of ``slate_tpu/linalg/lu.py``), the dense
partial-pivot slice: getrf / getrs / gesv on one device.

Pivots are a flat int32 tensor of global row swap targets (LAPACK
ipiv convention, 0-based), as in the reference. ``getrf`` with Auto
takes the Tiled blocked form; on one device that is the
carry-the-trailing-matrix loop (``_getrf_carry``), whose panels go
through ``_lu_panel``'s route arbitration: ``torch.linalg.lu_factor``
cold, the hand-written recursive panel kernel when the tune cache
routes ``pallas_rec``.

Not ported yet (each raises ``NotImplementedError`` naming its
ROADMAP item rather than taking another route): the scan form for
more than LU_SCAN_THRESHOLD block steps, the pipelined (lookahead)
form, tournament pivoting (CALU), no-pivot LU, the grid (mesh) paths,
band factors and the mixed-precision / RBT drivers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.enums import Diag, MatrixType, Op, Side, Uplo
from ..core.exceptions import slate_assert
from ..core.methods import MethodFactor, MethodLU, MethodLUPanel
from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix, ceil_div, pad_diag_identity
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from .blas3 import trsm
from .blocked import assemble_packed
from .info import lu_info


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        "%s is not ported to slate_tpu_torch yet (ROADMAP.md, queue 1)"
        % what)


class LUFactors(NamedTuple):
    """Packed L\\U factor (unit-lower L below the diagonal, U on and
    above) plus pivots and the LAPACK getrf info code."""
    LU: TiledMatrix
    pivots: torch.Tensor       # (min(m,n)_pad,) int32 global swap targets
    info: Optional[torch.Tensor] = None   # () int32


# -- pivot machinery ------------------------------------------------------

def _compose_swaps(piv: torch.Tensor, m: int) -> torch.Tensor:
    """Turn a sequence of row swaps (j <-> piv[j]) into one permutation
    of range(m) (LAPACK laswp semantics; the port of XLA's
    lu_pivots_to_permutation)."""
    return pk.lu_pivots_to_permutation(piv, m)


def _permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Row gather. (The reference's bf16 detour works around a TPU
    compiler limit and has no counterpart here.)"""
    return x[perm]


def apply_pivots(pivots: torch.Tensor, B: TiledMatrix,
                 forward: bool = True) -> TiledMatrix:
    """Apply row swaps to B (reference internal::permuteRows): row j
    is swapped with row pivots[j], in order (reversed if not
    forward)."""
    r = B.resolve()
    mp = r.data.shape[0]
    if pivots.shape[0] > mp:
        # entries past B's rows are identity swaps: truncation is exact
        pivots = pivots[:mp]
    perm = _compose_swaps(pivots, mp)
    if not forward:
        perm = torch.argsort(perm)
    return dataclasses.replace(r, data=_permute_rows(r.data, perm))


# -- panel ----------------------------------------------------------------

def _lu_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of a (m, w) panel: (packed LU, local pivot
    swap targets (w,) int32).

    Route arbitration (MethodLUPanel): a MEASURED tune-cache entry
    wins, validated against the hard gates; a cold cache resolves to
    the native library LU (torch.linalg.lu_factor) where the dtype
    allows, else the fori loop. The pallas_rec route runs the
    hand-written recursive panel kernel (ops/kernels.lu_panel_rec)."""
    m, w = a.shape
    method = MethodLUPanel.resolve(m, w, a.dtype)
    if method is MethodLUPanel.PallasRec:
        fused = pk.lu_panel_rec(a)
        if fused is not None:
            return fused
        method = MethodLUPanel.cold_default(m, w, a.dtype)
    if method is MethodLUPanel.Pallas:
        raise _not_ported("the rank-1 LU panel kernel (lu_panel)")
    if method is MethodLUPanel.Native:
        lu, piv = _native_lu(a)
        return lu, piv
    return lu_panel_fori(a)


def _native_lu(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.lu_factor_ex (no singularity check: info reports
    it) with its 1-based pivots turned into the 0-based swap targets
    the reference's native LU returns."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return lu, (piv - 1).to(torch.int32)


def lu_panel_fori(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-loop panel: per column, argmax pivot search (lowest
    row wins ties), two-row swap, rank-1 update of the columns to the
    right — the pivot-sequence oracle of the recursive kernel."""
    m, w = a.shape
    a = a.clone()
    piv = torch.zeros(w, dtype=torch.int32)
    for j in range(min(m, w)):
        p = j + int(torch.argmax(a[j:, j].abs()))
        piv[j] = p
        if p != j:
            a[[j, p]] = a[[p, j]]
        pivval = a[j, j]
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        mults = a[j + 1:, j] / safe
        a[j + 1:, j] = mults
        a[j + 1:, j + 1:] -= torch.outer(mults, a[j, j + 1:])
    return a, piv.to(a.device)


# -- factorizations -------------------------------------------------------

def _getrf_carry(a: torch.Tensor, nb: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device blocked LU that carries the SHRINKING trailing
    matrix instead of updating the full matrix in place. Each step's
    panel is emitted in that step's row order; the suffix permutations
    of later steps are composed into one final gather per panel (the
    deferred laswp of the reference's getrf.cc)."""
    M, N = a.shape
    kmax = min(M, N)
    nt = ceil_div(kmax, nb)
    trail = a
    panels, urows, perms, pivs = [], [], [], []
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0
        lu, piv = _lu_panel(trail[:, :w])
        perm = _compose_swaps(piv, trail.shape[0])
        pivs.append(k0 + piv)
        perms.append(perm)
        panels.append(lu)
        if k1 < N:
            rest = _permute_rows(trail[:, w:], perm)
            u12 = torch.linalg.solve_triangular(
                lu[:w, :w], rest[:w], upper=False, left=True,
                unitriangular=True)
            urows.append(u12)
            trail = rest[w:] - lu[w:, :w] @ u12 if k1 < M else rest[w:]
    # final row order per panel: panel k's rows get permuted by the
    # suffix action of perms[k+1:]
    reordered = []
    for k in range(nt):
        q = torch.arange(panels[k].shape[0], device=a.device)
        for j in range(k + 1, nt):
            off = (j - k) * nb
            q = torch.cat([q[:off], q[off:][perms[j]]])
        reordered.append(_permute_rows(panels[k], q))
    out = assemble_packed(reordered, urows, nb, kmax, M, N, a.dtype)
    return out, torch.cat(pivs)


def _getrf_dense(a: torch.Tensor, nb: int, lookahead: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU on padded (M, N) dense; returns packed
    LU and global pivot swaps (length min(M, N)). The branches of the
    reference this slice reaches: the single-device carry form, and
    the unrolled loop (nt == 1). The reference's bf16 width cap to its
    rank-1 Pallas panel is off here: that kernel is not ported. (getrf
    turns the tournament, no-pivot and grid branches away first.)"""
    M, N = a.shape
    kmax = min(M, N)
    nt = ceil_div(kmax, nb)
    if M == N and nt > LU_SCAN_THRESHOLD:
        raise _not_ported("the scan form of getrf (more than %d block "
                          "steps)" % LU_SCAN_THRESHOLD)
    if nt > 1 and MethodFactor.native_lu_dtype_ok(a.dtype):
        # single-device fast path: carry-the-trailing-matrix form (the
        # reference caps nb at 256 above its TPU native-LU height
        # limit; native_lu_ok has no height limit here)
        return _getrf_carry(a, nb)
    if lookahead >= 1 and nt > 1:
        raise _not_ported("the pipelined (lookahead) getrf form")
    ipiv = torch.arange(kmax, dtype=torch.int32, device=a.device)
    a = a.clone()
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        panel, piv = _lu_panel(a[k0:, k0:k1])
        a[k0:, k0:k1] = panel
        perm = _compose_swaps(piv, M - k0)
        if k0 > 0:
            a[k0:, :k0] = _permute_rows(a[k0:, :k0], perm)
        if k1 < N:
            a[k0:, k1:] = _permute_rows(a[k0:, k1:], perm)
        ipiv[k0:k1] = k0 + piv
        if k1 < N:
            u12 = torch.linalg.solve_triangular(
                a[k0:k1, k0:k1], a[k0:k1, k1:], upper=False, left=True,
                unitriangular=True)
            a[k0:k1, k1:] = u12
            if k1 < M:
                a[k1:, k1:] -= a[k1:, k0:k1] @ u12
    return a, ipiv


#: block-step count above which the reference switches to its
#: fixed-shape scan form (not ported)
LU_SCAN_THRESHOLD = 64


def _prep(A: TiledMatrix) -> Tuple[TiledMatrix, torch.Tensor]:
    r = A.resolve()
    if r.mtype is MatrixType.General:
        a = r.data
    else:
        d = A.to_dense()
        a = torch.nn.functional.pad(d, (0, r.data.shape[1] - r.n,
                                        0, r.data.shape[0] - r.m))
    return r, pad_diag_identity(a, r.m, r.n)


def _lu_nb(opts: OptionsLike, shape, dtype=None) -> int:
    """Algorithmic LU blocking: an explicit Option.BlockSize wins,
    then a measured tune-cache entry, then the reference's frozen
    n-scaled formula (a v5e measurement, kept so cold routing agrees
    with the reference)."""
    n = min(shape)
    from ..tune.select import tuned_int
    nb_frozen = min(1024, max(512, n // 8))
    return tuned_int("getrf", "nb", nb_frozen, opts=opts,
                     option=Option.BlockSize, n=n,
                     dtype=dtype) or nb_frozen


@instrument_driver("getrf")
def getrf(A: TiledMatrix, opts: OptionsLike = None) -> LUFactors:
    """Partial-pivoting LU: P A = L U (reference src/getrf.cc:327)."""
    method = get_option(opts, Option.MethodLU, MethodLU.PartialPiv)
    if method is MethodLU.NoPiv:
        raise _not_ported("getrf_nopiv")
    if method is MethodLU.CALU:
        raise _not_ported("getrf_tntpiv (CALU)")
    r, a = _prep(A)
    if get_option(opts, Option.Grid, None) is not None:
        raise _not_ported("getrf on a grid (mesh) of devices")
    fmethod = get_option(opts, Option.MethodFactor, MethodFactor.Auto)
    if fmethod is MethodFactor.Auto:
        from ..tune.select import tuned_method
        cached = tuned_method("getrf", "factor", opts=opts,
                              option=Option.MethodFactor,
                              n=min(a.shape), dtype=a.dtype)
        fmethod = cached if cached is not None \
            and cached is not MethodFactor.Auto else MethodFactor.Tiled
    if fmethod is MethodFactor.Fused \
            and not MethodFactor.native_lu_dtype_ok(a.dtype):
        import warnings
        warnings.warn(f"getrf: the library LU does not implement "
                      f"{a.dtype}; falling back to the Tiled blocked path",
                      stacklevel=2)
        fmethod = MethodFactor.Tiled
    if fmethod is MethodFactor.Fused:
        lu, ipiv = _native_lu(a)
    else:
        lu, ipiv = _getrf_dense(a, _lu_nb(opts, a.shape, dtype=a.dtype),
                                get_option(opts, Option.Lookahead))
    return LUFactors(dataclasses.replace(r, data=lu,
                                         mtype=MatrixType.General),
                     ipiv, lu_info(lu, r.m, r.n))


# -- solves ---------------------------------------------------------------

def getrs(F: LUFactors, B: TiledMatrix, opts: OptionsLike = None,
          trans=Op.NoTrans) -> TiledMatrix:
    """Solve using getrf factors (reference src/getrs.cc:88-111:
    permuteRows, trsm(L), trsm(U)). trans accepts an Op or a bool
    (True == ConjTrans)."""
    if not isinstance(trans, Op):
        slate_assert(trans in (True, False),
                     f"trans must be an Op or bool, got {trans!r}")
        trans = Op.ConjTrans if trans else Op.NoTrans
    LU = F.LU
    L = dataclasses.replace(LU, mtype=MatrixType.Triangular,
                            uplo=Uplo.Lower, diag=Diag.Unit)
    U = dataclasses.replace(LU, mtype=MatrixType.Triangular,
                            uplo=Uplo.Upper, diag=Diag.NonUnit)
    if trans is Op.NoTrans:
        X = apply_pivots(F.pivots, B)
        X = trsm(Side.Left, 1.0, L, X, opts)
        X = trsm(Side.Left, 1.0, U, X, opts)
    else:
        flip = (lambda M: M.conj_transpose()) if trans is Op.ConjTrans \
            else (lambda M: M.transpose())
        X = trsm(Side.Left, 1.0, flip(U), B, opts)
        X = trsm(Side.Left, 1.0, flip(L), X, opts)
        X = apply_pivots(F.pivots, X, forward=False)
    return X


@instrument_driver("gesv")
def gesv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None
         ) -> Tuple[LUFactors, TiledMatrix]:
    """Reference src/gesv.cc (slate.hh:507)."""
    from ..utils.trace import phases
    ph = phases(opts)
    with ph("gesv::getrf"):
        F = getrf(A, opts)
    with ph("gesv::getrs"):
        X = getrs(F, B, opts)
    return F, X

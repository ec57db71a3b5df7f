"""Blocked factorization / solve core (counterpart of
``slate_tpu/linalg/blocked.py``): ``invert_triangular``,
``trsm_left``/``trsm_dense``, ``assemble_packed`` and the blocked
Cholesky (``chol_diag_factor``, ``chol_loop``, ``chol_loop_pipelined``,
``cholesky_blocked``).

The direct triangular solve is :func:`solve_triangular` over
``torch.linalg.solve_triangular`` (LAPACK on the CPU, cuBLAS on the
card), the counterpart of the reference's XLA TriangularSolve; the
diagonal-block Cholesky is :func:`chol_diag_factor` over
``torch.linalg.cholesky_ex``, the counterpart of XLA's ``cholesky``;
the Hermitian eigensolver is :func:`library_eigh` over
``torch.linalg.eigh``, the counterpart of XLA's ``eigh``.
Where the reference updates slices functionally, the loops here update
a copy of the input in place (same values).

Under a grid (``grid=``, a ``parallel.ProcessGrid``) the reference keeps
its invert-then-matmul numerics: the triangular solve loop of
``trsm_left`` and the Cholesky panel ``B L^{-H}`` as a product with the
diagonal block's inverse (``_chol_panel_solve``'s grid branch). The
port runs them as owner-computes loops (``parallel/owner.py``): per
block step the current panel is gathered, the owner of the diagonal
tile factors / inverts and broadcasts, and each rank updates only the
tiles the 2D block-cyclic map gives it (``chol_loop_grid``,
``_trsm_left_grid``). Every finished row block of X and column of L
reaches every rank by that broadcast, so the result is the same on
every rank, bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..core.tiles import ceil_div, round_up
from ..parallel import owner as _own

#: block order up to which one direct solve against the identity is
#: the inversion leaf; larger blocks recurse on halves
TRTRI_LEAF_MAX = 512


#: the largest order at which torch.linalg.eigh / eigvalsh hand an f32
#: matrix on the card to cuSOLVER's Jacobi solver (syevj) at its default
#: tolerance instead of syevd
SYEVJ_MAX_N = 512


def _syevj_route(device_type: str, dtype: torch.dtype, n: int) -> bool:
    """Whether the library eigensolver would take syevj: f32 on the
    card at order <= SYEVJ_MAX_N (batched or not)."""
    return device_type == "cuda" and dtype == torch.float32 \
        and n <= SYEVJ_MAX_N


def library_eigh(a: torch.Tensor, eigenvectors: bool = True):
    """``torch.linalg.eigh`` (or ``eigvalsh`` without eigenvectors), the
    counterpart of XLA's eigh, accurate to f32 on the card too. For an
    f32 matrix of order <= SYEVJ_MAX_N on the card, PyTorch runs
    cuSOLVER's syevj, whose residual and orthogonality reach only
    ~1e-4 at order 256 on an H100 (LAPACK: ~1e-6); there the solve runs
    in f64 (syevd) and rounds to f32. Elsewhere it is one plain call."""
    if _syevj_route(a.device.type, a.dtype, a.shape[-1]):
        if not eigenvectors:
            return torch.linalg.eigvalsh(a.double()).float()
        w, v = torch.linalg.eigh(a.double())
        return w.float(), v.float()
    return torch.linalg.eigh(a) if eigenvectors \
        else torch.linalg.eigvalsh(a)


#: dtypes the library triangular solve implements
_SOLVE_DTYPES = (torch.float32, torch.float64, torch.complex64,
                 torch.complex128)


def solve_triangular(a: torch.Tensor, b: torch.Tensor, *, upper: bool,
                     unitriangular: bool = False,
                     left: bool = True) -> torch.Tensor:
    """X with A X = B (or X A = B with left=False), A triangular: one
    library solve. For a dtype the library lacks (bf16: neither LAPACK
    nor cuBLAS trsm has it), the solve runs in f32 on the upcast
    operands and the result is rounded to the input type. This is where
    the port's rounding departs from the reference, whose XLA expander
    solves bf16 blockwise with bf16 intermediates; the mixed-precision
    drivers' refinement absorbs the difference."""
    if b.dtype in _SOLVE_DTYPES:
        return torch.linalg.solve_triangular(a, b, upper=upper, left=left,
                                             unitriangular=unitriangular)
    return torch.linalg.solve_triangular(
        a.float(), b.float(), upper=upper, left=left,
        unitriangular=unitriangular).to(b.dtype)


def _solve_lower_left(a: torch.Tensor, b: torch.Tensor,
                      unit_diagonal: bool) -> torch.Tensor:
    return solve_triangular(a, b, upper=False, unitriangular=unit_diagonal)


def invert_triangular(a: torch.Tensor, lower: bool,
                      unit_diagonal: bool = False) -> torch.Tensor:
    """Inverse of a triangular block (or of each block of a
    (..., n, n) stack): one direct solve against the identity up to
    TRTRI_LEAF_MAX, block substitution on halves above it. Upper inputs
    reduce to lower via transposition."""
    n = a.shape[-1]
    if not lower:
        return invert_triangular(a.mT, True, unit_diagonal).mT
    if n <= TRTRI_LEAF_MAX:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        return _solve_lower_left(a, eye.expand_as(a), unit_diagonal)
    # inv([[A, 0], [C, B]]) = [[iA, 0], [-iB C iA, iB]]
    h = round_up(ceil_div(n, 2), 128)
    ia = invert_triangular(a[..., :h, :h], True, unit_diagonal)
    ib = invert_triangular(a[..., h:, h:], True, unit_diagonal)
    out = torch.zeros_like(a)
    out[..., :h, :h] = ia
    out[..., h:, h:] = ib
    out[..., h:, :h] = -((ib @ a[..., h:, :h]) @ ia)
    return out


#: cap (bytes) on the estimated temporaries of one direct solve, the
#: reference's huge-RHS valve: above it trsm_left slabs the RHS into
#: independent column blocks. Kept with the reference's value; the
#: port's library solve has no such temporaries, so on the card the
#: slabbing only bounds the size of each call.
SOLVE_TEMP_CAP = 2 << 30


def solve_temps_bytes(other: int, tri: int, itemsize: int) -> int:
    """The reference's temp estimate for one triangular solve with a
    (tri, tri) triangle and an output of other * tri elements."""
    return (tri // 128) * other * tri * itemsize // 2


def trsm_left(a: torch.Tensor, b: torch.Tensor, lower: bool, nb: int,
              unit_diagonal: bool = False, grid=None,
              tiles: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Solve A X = B with A (n, n) triangular, B (n, k): one direct
    solve, the RHS slabbed by columns above SOLVE_TEMP_CAP (each slab
    is still a direct, backward-stable solve). Under a grid: the
    reference's blocked loop (:func:`_trsm_left_grid`; `tiles` is X's
    (mb, nb) tiling, the unit of ownership)."""
    if grid is not None:
        return _trsm_left_grid(a, b, lower, nb, unit_diagonal, grid,
                               tiles or (nb, nb))

    def direct(rhs):
        return solve_triangular(a, rhs, upper=not lower,
                                unitriangular=unit_diagonal)

    per_col = solve_temps_bytes(1, a.shape[0], b.element_size())
    if per_col * b.shape[1] > SOLVE_TEMP_CAP:
        k_slab = max(int(SOLVE_TEMP_CAP // per_col), 1)
        return torch.cat([direct(b[:, j:j + k_slab])
                          for j in range(0, b.shape[1], k_slab)], dim=1)
    return direct(b)


def _trsm_left_grid(a: torch.Tensor, b: torch.Tensor, lower: bool,
                    nb: int, unit_diagonal: bool, grid,
                    tiles: Tuple[int, int]) -> torch.Tensor:
    """The reference's grid trsm (blocked.py:106-153, work::trsm row
    pipeline, work_trsm.cc:70-110) owner-computes: per block step, the
    current row block of X is gathered, the owner of A's diagonal tile
    applies that tile's inverse and broadcasts the finished rows, and
    each rank updates its own tiles of the rows still to solve. One
    block step takes the reference's direct solve, on the owner."""
    n = a.shape[0]
    nt = ceil_div(n, nb)
    own = _own.Owner(grid, tuple(b.shape), tiles[0], tiles[1], b.device)
    if nt <= 1:
        return _own.publish(own, 0, lambda: (solve_triangular(
            a, b, upper=not lower, unitriangular=unit_diagonal),),
            [(b.shape, b.dtype)])[0]
    x = b.clone()
    for k in (range(nt) if lower else reversed(range(nt))):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        (xk,) = _own.step(
            own, x, slice(k0, k1), slice(None),
            lambda col: (invert_triangular(a[k0:k1, k0:k1], lower,
                                           unit_diagonal) @ col,),
            [((k1 - k0, x.shape[1]), x.dtype)],
            src=((k % grid.p) * grid.q) + k % grid.q)
        x[k0:k1] = xk
        if lower and k1 < n:
            _own.update(own, x, k1, n, 0, x.shape[1], a[k1:, k0:k1], xk)
        elif not lower and k0 > 0:
            _own.update(own, x, 0, k0, 0, x.shape[1], a[:k0, k0:k1], xk)
    return x


def trsm_dense(a: torch.Tensor, b: torch.Tensor, *, left: bool,
               lower: bool, nb: int, unit_diagonal: bool = False,
               grid=None, tiles: Optional[Tuple[int, int]] = None
               ) -> torch.Tensor:
    """General entry: reduces the Right case to Left via conjugate
    transposition (X A = B  <=>  A^H X^H = B^H); `tiles` is B's (mb, nb)
    tiling (ownership under a grid)."""
    if left:
        return trsm_left(a, b, lower, nb, unit_diagonal, grid, tiles)
    xh = trsm_left(a.T.conj(), b.T.conj(), not lower, nb, unit_diagonal,
                   grid, tiles[::-1] if tiles else None)
    return xh.T.conj()


def assemble_packed(panels: List[torch.Tensor],
                    strips: List[torch.Tensor], nb: int, kmax: int,
                    M: int, N: int, dtype) -> torch.Tensor:
    """Final assembly for the carry-style factorization: each step's
    (m_k, w_k) panel below k*nb zero rows, zero columns past kmax for
    M < N, and each step's top strip (U12) right of its diagonal
    block; leading batch dimensions ride along. Writes into one
    preallocated tensor instead of the reference's functional
    concatenation (same values)."""
    lead = panels[0].shape[:-2]
    out = torch.zeros((*lead, M, N), dtype=dtype, device=panels[0].device)
    c0 = 0
    for k, p in enumerate(panels):
        out[..., k * nb:, c0:c0 + p.shape[-1]] = p
        c0 += p.shape[-1]
    for k, strip in enumerate(strips):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        out[..., k0:k0 + strip.shape[-2], k1:k1 + strip.shape[-1]] = strip
    return out


# -- blocked Cholesky -------------------------------------------------------

def chol_diag_factor(s: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of one SPD block by the library
    (``torch.linalg.cholesky_ex``: LAPACK potrf on the CPU, cuSOLVER on
    the card), zeros above the diagonal. Only the lower triangle is
    read: callers hand blocks whose upper triangle may be stale (the
    reference's symmetrize_input=False). No singularity check (a
    non-PD block gives a partial factor; info comes from the guarded
    path, ``info.cholesky_blocked_info``), so nothing is read back to
    the host.

    For a dtype the library lacks (bf16: neither LAPACK nor cuSOLVER
    has a bf16 potrf) the f32 upcast is factored and the factor rounded
    to the input type: one rounding where the reference's XLA expander
    rounds its bf16 intermediates (ROADMAP queue 3), the same kind of
    departure as :func:`solve_triangular`."""
    return _chol_diag_factor_ex(s)[0]


def _chol_diag_factor_ex(s: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`chol_diag_factor` and the library's info (0, or the
    1-based failed pivot), per element of a stack, on the device."""
    if s.dtype in _SOLVE_DTYPES:
        return torch.linalg.cholesky_ex(s)
    lkk, bad = torch.linalg.cholesky_ex(s.float())
    return lkk.to(s.dtype), bad


def _chol_panel_solve(lkk: torch.Tensor, bpanel: torch.Tensor
                      ) -> torch.Tensor:
    """pan = B L^{-H}, the Cholesky panel step: one direct right-side
    library solve (the reference's single-device branch; its grid
    branch, invert-then-matmul, is in chol_loop_grid)."""
    return solve_triangular(lkk.mH, bpanel, upper=True, left=False)


DiagFactor = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def chol_loop(a: torch.Tensor, nb: int, diag_factor: DiagFactor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-looking blocked Cholesky (reference impl::potrf,
    potrf.cc:85-192): per step, factor the diagonal block with
    `diag_factor(s) -> (lkk, local_info)`, solve the panel, apply one
    dense trailing update (the full square, as the reference). Returns
    (L, info), info the first failed global pivot (1-based, 0 if none)
    accumulated like potrf.cc:104-105 ``info = kk + iinfo``; info stays
    on the device."""
    n = a.shape[0]
    nt = ceil_div(n, nb)
    a = a.clone()
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        lkk, bad = diag_factor(a[k0:k1, k0:k1])
        info = torch.where((info == 0) & (bad > 0), k0 + bad, info)
        a[k0:k1, k0:k1] = lkk
        if k1 < n:
            pan = _chol_panel_solve(lkk, a[k1:, k0:k1])
            a[k1:, k0:k1] = pan
            a[k1:, k1:] -= pan @ pan.mH
    return a, info


def chol_loop_pipelined(a: torch.Tensor, nb: int, diag_factor: DiagFactor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lookahead-1 form of chol_loop (reference potrf.cc:136-176): the
    step-k trailing update is split into the next panel's column
    (narrow, on the critical path) and the rest (wide). The next panel
    factors right after the narrow update, so the wide product does not
    wait for it. Same arithmetic as chol_loop, so the lower triangles
    agree to rounding; the strictly-upper strip right of each diagonal
    block keeps stale values (the triangular result's to_dense masks
    them)."""
    n = a.shape[-1]
    nt = ceil_div(n, nb)
    a = a.clone()
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    k1 = min(nb, n)
    lkk, bad = diag_factor(a[..., :k1, :k1])
    info = torch.where(bad > 0, bad, info)
    a[..., :k1, :k1] = lkk
    pan = None
    if k1 < n:
        pan = _chol_panel_solve(lkk, a[..., k1:, :k1])
        a[..., k1:, :k1] = pan
    for k in range(nt - 1):
        k1 = min((k + 1) * nb, n)
        k2 = min(k1 + nb, n)
        w = k2 - k1
        # narrow update: the next panel's column only (critical path)
        colblk = a[..., k1:, k1:k2] - pan @ pan[..., :w, :].mH
        lkk, bad = diag_factor(colblk[..., :w, :])
        info = torch.where((info == 0) & (bad > 0), k1 + bad, info)
        a[..., k1:k2, k1:k2] = lkk
        next_pan = None
        if k2 < n:
            next_pan = _chol_panel_solve(lkk, colblk[..., w:, :])
            a[..., k2:, k1:k2] = next_pan
            # wide trailing update with step k's panel
            a[..., k2:, k2:] -= pan[..., w:, :] @ pan[..., w:, :].mH
        pan = next_pan
    return a, info


def chol_loop_grid(a: torch.Tensor, nb: int, diag_factor: DiagFactor,
                   grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's grid Cholesky (chol_loop under a grid, its
    lookahead form computing the same products) owner-computes: per
    step the current column block is gathered, the owner of the
    diagonal tile factors it and forms the panel B L^{-H} by
    invert-then-matmul (the reference's grid branch of
    _chol_panel_solve) and broadcasts both with its failure index, and
    each rank applies the dense trailing update to its own tiles.
    Returns (L with its strict upper triangle zero, info)."""
    n = a.shape[-1]
    nt = ceil_div(n, nb)
    a = a.clone()
    own = _own.Owner(grid, tuple(a.shape), nb, nb, a.device)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        w = k1 - k0

        def factor(col):
            lkk, bad = diag_factor(col[:w])
            return (torch.cat([lkk, col[w:] @ invert_triangular(
                lkk, True).mH]), bad.reshape(1).to(torch.int32))

        blk, bad = _own.step(own, a, slice(k0, n), slice(k0, k1), factor,
                             [((n - k0, w), a.dtype),
                              ((1,), torch.int32)])
        info = torch.where((info == 0) & (bad[0] > 0), k0 + bad[0], info)
        a[k0:, k0:k1] = blk
        if k1 < n:
            pan = blk[w:]
            _own.update(own, a, k1, n, k1, n, pan, pan.mH)
    return torch.tril(a), info


def _nan_diag_factor(s: torch.Tensor):
    """chol_diag_factor with a failed block NaN (cholesky_blocked)."""
    lkk, bad = _chol_diag_factor_ex(s)
    lkk = torch.where((bad > 0)[..., None, None],
                      torch.full_like(lkk, float("nan")), lkk)
    return lkk, torch.zeros((), dtype=torch.int32, device=s.device)


def cholesky_blocked(a: torch.Tensor, nb: int,
                     lookahead: int = 1, grid=None) -> torch.Tensor:
    """Lower Cholesky of a padded (N, N) matrix whose padded diagonal
    is identity (or of each of a (..., N, N) stack on the pipelined
    loop): the pipelined loop (lookahead >= 1, Option.Lookahead)
    or the plain right-looking one (0), at any number of block steps,
    or under a grid :func:`chol_loop_grid`.
    Diagonal blocks by the library (chol_diag_factor), panels by one
    direct solve, trailing updates dense. The reference's fixed-shape
    step past CHOL_SCAN_THRESHOLD steps (``cholesky_scan``) bounds XLA's
    compile time, which eager PyTorch does not have, at the cost of a
    full-size trailing update every step: it is not ported.

    A diagonal block that is not positive definite comes back NaN, as
    XLA's Cholesky leaves it in the reference, so the failure spreads
    to the rest of that element's factor and to any solve with it (the
    batch cores' elements carry no info; their callers test
    finiteness). The library alone would leave a partial factor that
    looks valid."""
    if grid is not None:
        return chol_loop_grid(a, nb, _nan_diag_factor, grid)[0]
    loop = chol_loop_pipelined if lookahead >= 1 else chol_loop
    return loop(a, nb, _nan_diag_factor)[0]

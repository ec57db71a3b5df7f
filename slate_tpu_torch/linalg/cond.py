"""Condition-number estimators (counterpart of
``slate_tpu/linalg/cond.py``; reference src/gecondest.cc, pocondest.cc,
trcondest.cc and internal norm1est, slate.hh:1368-1398).

Hager / Higham 1-norm estimation driven by solves with the factored
matrix. The reference's ``lax.while_loop`` becomes a plain loop with
the same iteration count and stopping rule (stop when the probing
unit-vector index repeats or the estimate fails to increase, at most
``itmax`` iterations), so both packages return the same estimate on
the same factors; the loop reads two scalars back to the host an
iteration. Norm.Inf estimates use ||A^-1||_inf = ||A^-H||_1: the same
estimator with the solve and its adjoint exchanged.
"""

from __future__ import annotations

import torch

from ..core.enums import Norm, Side
from ..core.exceptions import slate_assert
from ..core.options import OptionsLike
from ..core.tiles import TiledMatrix
from .blas3 import trsm
from .chol import potrs
from .lu import LUFactors, getrs
from .norms import norm as matrix_norm


def _norm1est(solve, solve_h, n: int, dtype, device, itmax: int = 5
              ) -> torch.Tensor:
    """Higham's estimate of ||A^-1||_1 from x -> A^-1 x and
    x -> A^-H x (reference internal norm1est / LAPACK dlacn2): a 0-d
    tensor on `device`."""
    x = torch.full((n, 1), 1.0 / n, dtype=dtype, device=device)
    y = solve(x)
    est = y.abs().sum()
    jprev = -1
    for _ in range(itmax):
        xi = torch.where(y.real >= 0, 1.0, -1.0).to(dtype)
        z = solve_h(xi)
        j = int(torch.argmax(z.real.abs()))
        xnew = torch.zeros((n, 1), dtype=dtype, device=device)
        xnew[j, 0] = 1.0
        ynew = solve(xnew)
        estnew = ynew.abs().sum()
        converged = j == jprev or bool(estnew <= est)
        est = torch.maximum(est, estnew)
        y, jprev = ynew, j
        if converged:
            break
    return est


def _estimate(norm_type: Norm, solve, solve_h, n: int, dtype, device,
              anorm) -> torch.Tensor:
    slate_assert(norm_type in (Norm.One, Norm.Inf),
                 "condest supports Norm.One / Norm.Inf")
    if norm_type is Norm.One:
        ainvnorm = _norm1est(solve, solve_h, n, dtype, device)
    else:   # ||A^-1||_inf = ||A^-H||_1
        ainvnorm = _norm1est(solve_h, solve, n, dtype, device)
    rcond = 1.0 / (ainvnorm * torch.as_tensor(anorm, device=device))
    return torch.where(torch.isfinite(rcond), rcond,
                       torch.zeros_like(rcond))


def _tm(x: torch.Tensor, nb: int) -> TiledMatrix:
    return TiledMatrix.from_dense(x, nb, device=x.device)


def gecondest(norm_type: Norm, F: LUFactors, anorm,
              opts: OptionsLike = None) -> torch.Tensor:
    """Reciprocal condition estimate from LU factors (reference
    src/gecondest.cc, slate.hh:1368); `anorm` is ||A|| in `norm_type`."""
    LU = F.LU
    nb = LU.nb

    def solve(x):
        return getrs(F, _tm(x, nb), opts).to_dense()

    def solve_h(x):
        return getrs(F, _tm(x, nb), opts, trans=True).to_dense()

    return _estimate(norm_type, solve, solve_h, LU.m, LU.dtype, LU.device,
                     anorm)


def pocondest(norm_type: Norm, L: TiledMatrix, anorm,
              opts: OptionsLike = None) -> torch.Tensor:
    """From the Cholesky factor (reference src/pocondest.cc). A is
    Hermitian, so the solve is self-adjoint."""
    nb = L.nb

    def solve(x):
        return potrs(L, _tm(x, nb), opts).to_dense()

    return _estimate(norm_type, solve, solve, L.m, L.dtype, L.device, anorm)


def trcondest(norm_type: Norm, A: TiledMatrix,
              opts: OptionsLike = None) -> torch.Tensor:
    """Triangular condition estimate (reference src/trcondest.cc,
    slate.hh:1398)."""
    nb = A.nb
    anorm = matrix_norm(norm_type if norm_type in (Norm.One, Norm.Inf)
                        else Norm.One, A)

    def solve(x):
        return trsm(Side.Left, 1.0, A, _tm(x, nb), opts).to_dense()

    def solve_h(x):
        return trsm(Side.Left, 1.0, A.conj_transpose(), _tm(x, nb),
                    opts).to_dense()

    return _estimate(norm_type, solve, solve_h, A.m, A.dtype, A.device,
                     anorm)

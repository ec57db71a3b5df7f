"""Blocked solve core (counterpart of ``slate_tpu/linalg/blocked.py``),
reduced to what the LU slice uses: ``invert_triangular``,
``trsm_left``/``trsm_dense`` and ``assemble_packed``.

The direct triangular solve is :func:`solve_triangular` over
``torch.linalg.solve_triangular`` (LAPACK on the CPU, cuBLAS on the
card), the counterpart of the reference's XLA TriangularSolve. The
reference's grid (SPMD) paths wait for the distributed slice.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.tiles import ceil_div, round_up

#: block order up to which one direct solve against the identity is
#: the inversion leaf; larger blocks recurse on halves
TRTRI_LEAF_MAX = 512


#: dtypes the library triangular solve implements
_SOLVE_DTYPES = (torch.float32, torch.float64, torch.complex64,
                 torch.complex128)


def solve_triangular(a: torch.Tensor, b: torch.Tensor, *, upper: bool,
                     unitriangular: bool = False) -> torch.Tensor:
    """X with A X = B, A triangular: one library solve. For a dtype the
    library lacks (bf16: neither LAPACK nor cuBLAS trsm has it), the
    solve runs in f32 on the upcast operands and the result is rounded
    to the input type. This is where the port's rounding departs from
    the reference, whose XLA expander solves bf16 blockwise with bf16
    intermediates; the mixed-precision drivers' refinement absorbs the
    difference."""
    if b.dtype in _SOLVE_DTYPES:
        return torch.linalg.solve_triangular(a, b, upper=upper, left=True,
                                             unitriangular=unitriangular)
    return torch.linalg.solve_triangular(
        a.float(), b.float(), upper=upper, left=True,
        unitriangular=unitriangular).to(b.dtype)


def _solve_lower_left(a: torch.Tensor, b: torch.Tensor,
                      unit_diagonal: bool) -> torch.Tensor:
    return solve_triangular(a, b, upper=False, unitriangular=unit_diagonal)


def invert_triangular(a: torch.Tensor, lower: bool,
                      unit_diagonal: bool = False) -> torch.Tensor:
    """Inverse of a triangular block: one direct solve against the
    identity up to TRTRI_LEAF_MAX, block substitution on halves above
    it. Upper inputs reduce to lower via transposition."""
    n = a.shape[0]
    if not lower:
        return invert_triangular(a.T, True, unit_diagonal).T
    if n <= TRTRI_LEAF_MAX:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        return _solve_lower_left(a, eye, unit_diagonal)
    # inv([[A, 0], [C, B]]) = [[iA, 0], [-iB C iA, iB]]
    h = round_up(ceil_div(n, 2), 128)
    ia = invert_triangular(a[:h, :h], True, unit_diagonal)
    ib = invert_triangular(a[h:, h:], True, unit_diagonal)
    out = torch.zeros_like(a)
    out[:h, :h] = ia
    out[h:, h:] = ib
    out[h:, :h] = -((ib @ a[h:, :h]) @ ia)
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
              unit_diagonal: bool = False) -> torch.Tensor:
    """Solve A X = B with A (n, n) triangular, B (n, k): one direct
    solve, the RHS slabbed by columns above SOLVE_TEMP_CAP (each slab
    is still a direct, backward-stable solve)."""
    def direct(rhs):
        return solve_triangular(a, rhs, upper=not lower,
                                unitriangular=unit_diagonal)

    per_col = solve_temps_bytes(1, a.shape[0], b.element_size())
    if per_col * b.shape[1] > SOLVE_TEMP_CAP:
        k_slab = max(int(SOLVE_TEMP_CAP // per_col), 1)
        return torch.cat([direct(b[:, j:j + k_slab])
                          for j in range(0, b.shape[1], k_slab)], dim=1)
    return direct(b)


def trsm_dense(a: torch.Tensor, b: torch.Tensor, *, left: bool,
               lower: bool, nb: int,
               unit_diagonal: bool = False) -> torch.Tensor:
    """General entry: reduces the Right case to Left via conjugate
    transposition (X A = B  <=>  A^H X^H = B^H)."""
    if left:
        return trsm_left(a, b, lower, nb, unit_diagonal)
    xh = trsm_left(a.T.conj(), b.T.conj(), not lower, nb, unit_diagonal)
    return xh.T.conj()


def assemble_packed(panels: List[torch.Tensor],
                    strips: List[torch.Tensor], nb: int, kmax: int,
                    M: int, N: int, dtype) -> torch.Tensor:
    """Final assembly for the carry-style factorization: each step's
    (m_k, w_k) panel below k*nb zero rows, zero columns past kmax for
    M < N, and each step's top strip (U12) right of its diagonal
    block. Writes into one preallocated tensor instead of the
    reference's functional concatenation (same values)."""
    dev = panels[0].device
    out = torch.zeros((M, N), dtype=dtype, device=dev)
    c0 = 0
    for k, p in enumerate(panels):
        out[k * nb:, c0:c0 + p.shape[1]] = p
        c0 += p.shape[1]
    for k, strip in enumerate(strips):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        out[k0:k0 + strip.shape[0], k1:k1 + strip.shape[1]] = strip
    return out

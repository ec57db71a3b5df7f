"""A plain blocked LU solve with partial pivoting, in PyTorch alone: the
panel by the library LU (``torch.linalg.lu_factor_ex``), its row swaps on
the whole rows, U12 by a triangular solve and the trailing update by one
product. ``product`` names the precision of the trailing products:
``float32`` (TF32 off), or ``tf32``, whose operands are rounded to TF32's
10-bit mantissa first, as the tensor cores do. The ``tf32`` solve is the
control of the LU cells: the reference put in the program's place one
precision below the float32 that the configurations state.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, product: str) -> torch.Tensor:
    if product == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    elif product != "float32":
        raise ValueError("product must be float32 or tf32, not %r"
                         % product)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def _swaps_to_perm(piv: torch.Tensor, m: int) -> torch.Tensor:
    """LAPACK's 1-based row swaps (row j <-> piv[j]) as one permutation
    of range(m)."""
    perm = list(range(m))
    for j, p in enumerate(piv.tolist()):
        p -= 1
        perm[j], perm[p] = perm[p], perm[j]
    return torch.tensor(perm, device=piv.device)


def lu_factor(a: torch.Tensor, nb: int, product: str = "float32"):
    """(packed L\\U, row permutation) with a[perm] = L U."""
    a = a.clone()
    n = a.shape[0]
    perm = torch.arange(n, device=a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        lu, piv, _ = torch.linalg.lu_factor_ex(a[k0:, k0:k1])
        p = _swaps_to_perm(piv, n - k0)
        a[k0:] = a[k0:][p]
        perm[k0:] = perm[k0:][p]
        a[k0:, k0:k1] = lu
        if k1 < n:
            u12 = torch.linalg.solve_triangular(
                a[k0:k1, k0:k1], a[k0:k1, k1:], upper=False,
                unitriangular=True)
            a[k0:k1, k1:] = u12
            a[k1:, k1:] -= _matmul(a[k1:, k0:k1], u12, product)
    return a, perm


def lu_solve(lu: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    y = torch.linalg.solve_triangular(lu, b[perm], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)


def solve(a: torch.Tensor, b: torch.Tensor, nb: int,
          product: str = "float32") -> torch.Tensor:
    lu, perm = lu_factor(a, nb, product)
    return lu_solve(lu, perm, b)

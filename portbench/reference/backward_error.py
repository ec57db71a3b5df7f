"""The backward error of a computed solution, in float64: the number that
decides ``correct`` for a solve.

For each column j, ||A x_j - b_j||_2 / (||A||_F ||x_j||_2); the largest
over the columns is returned. The normwise form of ``chip_smoke.berr``
(||A X - B||_F / (||A||_F ||X||_F)) is its average over the columns; a
column of its own catches a wrong answer in one right-hand side of
many. A, X and B are read in row blocks, so the float64 copies of a
16384 x 16384 matrix are never whole. A non-finite X gives inf.
"""

from __future__ import annotations

import torch


def column_backward_error(a: torch.Tensor, x: torch.Tensor,
                          b: torch.Tensor, rows: int = 2048) -> float:
    n = a.shape[0]
    x64 = x.double()
    if not bool(torch.isfinite(x64).all()):
        return float("inf")
    r2 = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    a2 = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, n, rows):
        blk = a[i:i + rows].double()
        a2 += (blk * blk).sum()
        r = torch.addmm(b[i:i + rows].double(), blk, x64, alpha=1.0,
                        beta=-1.0)
        r2 += (r * r).sum(dim=0)
        del blk, r
    xn = torch.linalg.vector_norm(x64, dim=0)
    err = r2.sqrt() / (a2.sqrt() * xn)
    err = torch.where(xn == 0, torch.where(r2 == 0, 0.0, float("inf")),
                      err)
    return float(err.max())

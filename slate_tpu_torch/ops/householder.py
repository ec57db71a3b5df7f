"""Householder reflector construction, lapack larfg semantics
(counterpart of ``slate_tpu/ops/householder.py``): the degenerate-case
handling the QR panel's column loop (``linalg/qr.py``) shares.
"""

from __future__ import annotations

import torch


def reflect(x: torch.Tensor, idx: torch.Tensor, pivot_pos: int):
    """Householder (v, tau, beta) with H = I - tau v v^H mapping x to
    beta * e_pivot, zeroing entries idx > pivot_pos; entries of x at
    idx < pivot_pos are ignored (assumed already eliminated).

    Degenerate cases: if the sub-pivot part of x is zero (and, for
    complex, the pivot is real), tau = 0, v = 0 and beta = x[pivot]
    (identity reflector), matching lapack larfg."""
    dt = x.dtype
    zero = torch.zeros((), dtype=dt, device=x.device)
    one = torch.ones((), dtype=dt, device=x.device)
    at_pivot = idx == pivot_pos
    alpha = torch.where(at_pivot, x, zero).sum()
    below = idx > pivot_pos
    xnorm2 = torch.where(below, x.abs() ** 2,
                         torch.zeros((), dtype=x.abs().dtype,
                                     device=x.device)).sum()
    anorm = torch.sqrt(alpha.abs() ** 2 + xnorm2)
    if dt.is_complex:
        mag = alpha.abs()
        sign = torch.where(mag == 0, one, alpha / mag)
        trivial = (xnorm2 == 0) & (alpha.imag == 0)
    else:
        sign = torch.where(alpha >= 0, one, -one)
        trivial = xnorm2 == 0
    beta = -sign * anorm.to(dt)
    denom = alpha - beta
    safe = torch.where(denom == 0, one, denom)
    v = torch.where(below, x / safe, zero)
    v = torch.where(at_pivot, torch.where(trivial, zero, one), v)
    tau = torch.where(trivial, zero,
                      (beta - alpha) / torch.where(beta == 0, one, beta))
    beta = torch.where(trivial, alpha, beta)
    return v, tau, beta

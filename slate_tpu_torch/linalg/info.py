"""LAPACK-style info codes (counterpart of ``slate_tpu/linalg/info.py``),
reduced to the LU slice."""

from __future__ import annotations

import torch


def first_fail(bad: torch.Tensor) -> torch.Tensor:
    """1-based index of the first True in bad, else 0 (int32, 0-d)."""
    n = bad.shape[0]
    idx = torch.where(bad, torch.arange(n, device=bad.device),
                      torch.full((), n, device=bad.device))
    first = idx.min() if n else torch.tensor(n, device=bad.device)
    return torch.where(first < n, first + 1,
                       torch.zeros((), dtype=first.dtype,
                                   device=bad.device)).to(torch.int32)


def lu_info(ludata: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """info for a packed LU factor: first exactly-zero or non-finite
    U(k,k) (LAPACK getrf convention)."""
    d = ludata.diagonal()[:min(m, n)]
    return first_fail((d == 0) | ~torch.isfinite(d))

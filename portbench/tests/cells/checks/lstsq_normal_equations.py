"""Test only: the check of a least-squares solve min ||A x - b||, whose
residual is not small: the normal equations' residual
||A^T (A x_j - b_j)||_2 / (||A||_F^2 ||x_j||_2), the largest over the
sampled calls' columns, in float64, under ``normal_residual_max``; an X
of the wrong shape is wrong."""

import math

import torch


def judge(cell, outputs, remake, device):
    limit = cell.limits["normal_residual_max"]
    errs = []
    for s, out in outputs:
        inputs = remake(s)
        a, b, x = (inputs["a"].double(), inputs["b"].double(),
                   out["x"].double())
        if tuple(x.shape) != (a.shape[1], b.shape[1]):
            errs.append(math.inf)
            continue
        r = a.T @ (a @ x - b)
        e = torch.linalg.vector_norm(r, dim=0) / (
            torch.linalg.matrix_norm(a) ** 2
            * torch.linalg.vector_norm(x, dim=0))
        errs.append(float(e.max()))
    worst = max(errs, default=math.inf)
    return ({"normal_residual_max": {"value": worst, "limit": limit}},
            worst <= limit, sum(not e <= limit for e in errs))

"""The check of a square linear solve A X = B: the largest column
backward error ||A x_j - b_j||_2 / (||A||_F ||x_j||_2) of the sampled
calls' X, in float64 by the plain reference, under the cell's limit
``berr_max`` (``limits/<cell>.json``).

``judge(cell, outputs, remake, device)``: `outputs` holds (pool system,
the entry's output) of each sampled call, `remake(system)` the system's
inputs made anew from the seed. It returns the numbers compared, each
with its limit, whether all are within their limits, and how many
outputs were judged wrong."""

import math

from portbench.reference.backward_error import column_backward_error


def judge(cell, outputs, remake, device):
    limit = cell.limits["berr_max"]
    errs = []
    for s, out in outputs:
        inputs = remake(s)
        errs.append(column_backward_error(inputs["a"], out["x"],
                                          inputs["b"]))
        del inputs
    berr = math.nan if any(math.isnan(e) for e in errs) \
        else max(errs, default=math.inf)
    checks = {"berr_max": {"value": berr, "limit": limit}}
    return checks, berr <= limit, sum(not e <= limit for e in errs)

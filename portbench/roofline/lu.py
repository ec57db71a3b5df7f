"""Operation and byte counts of the LU solves (gesv and its mixed-precision
forms).

``classical_flops`` is the count HPL and PERF.md rate a solve by:
2/3 n^3 for the factor and 2 n^2 for each right-hand side, whatever the
driver does beyond it (refinement, padding). ``panel_flops`` is a copy of
``chip_smoke.panel_flops``: the partial-pivot LU of an m x w panel.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from portbench.roofline import peaks


def classical_flops(n: int, nrhs: int) -> float:
    return 2.0 / 3.0 * n ** 3 + 2.0 * n * n * nrhs


def panel_flops(m: int, w: int) -> float:
    return m * w * w - w ** 3 / 3.0


def panel_bytes(m: int, w: int, dtype: str) -> float:
    """The panel read once and written once, and its w pivots (int32)
    written once."""
    return 2.0 * m * w * peaks.element_size(dtype) + 4.0 * w


def panel_schedule(n: int, nb: int) -> List[Tuple[int, int]]:
    """The panels of a right-looking blocked LU of a square n x n matrix
    at block width nb: panel k is (n - k nb) x nb."""
    return [(n - k, min(nb, n - k)) for k in range(0, n, nb)]


def panel_bound_s(config: Dict[str, Any]) -> float:
    """Least time of one factor's panels: the sum over the schedule of
    each panel's bound at the factor's type."""
    dtype = config["factor_dtype"]
    return sum(peaks.bound_s(panel_flops(m, w), panel_bytes(m, w, dtype),
                             dtype)
               for m, w in panel_schedule(config["n"], config["block_size"]))


def call_flops(config: Dict[str, Any], traffic: Dict[str, Any]) -> float:
    return classical_flops(config["n"], traffic["nrhs"])

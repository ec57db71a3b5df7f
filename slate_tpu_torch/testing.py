"""Seeded inputs shared by the tests and ``chip_smoke.py`` (the
counterpart of the panel helpers in ``tests/test_pallas_rec.py``).
numpy only, so the same arrays can go through both packages."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def dyadic_noise(rng, m: int, w: int) -> np.ndarray:
    """Exactly representable small values (k/16, |k| <= 8)."""
    return (rng.integers(-8, 9, (m, w)) / 16.0).astype(np.float32)


def spiked(rng, m: int, w: int, spike_rows, noise: bool = True
           ) -> np.ndarray:
    """Panel with a dominant (64.0) spike per column j at row
    spike_rows[j]: the spikes force the pivot SEQUENCE whatever the
    update rounding (noise stays <= 1/2 through every update)."""
    a = dyadic_noise(rng, m, w) if noise else np.zeros((m, w), np.float32)
    for j, r in enumerate(spike_rows):
        a[r, j] = 64.0
    return a


def panel_cases(rng, m: int, w: int, ib: int) -> Dict[str, np.ndarray]:
    """The adversarial pivoting suite of tests/test_pallas_rec.py:
    cross-half pivots at every recursion boundary ("antidiag"), the
    pivot always in the next ib-segment ("boundary"), a random
    permutation of the bottom w rows ("randperm"), exact ties
    ("ties", zero noise) and a zero column ("zerocol", zero noise)."""
    cases = {}
    cases["antidiag"] = spiked(rng, m, w, [m - 1 - j for j in range(w)])
    cases["boundary"] = spiked(
        rng, m, w, [min((j // ib + 1) * ib, m - 1) for j in range(w)])
    sigma = rng.permutation(w)
    cases["randperm"] = spiked(rng, m, w, [m - w + int(s) for s in sigma])
    a = np.zeros((m, w), np.float32)
    for j in range(w):
        a[m - w + j, j] = 64.0
        a[m - w // 2 + j // 2, j] = 64.0
    cases["ties"] = a
    z = spiked(rng, m, w, [m - 1 - j for j in range(w)], noise=False)
    z[:, w // 2] = 0.0
    cases["zerocol"] = z
    return cases


#: kinds whose every operation is exact: values must match bitwise
EXACT_KINDS = ("ties", "zerocol")


def bf16_ulps(x, y) -> float:
    """Largest |x - y| in units of the bf16 ulp (2^-7 relative to the
    leading bit) of max(|x|, |y|), over arrays of bf16 values given as
    float; 0 where x == y."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    _, e = np.frexp(np.maximum(np.abs(x), np.abs(y)))
    d = np.abs(x - y)
    ulps = np.where(d == 0, 0.0, d / np.ldexp(1.0, e - 8))
    return float(ulps.max()) if ulps.size else 0.0


def permuted_boosted_system(rng, n: int, nrhs: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(A, B) f32: the rows of a diagonally boosted Gaussian matrix
    (G + 2 sqrt(n) I) in a random order, and a Gaussian right-hand
    side. Each column's pivot sits in a random row, so every pivot
    search and row swap does real work, while the condition number
    stays O(1), so solves by different routes agree to a tight
    forward tolerance (a plain Gaussian matrix has a condition number
    of order n)."""
    g = rng.standard_normal((n, n), dtype=np.float32)
    g[np.diag_indices(n)] += np.float32(2.0 * np.sqrt(n))
    a = g[rng.permutation(n)]
    b = rng.standard_normal((n, nrhs), dtype=np.float32)
    return a, b

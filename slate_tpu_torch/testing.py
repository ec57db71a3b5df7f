"""Seeded inputs shared by the tests and ``chip_smoke.py`` (the
counterpart of the panel helpers in ``tests/test_pallas_rec.py``).
numpy arrays, so the same inputs can go through both packages;
``spd_system`` and ``permuted_boosted_system`` also make their systems
on the card from a ``torch.Generator``. The band and indefinite systems
(``band_spd_system``, ``band_general_system``, ``indefinite_system``)
take a seed and an explicit device and make tensors there from a
``torch.Generator``: on the card at the paths' size, on the CPU for the
tests (whose ``.numpy()`` goes through both packages)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


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
    of order n). A torch.Generator makes the same kind of system as
    tensors on its device (chip_smoke.py's out-of-core runs)."""
    if isinstance(rng, torch.Generator):
        dev = rng.device
        g = torch.randn((n, n), generator=rng, device=dev)
        g.diagonal().add_(2.0 * float(np.sqrt(n)))
        a = g[torch.randperm(n, generator=rng, device=dev)]
        del g
        return a, torch.randn((n, nrhs), generator=rng, device=dev)
    g = rng.standard_normal((n, n), dtype=np.float32)
    g[np.diag_indices(n)] += np.float32(2.0 * np.sqrt(n))
    a = g[rng.permutation(n)]
    b = rng.standard_normal((n, nrhs), dtype=np.float32)
    return a, b


def spd_system(rng, n: int, nrhs: int):
    """(S, B) f32: S = G G^T / n + I with G Gaussian (n, n), and a
    Gaussian right-hand side (n, nrhs). The eigenvalues of G G^T / n
    lie in [0, 4] (Marchenko-Pastur), so cond(S) <= 5 and solves by
    different routes agree to a tight forward tolerance. `rng` is a
    numpy Generator (numpy arrays, the tests' inputs to both packages)
    or a torch.Generator (tensors on its device, the product formed
    there: chip_smoke.py's 1 GiB system at n = 16384)."""
    if isinstance(rng, torch.Generator):
        dev = rng.device
        g = torch.randn((n, n), generator=rng, device=dev)
        s = torch.addmm(torch.eye(n, device=dev), g, g.T, alpha=1.0 / n)
        return s, torch.randn((n, nrhs), generator=rng, device=dev)
    g = rng.standard_normal((n, n))
    s = (g @ g.T / n + np.eye(n)).astype(np.float32)
    return s, rng.standard_normal((n, nrhs)).astype(np.float32)


#: power-of-two scales of the adversarial suites: far from 1 in both
#: directions, yet the squares of Gaussian entries and their sums over
#: a 256-row panel stay normal f32 numbers (no subnormals, no overflow)
TINY, HUGE = 2.0 ** -40, 2.0 ** 40


def qr_panel_cases(rng, m: int, w: int) -> Dict[str, np.ndarray]:
    """The Householder panel's adversarial suite (f32 (m, w)): a zero
    column ("zerocol": tau 0), an upper-triangular panel whose every
    column is already zero below the diagonal ("triu": tau 2 in the
    kernel, 0 in householder.reflect), equal columns ("equal": the
    columns after the first reduce to rounding noise), and a Gaussian
    panel at tiny and huge scales."""
    g = rng.standard_normal((m, w)).astype(np.float32)
    z = g.copy()
    z[:, w // 2] = 0.0
    return {"zerocol": z, "triu": np.triu(g),
            "equal": np.repeat(g[:, :1], w, axis=1),
            "tiny": (g * TINY).astype(np.float32),
            "huge": (g * HUGE).astype(np.float32)}


def qr_sign_tie_panel(seed: int = 0) -> np.ndarray:
    """The f32 (1024, 128) Gaussian panel on which two valid bf16
    Householder factorizations part at a reflector's sign: the panel
    that chip_smoke.py's shared stream of `seed` 0 gave its bf16 1024-row
    qr_panel case when its swap-composition phase drew every case from
    that stream. Regenerated from the seed by replaying the draws that
    came first (in that phase order): the swap sequences, then the LU,
    recursive-LU, trailing-update and QR panels. On it, the kernel and
    qr_panel_plain on the card take opposite signs at column 101, whose
    alpha (-0.0046 and +0.0072 against entries of rms 1.0) lies within
    the rounding of the 101 bf16 updates before it; the kernel's step
    from the plain version's state is bitwise the plain step there."""
    rng = np.random.default_rng(seed)
    n = 16384
    for w in (512, 256, 128, 64, 32):            # LU swap sequences
        for j in range(w):
            rng.integers(0, n - j)
    rng.integers(0, n, 512)                      # any targets
    rng.integers(-2 * n, 2 * n, 512)             # targets off the rows
    shapes = [(m, 256) for m in (4096, 2048, 1024, 256)] * 2
    shapes += [(n, 128), (n, 512), (n, 64), (n, 512)]
    for dims in ([(n - 256, 256, 256), (n - 128, 128, 128),
                  (n - 293, 256, 256)],
                 [(n - 256, 256, 256), (n - 128, 128, 128),
                  (n - 64, 64, 64), (n - 293, 256, 256)]):
        for m2, w1, w2 in dims:
            shapes += [(m2, w2), (m2, w1), (w1, w2)]
    shapes += [(m, 128) for m in (8192, 4096, 1024, 256, 8192, 4096)]
    for shape in shapes:
        rng.standard_normal(shape, dtype=np.float32)
    return rng.standard_normal((1024, 128), dtype=np.float32)


#: an alpha whose sign two valid bf16 factorizations may take either
#: way: within 2^-4 of the column's rms entry. The trailing entries of
#: the sign-tie panel (qr_sign_tie_panel) differ by up to 2^-5 between
#: the kernel and the plain version before the tie (the R rows), so an
#: alpha within twice that of zero has its sign set by rounding
QR_SIGN_TIE = 2.0 ** -4


def qr_sign_tie(packed_a, taus_a, packed_b, taus_b) -> int:
    """First column t at which two Householder factorizations of one
    (m, w) panel take opposite reflector signs on a tie: their R[t, t]
    have opposite signs while both alphas, R[t, t] (1 - tau[t]) (tau =
    (beta - alpha) / beta), lie within QR_SIGN_TIE of the column's rms
    entry |R[t, t]| / sqrt(m - t) of zero. Such factors part from t on
    and are both valid; before t the two must agree. Returns w (min(m,
    w)) when there is none."""
    m, w = packed_a.shape
    k = min(m, w)
    da = np.asarray(packed_a, np.float64)[np.arange(k), np.arange(k)]
    db = np.asarray(packed_b, np.float64)[np.arange(k), np.arange(k)]
    ta = np.asarray(taus_a, np.float64)[:k]
    tb = np.asarray(taus_b, np.float64)[:k]
    rms = np.abs(db) / np.sqrt(m - np.arange(k))
    alpha = np.maximum(np.abs(da * (1.0 - ta)), np.abs(db * (1.0 - tb)))
    tie = (np.sign(da) != np.sign(db)) & (alpha <= QR_SIGN_TIE * rms)
    return int(np.argmax(tie)) if tie.any() else k


def qr_before_tie(packed: np.ndarray, t: int) -> np.ndarray:
    """The entries of a packed (m, w) Householder factor that its first
    t steps write: rows above t (R) and columns left of t (V and R)."""
    m, w = packed.shape
    keep = (np.arange(m)[:, None] < t) | (np.arange(w)[None, :] < t)
    return np.where(keep, np.asarray(packed, np.float64), 0.0)


def chol_cases(rng, n: int) -> Dict[str, np.ndarray]:
    """The Cholesky block's adversarial suite (f32 (n, n), lower
    triangle read): a zero row and column ("zerocol": d = 0, divided by
    1), a diagonal matrix, every column already zero below the
    diagonal ("diag"), equal columns (all ones, rank 1: every pivot
    after the first is 0), and an SPD matrix at tiny and huge scales."""
    s, _ = spd_system(rng, n, 1)
    z = s.copy()
    z[n // 3, :] = 0.0
    z[:, n // 3] = 0.0
    return {"zerocol": z,
            "diag": np.diag(rng.uniform(0.5, 2.0, n)).astype(np.float32),
            "equal": np.ones((n, n), np.float32),
            "tiny": (s * TINY).astype(np.float32),
            "huge": (s * HUGE).astype(np.float32)}


def trtri_cases(rng, n: int) -> Dict[str, np.ndarray]:
    """The triangular inverse's adversarial suite (f32 lower (n, n)): a
    zero on the diagonal ("zerodiag": taken as 1), a diagonal matrix
    ("diag"), equal columns (the lower triangle of ones: the inverse is
    exact), and a well-conditioned triangle at tiny and huge scales."""
    L = np.tril(rng.standard_normal((n, n)) / np.sqrt(n))
    L[np.diag_indices(n)] = rng.uniform(1.0, 2.0, n)
    L = L.astype(np.float32)
    z = L.copy()
    z[n // 2, n // 2] = 0.0
    return {"zerodiag": z,
            "diag": np.diag(rng.uniform(0.5, 2.0, n)).astype(np.float32),
            "equal": np.tril(np.ones((n, n), np.float32)),
            "tiny": (L * TINY).astype(np.float32),
            "huge": (L * HUGE).astype(np.float32)}


# -- the batch layer ---------------------------------------------------------

def stack_garbage(mats, ceil: int) -> np.ndarray:
    """Stack (s, s) matrices to (B, ceil, ceil) with GARBAGE in the pad
    (7.25 right of / -3.5 below each live block: tests/test_ragged.py's
    values): the ragged kernels must never read it."""
    out = np.zeros((len(mats), ceil, ceil), np.asarray(mats[0]).dtype)
    for i, a in enumerate(mats):
        s = a.shape[0]
        out[i, s:, :] = 7.25
        out[i, :, s:] = -3.5
        out[i, :s, :s] = a
    return out


def ragged_cases(rng) -> Dict[str, tuple]:
    """The ragged kernels' adversarial suites of tests/test_ragged.py,
    f32, garbage in every pad: "potrf" (orders 1, 33, 70 and the
    ceiling 96, SPD x x^T / s + 2 I), "getrf" (ceiling 64: a permuted
    Gaussian, a zero column, order 1, the ceiling with two equal rows
    permuted), and "trsm_lower" / "trsm_upper" (orders 17, 64, 40,
    diagonally dominant triangles, 3 right-hand sides with 11.0 in the
    pad rows). Each entry is (stack, sizes[, rhs])."""
    sizes = [1, 33, 70, 96]
    spds = []
    for s in sizes:
        x = rng.standard_normal((s, s))
        spds.append((x @ x.T / s + 2.0 * np.eye(s)).astype(np.float32))
    cases = {"potrf": (stack_garbage(spds, 96), sizes)}
    a = rng.standard_normal((40, 40))
    b = rng.standard_normal((33, 33))
    b[:, 7] = 0.0
    c = rng.standard_normal((64, 64))
    c[5] = c[11]
    mats = [a[rng.permutation(40)], b, np.array([[3.5]]),
            c[rng.permutation(64)]]
    cases["getrf"] = (stack_garbage([m.astype(np.float32) for m in mats],
                                    64), [m.shape[0] for m in mats])
    for upper in (False, True):
        tsz = [17, 64, 40]
        tris = []
        rhs = np.full((3, 64, 3), 11.0, np.float32)
        for i, s in enumerate(tsz):
            t = rng.standard_normal((s, s)) / np.sqrt(s) + 2.0 * np.eye(s)
            tris.append((np.triu(t) if upper else np.tril(t))
                        .astype(np.float32))
            rhs[i, :s] = rng.standard_normal((s, 3))
        cases["trsm_upper" if upper else "trsm_lower"] = (
            stack_garbage(tris, 64), tsz, rhs)
    return cases


def ragged_getrf_wide_case(rng, ceil: int = 384) -> tuple:
    """The ragged LU's adversarial suite at a ceiling wide enough for a
    cluster of several blocks an element (ceil // 128 of them, the
    kernel's rule): the ceiling with two equal rows permuted, a permuted
    Gaussian whose order is off the stripe width, a zero column, order
    1; f32, garbage in every pad. (stack, sizes)."""
    c = rng.standard_normal((ceil, ceil))
    c[5] = c[ceil - 7]
    a = rng.standard_normal((ceil - 84, ceil - 84))
    b = rng.standard_normal((ceil - 127, ceil - 127))
    b[:, 40] = 0.0
    mats = [c[rng.permutation(ceil)], a[rng.permutation(ceil - 84)], b,
            np.array([[3.5]])]
    return (stack_garbage([m.astype(np.float32) for m in mats], ceil),
            [m.shape[0] for m in mats])


def serve_stream(seed: int = 0, reqs: int = 256):
    """The batch layer's serving stream (the reference's bench.py
    --serve): orders n lognormal around 180 (sigma 0.6) clipped to
    [64, 1024], for each a Gaussian x (n, n) and the SPD request
    x x^T / n + 4 I, f32 numpy, from ``default_rng(seed)``. Returns
    (sizes, xs, spds)."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.rint(np.exp(rng.normal(np.log(180.0), 0.6,
                                              reqs))).astype(int), 64, 1024)
    xs, spds = [], []
    for n in sizes:
        x = rng.standard_normal((n, n)).astype(np.float32)
        xs.append(x)
        spds.append((x @ x.T / n + 4.0 * np.eye(n)).astype(np.float32))
    return [int(n) for n in sizes], xs, spds


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def band_spd_system(seed: int, n: int, kd: int, nrhs: int, device,
                    dtype=torch.float32):
    """(A, B): tests/test_band.py's ``spd_band``, the entries
    |i - j| <= kd of G + G^T plus 4 sqrt(n) I with G Gaussian (n, n),
    and a Gaussian right-hand side (n, nrhs), made on `device`. The
    band of G + G^T has its spectrum in about +-2 sqrt(2 (2 kd + 1)),
    far below 4 sqrt(n) when kd << n: A is SPD and well conditioned."""
    g = _generator(seed, device)
    x = torch.randn((n, n), generator=g, device=device, dtype=dtype)
    a = x + x.T
    del x
    a.tril_(kd).triu_(-kd)
    a.diagonal().add_(4.0 * n ** 0.5)
    return a, torch.randn((n, nrhs), generator=g, device=device,
                          dtype=dtype)


def band_general_system(seed: int, n: int, kl: int, ku: int, nrhs: int,
                        device, shift: float = 4.0, group: int = 0,
                        dtype=torch.float32):
    """(A, B): tests/test_band.py's ``gen_band``, a Gaussian band with
    kl sub- and ku superdiagonals plus shift I, and a Gaussian
    right-hand side (n, nrhs), made on `device`.

    With ``group`` > 0 the band is built with kl - group + 1 and
    ku - group + 1 diagonals and its rows are then permuted at random
    within consecutive groups of ``group`` rows (the band counterpart
    of ``permuted_boosted_system``): A keeps bandwidths kl and ku, a
    shift above the band's spectral disc (radius about
    sqrt(kl + ku + 1)) keeps it well conditioned, and each column's
    pivot sits in another row of its group, so partial pivoting moves
    rows in every block step. Without it, a shift inside the disc makes
    pivoting move rows but lets the condition number grow with n."""
    g = _generator(seed, device)
    a = torch.randn((n, n), generator=g, device=device, dtype=dtype)
    a.tril_(ku - max(group - 1, 0)).triu_(-(kl - max(group - 1, 0)))
    a.diagonal().add_(shift)
    if group > 0:
        keys = torch.rand((n,), generator=g, device=device) \
            + torch.arange(n, device=device) // group
        a = a[torch.argsort(keys)]
    return a, torch.randn((n, nrhs), generator=g, device=device,
                          dtype=dtype)


def indefinite_system(seed: int, n: int, nrhs: int, device,
                      dtype=torch.float32):
    """(A, B): A = (G + G^T) / 2 + 4 sqrt(n) diag(s) with G Gaussian
    (n, n) and s random +-1, and a Gaussian right-hand side (n, nrhs),
    made on `device`. (G + G^T) / 2 has its spectrum in
    [-sqrt(2n), sqrt(2n)], so A's eigenvalues lie in
    +-[4 - 1.41, 4 + 1.41] sqrt(n): indefinite, with 2-norm condition
    about 2.1, while Aasen's panel LU still pivots off the diagonal
    (the off-diagonal entries of a column outweigh its diagonal)."""
    g = _generator(seed, device)
    x = torch.randn((n, n), generator=g, device=device, dtype=dtype)
    a = x + x.T
    del x
    a.mul_(0.5)
    s = torch.randint(0, 2, (n,), generator=g, device=device)
    a.diagonal().add_((2 * s - 1).to(dtype) * (4.0 * n ** 0.5))
    return a, torch.randn((n, nrhs), generator=g, device=device,
                          dtype=dtype)

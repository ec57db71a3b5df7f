"""Polar decomposition / matrix sign function (counterpart of
``slate_tpu/linalg/polar.py``).

The spectral divide & conquer eigensolver (spectral_dc.py) needs, per
split, the orthogonal polar factor U of the shifted Hermitian matrix
H - sigma I: the matrix sign function. The algorithm is the
reference's capped-weight all-Cholesky dynamically weighted Halley
iteration (family: Nakatsukasa-Bai-Gygi SIMAX 2010; Nakatsukasa-Higham
SISC 2013):

  * the weighted Halley map x -> x (a + b x^2) / (1 + c x^2) with the
    weight c capped at ``C_MAX_F32`` / ``C_MAX_F64``, so that
    cond(c U^H U + I) <= 1 + c_max stays inside the dtype's Cholesky
    range and every iteration runs the Cholesky form: one Gram
    product, a Cholesky factor, two triangular solves;
  * a lower bound l on sigma_min drives the weights; while l is small
    (``EST_GATE``) a sigma_min estimator (power iteration on the
    Cholesky factor) may lift it, by the interval minimum of the
    step's scalar map (``_lift_estimate``), and only when the power
    iteration converged;
  * one closing Newton-Schulz step restores orthogonality.

The Cholesky factor and the solves are library calls
(``torch.linalg.cholesky_ex``, ``solve_triangular``), as the
reference's are XLA built-ins. f32 products run at full precision (the
package switches TF32 off): the capped-weight solves need it.

The scalar schedule (a, b, c, l) runs on the host in numpy float32, as
the reference's runs in f32 on the device; a subexpression of Python
floats alone is evaluated in float64 and then rounded, as jax does
with 64-bit types enabled. The reference's ``while_loop`` is a Python
loop with one host read an iteration: diff, and while l < EST_GATE the
estimate and its reliability flag, stacked into one tensor.

The estimator's start block is e_j at the weakest Cholesky pivot plus
three Gaussian columns. The reference draws them from
``fold_in(PRNGKey(7), it)``; the port draws them on the host from a
``torch.Generator`` seeded from 7 and the iteration, so the draws
differ (``start_block=`` takes a given draw).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.tile_ops import _real_dtype
from ..utils.backend import DeviceLike
from .eig import _vec

#: weight caps keeping cond(c U^H U + I) ~ c inside the dtype's
#: Cholesky range: forward error of the solves ~ eps * c, which must
#: stay well below 1 for the iteration's self-correction (and the
#: closing Newton-Schulz) to absorb it.
C_MAX_F32 = 3.0e5
C_MAX_F64 = 1.0e12

#: run the sigma_min estimator only while the schedule is still in the
#: capped-growth phase (l below this)
EST_GATE = 0.02

#: columns of the estimator's start block
EST_COLS = 4

#: seed of the estimator's start block (with the iteration folded in)
EST_SEED = 7

_F = np.float32


def _cbrt_f32(x):
    """f32 cube root as XLA evaluates it, x^(1/3) with the exponent
    rounded to f32 (within an ulp of the reference's jnp.cbrt, where
    numpy's correctly rounded cbrt parts from it by up to 13 ulps)."""
    x = np.float64(x)
    return _F(np.sign(x) * np.power(abs(x), np.float64(_F(1.0 / 3.0))))


def _capped_params(l, c_max):
    """Weighted Halley coefficients for lower bound l, with the
    c-weight capped at c_max (module doc). Returns (a, b, c, l') as
    numpy float32 scalars.

    l is clamped at 1e-8: 1/l^4 overflows f32 below it, and
    a_opt(1e-8) ~ 7e10 already exceeds every cap."""
    l = np.maximum(_F(l), _F(1e-8))
    l2 = l * l
    dd = _cbrt_f32(_F(4.0) * (_F(1.0) / l2 - _F(1.0)) / l2)
    sqd = np.sqrt(_F(1.0) + dd)
    a_opt = sqd + np.sqrt(_F(2.0) - dd
                          + _F(2.0) * (_F(2.0) - l2) / (l2 * sqd))
    # capped family member: a = 2 sqrt(1+c) - 1 solves a+b-1 = c with
    # b = (a-1)^2/4 (Python floats: float64, then rounded)
    a_cap = _F(2.0 * np.sqrt(1.0 + float(c_max)) - 1.0)
    a = np.minimum(a_opt, a_cap)
    b = (a - _F(1.0)) ** 2 / _F(4.0)
    c = a + b - _F(1.0)
    lnew = l * (a + b * l2) / (_F(1.0) + c * l2)
    lnew = np.minimum(np.maximum(lnew, l), _F(1.0))
    return a, b, c, lnew


def _lift_estimate(sg, a, b, c):
    """Lower bound of the scalar map f(x) = x (a + b x^2)/(1 + c x^2)
    over the whole interval [sg, 1], given a lower bound sg on the
    pre-step sigma_min (numpy float32 in and out). Under capped
    weights f dips inside the interval (writing e = b/c,
    f(x) = e x + (a-e) x/(1 + c x^2)), so f(sg) alone may exceed the
    post-step sigma_min; the bound is min(f(sg), f(x*)) with x* the
    interior minimiser, the larger root s of
    e s^2 - (a-e) s + 2(a-e) = 0 with s = 1 + c x^2. A (1 - 1e-5)
    deflation absorbs the f32 roundoff of the root."""
    sg, a, b, c = _F(sg), _F(a), _F(b), _F(c)
    e = b / c
    fsg = sg * (a + b * sg * sg) / (_F(1.0) + c * sg * sg)
    amee = a - e
    disc = amee * (amee - _F(8.0) * e)
    tiny = _F(np.finfo(np.float32).tiny)
    s = (amee + np.sqrt(np.maximum(disc, _F(0.0)))) \
        / np.maximum(_F(2.0) * e, tiny)
    x2 = np.maximum(s - _F(1.0), _F(0.0)) / c
    x = np.sqrt(x2)
    fdip = x * (a + b * x2) / (_F(1.0) + c * x2)
    valid = (disc > _F(0.0)) and (x > sg) and (x < _F(1.0))
    lo = np.minimum(fsg, fdip) if valid else fsg
    return lo * _F(1.0 - 1e-5)


def _start_block(n: int, it: int) -> torch.Tensor:
    """The estimator's three random start columns for iteration `it`,
    drawn on the host (the same values on every device)."""
    g = torch.Generator()
    g.manual_seed(EST_SEED * 2 ** 32 + int(it))
    return torch.randn((n, EST_COLS - 1), generator=g,
                       dtype=torch.float32)


def _chol_halley_step(u: torch.Tensor, a, b, c,
                      want_sigma_est: bool = False, it: int = 0,
                      start_block: Optional[torch.Tensor] = None):
    """One weighted Halley iteration in the Cholesky form:
    u <- (b/c) u + (a - b/c) u (I + c u^H u)^{-1}, the inverse applied
    through the Cholesky factor r of x = I + c u^H u and two triangular
    solves. a, b, c are float32 scalars.

    With want_sigma_est, also returns an over-estimate of sigma_min of
    the pre-step u (a 0-d float32 tensor) and a 0-d bool tensor
    `reliable`: power iteration on x^{-1} = (r r^H)^{-1}, 4 steps of
    two triangular solves on an (n, 4) block, whose ratio
    lower-bounds lambda_max(x^{-1}); `reliable` needs
    lambda_min(x) - 1 > 0.5 and the last two ratios within 5%. The
    block's first column is e_j at the weakest Cholesky pivot, the
    rest `start_block` ((n, 3) float32), drawn from the iteration
    `it` when not given. Nothing is read back to the host."""
    n = u.shape[0]
    dt = u.dtype
    rdt = _real_dtype(dt)
    a, b, c = _F(a), _F(b), _F(c)
    e = b / c
    uh = u.mH
    g = uh @ u
    x = float(c) * g + torch.eye(n, dtype=dt, device=u.device)
    # x >= I is positive definite; the _ex form reads no status back
    r, _info = torch.linalg.cholesky_ex(x)
    # z = u x^{-1}: solve r t = u^H, then r^H s = t; z = s^H
    t = torch.linalg.solve_triangular(r, uh, upper=False)
    z = torch.linalg.solve_triangular(r.mH, t, upper=True).mH
    unew = float(e) * u + float(a - e) * z
    if not want_sigma_est:
        return unew
    if start_block is None:
        start_block = _start_block(n, it)
    rdiag = torch.diagonal(r).abs()
    j0 = torch.argmin(rdiag)
    v = torch.empty((n, EST_COLS), dtype=dt, device=u.device)
    v[:, 0] = (torch.arange(n, device=u.device) == j0).to(dt)
    v[:, 1:] = torch.as_tensor(start_block).to(device=u.device, dtype=dt)
    v = v / torch.sqrt((v.abs() ** 2).sum(dim=0))[None, :]
    tiny = torch.finfo(rdt).tiny
    ratio_prev = ratio = torch.ones((), dtype=rdt, device=u.device)
    for _ in range(4):
        w = torch.linalg.solve_triangular(r, v, upper=False)
        w = torch.linalg.solve_triangular(r.mH, w, upper=True)
        nrm = torch.sqrt((w.abs() ** 2).sum(dim=0))
        ratio_prev, ratio = ratio, nrm.max()       # <= lambda_max(x^-1)
        v = w / torch.clamp(nrm, min=tiny)[None, :]
    lam_min_x = 1.0 / torch.clamp(ratio, min=tiny)
    sig2 = (lam_min_x - 1.0) / float(c)
    pw_ok = (ratio - ratio_prev).abs() <= 0.05 * ratio
    reliable = (lam_min_x - 1.0 > 0.5) & pw_ok
    sig = torch.sqrt(torch.clamp(sig2, min=0.0))
    return unew, sig.to(torch.float32), reliable


def _polar(x: torch.Tensor, l0=None, eps=None, max_iterations=14,
           newton_schulz=True):
    """polar_unitary's body; also returns the host reads it made."""
    dt = x.dtype
    rdt = _real_dtype(dt)
    rnp = np.float64 if rdt == torch.float64 else np.float32
    if eps is None:
        eps = float(torch.finfo(rdt).eps)
    if l0 is None:
        l0 = eps
    c_max = C_MAX_F64 if eps < 1e-10 else C_MAX_F32
    tol_l = _F(5.0 * eps)
    # compared in the iterate's real type, as jax compares its weakly
    # typed constant with diff
    tol_norm = rnp(np.cbrt(5.0 * eps))

    # alpha >= ||x||_2 via sqrt(||x||_1 ||x||_inf)
    ax = x.abs()
    one_norm = ax.sum(dim=0).max()
    inf_norm = ax.sum(dim=1).max()
    alpha_inv = torch.rsqrt(one_norm) * torch.rsqrt(inf_norm)
    alpha_inv = torch.where(one_norm == 0, torch.ones_like(alpha_inv),
                            alpha_inv)
    u = x * alpha_inv.to(dt)
    l = _F(l0)
    k = 0
    reads = 0
    diff = None                     # the initial diff is ||u0||_F
    while k < max_iterations:
        if not l + tol_l < _F(1.0):
            if diff is None:
                diff = rnp(torch.linalg.norm(u).item())
                reads += 1
            if not diff > tol_norm:
                break
        a, b, c, lnew = _capped_params(l, c_max)
        if l < _F(EST_GATE):
            u2, sig, rel = _chol_halley_step(u, a, b, c,
                                             want_sigma_est=True, it=k)
            d = torch.linalg.norm(u2 - u)
            dv, sv, rv = torch.stack(
                [d.to(rdt), sig.to(rdt), rel.to(rdt)]).tolist()
            # bound the new iterate's sigma_min from the
            # safety-deflated pre-step estimate by the interval minimum
            # of this step's map; the estimate over-estimates, so it
            # only lifts the schedule, never finishes it
            sg = _F(0.7) * _F(sv)
            lest = _lift_estimate(sg, a, b, c)
            lest = np.minimum(np.maximum(lest, _F(0.0)), _F(0.98))
            if rv:
                lnew = np.maximum(lnew, lest)
        else:
            u2 = _chol_halley_step(u, a, b, c)
            dv = torch.linalg.norm(u2 - u).item()
        reads += 1
        u, l, k, diff = u2, lnew, k + 1, rnp(dv)
    if diff is None:
        diff = rnp(torch.linalg.norm(u).item())
        reads += 1
    if newton_schulz:
        g = u.mH @ u
        u = 1.5 * u - 0.5 * (u @ g)
    return u, k, bool(diff <= tol_norm), reads


def polar_unitary(x, l0: Optional[float] = None,
                  eps: Optional[float] = None, max_iterations: int = 14,
                  newton_schulz: bool = True, device: DeviceLike = None):
    """Orthogonal polar factor of square x by the capped-weight
    all-Cholesky dynamically weighted Halley iteration (module doc).
    For Hermitian x this is the matrix sign function.

    Returns (u, num_iters, converged), the last two Python values.
    Iteration continues until both the l-schedule reaches 1 and the
    iterate stops moving (||u_k - u_{k-1}||_F below the cube root of
    5 eps; cubic convergence makes the kept iterate a full tolerance
    better than the measured difference). A tensor runs where it lies;
    anything else goes to `device` (the card unless named)."""
    u, k, conv, _ = _polar(_vec(x, device), l0, eps,
                           max_iterations, newton_schulz)
    return u, k, conv


def _sign_hermitian(h: torch.Tensor, l0=None):
    u, k, conv, reads = _polar(h, l0=l0)
    return 0.5 * (u + u.mH), k, conv, reads


def sign_hermitian(h, l0: Optional[float] = None,
                   device: DeviceLike = None):
    """Matrix sign of a Hermitian matrix (the spectral-split operator:
    sign(H - sigma I) separates the spectrum at sigma), symmetrized
    to remove the skew part a finite iteration leaves. Returns
    (S, num_iters, converged)."""
    s, k, conv, _ = _sign_hermitian(_vec(h, device), l0)
    return s, k, conv

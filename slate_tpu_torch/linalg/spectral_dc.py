"""Spectral divide & conquer Hermitian eigensolver (counterpart of
``slate_tpu/linalg/spectral_dc.py``).

The algorithm is the reference's, after Nakatsukasa & Higham, "Stable
and efficient spectral divide and conquer algorithms for the symmetric
eigenvalue decomposition and the SVD" (SISC 2013):

  1. split at sigma = the median of the diagonal: S = sign(H - sigma I)
     by the all-Cholesky polar iteration (polar.py); the projector onto
     the lower invariant subspace is P = (I - S) / 2, of rank
     k = round(trace P) clipped to [1, m - 1];
  2. a basis of the smaller-rank projector's range: its columns by
     descending norm (a stable sort), a complete QR, and up to
     ``SUBSPACE_MAXITER - 1`` subspace-iteration refinements while the
     off-diagonal block Q2^H H Q1 exceeds 10 eps ||H||_F;
  3. W = Q^H H Q; its two diagonal blocks are the children, and the
     eigenvector columns of the subproblem become V0 Q;
  4. a block at most ``LEAF`` in size is solved by the library
     eigensolver (``blocked.library_eigh``: in f64 where the card's
     f32 route is cuSOLVER's inaccurate Jacobi solver), a
     near-diagonal or noise-level block takes its diagonal.

The root runs outside the agenda, against the identity basis. Each
subproblem runs at its true size: a LIFO agenda of (offset, size,
block), V0 Q on the true column block, the children cut from W. The
reference's bucket ladder, masked (B, B) windows, margin workspaces
and column rolls give XLA static shapes, which eager PyTorch does not
need; the arithmetic is the same (the padded QR's leading m x m block
is the unpadded QR's).

Host reads: one a polar iteration, one a split (k; the polar flag is
already on the host), one for each subspace test (err) that decides a
refinement, one a near-diagonal test; the leaves' library eigensolver
also checks its status on the host. ``eigh_dc`` returns
``ok``, the AND of every split's polar flag; ``check_polar`` is the
opt-in check the reference runs inside heev under
``SLATE_TPU_CHECK_POLAR=1``. heev does not route here: the reference
reaches this solver from heev's Auto on a TPU only, and the port takes
the reference's off-TPU branch (eig.py).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, NamedTuple, Optional

import torch

from ..utils.backend import DeviceLike
from .blocked import library_eigh
from ..ops.tile_ops import _real_dtype
from .eig import _vec
from .polar import _sign_hermitian

#: subproblems at or below this size stop recursing and solve with the
#: library eigensolver
LEAF = 256

#: subspace-iteration refinements of the projector basis per split
SUBSPACE_MAXITER = 2


class _Split(NamedTuple):
    Q: torch.Tensor     # (m, m) unitary: cols [0, k) span the lower
    #                     invariant subspace, [k, m) the upper
    W: torch.Tensor     # Q^H H Q (block diagonal up to the tolerance)
    k: int              # rank of the lower block
    ok: bool            # the sign iteration converged
    iters: int          # its polar iterations


def _median(d: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian's value: the two middle entries averaged when the
    size is even (low/2 + high/2, as its linear interpolation)."""
    s = torch.sort(d).values
    m = s.shape[0]
    return s[(m - 1) // 2] * 0.5 + s[m // 2] * 0.5


def _count(stats, key, by=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


def _split_spectrum(H: torch.Tensor, l0=None,
                    stats: Optional[Dict[str, int]] = None) -> _Split:
    """One spectral split of the Hermitian block H (module doc, steps
    1-3)."""
    m = H.shape[0]
    dt = H.dtype
    rdt = torch.float64 if dt == torch.float64 else torch.float32
    eps = float(torch.finfo(rdt).eps)
    eye = torch.eye(m, dtype=dt, device=H.device)
    sigma = _median(torch.diagonal(H).real)
    Hs = H - sigma.to(dt) * eye
    hnorm = torch.linalg.norm(H)
    S, iters, conv, reads = _sign_hermitian(Hs, l0=l0)
    _count(stats, "polar_iterations", iters)
    _count(stats, "host_reads", reads + 1)
    P_lo = 0.5 * (eye - S)
    k = int(round(torch.diagonal(P_lo).real.sum().item()))
    k = min(max(k, 1), max(m - 1, 1))
    # the smaller-rank projector gives the basis; the two column
    # ranges swap back afterwards if it was the upper one
    swap = (m - k) < k
    P = 0.5 * (eye + S) if swap else P_lo
    r = m - k if swap else k
    # rank-revealing start: columns of P by descending norm
    cn = (P.abs() ** 2).sum(dim=0)
    X = P[:, torch.argsort(-cn, stable=True)]
    thresh = 10.0 * eps * hnorm

    def qr_pass(X):
        Q, _ = torch.linalg.qr(X, mode="complete")
        err = torch.linalg.norm(Q[:, r:].mH @ H @ Q[:, :r])
        return Q, err

    Q, err = qr_pass(X)
    it = 1
    while it < SUBSPACE_MAXITER:
        _count(stats, "host_reads")
        if not bool(err > thresh):
            break
        # refresh the leading block, re-complete from the rest
        X = torch.cat([P @ Q[:, :r], Q[:, r:]], dim=1)
        Q, err = qr_pass(X)
        _count(stats, "refinements")
        it += 1
    if swap:
        Q = torch.cat([Q[:, r:], Q[:, :r]], dim=1)
    W = Q.mH @ (H @ Q)
    return _Split(Q=Q, W=W, k=k, ok=conv, iters=iters)


def _sym(H: torch.Tensor) -> torch.Tensor:
    return 0.5 * (H + H.mH)


def eigh_dc(h, leaf: int = LEAF, l0=None, device: DeviceLike = None,
            stats: Optional[Dict[str, int]] = None):
    """Full Hermitian eigendecomposition by spectral divide & conquer
    (module doc). Returns (w ascending, V with V[:, i] the eigenvector
    of w[i], ok): `ok` is the AND of every split's polar converged flag
    (a Python bool); False means some sign iteration hit its cap
    without meeting its tolerance and the results may be degraded
    (``check_polar``). A tensor runs where it lies; anything else goes
    to `device` (the card unless named). `stats`, when given a dict,
    receives the counts of splits, leaves, near-diagonal blocks,
    subspace refinements, polar iterations (and the root's apart) and
    host reads."""
    h = _vec(h, device)
    n = h.shape[0]
    dt = h.dtype
    if n <= leaf:
        w, v = library_eigh(_sym(h))
        order = torch.argsort(w, stable=True)
        _count(stats, "leaves")
        return w[order], v[:, order], True
    h = _sym(h)
    eps = float(torch.finfo(_real_dtype(dt)).eps)
    h0norm = torch.linalg.norm(h)
    vals = torch.empty(n, dtype=_real_dtype(dt), device=h.device)
    ok = True

    d0 = torch.diagonal(h).real
    offd0 = torch.linalg.norm(h - torch.diag(d0.to(dt)))
    _count(stats, "host_reads")
    if bool(offd0 <= 5.0 * eps * h0norm):
        vals.copy_(d0)
        V = torch.eye(n, dtype=dt, device=h.device)
        agenda = []
    else:
        spl = _split_spectrum(h, l0, stats)
        _count(stats, "splits")
        if stats is not None:
            stats["root_polar_iterations"] = spl.iters
        ok = ok and spl.ok
        V = spl.Q
        k = spl.k
        agenda = [(0, k, spl.W[:k, :k]), (k, n - k, spl.W[k:, k:])]
    h0n = h0norm
    while agenda:
        off, sz, H = agenda.pop()
        H = _sym(H)
        cols = slice(off, off + sz)
        if sz <= leaf:
            w, Vl = library_eigh(H)
            V[:, cols] = V[:, cols] @ Vl
            vals[cols] = w
            _count(stats, "leaves")
            continue
        hn = torch.linalg.norm(H)
        d = torch.diagonal(H).real
        offd = torch.linalg.norm(H - torch.diag(d.to(dt)))
        _count(stats, "host_reads")
        if bool((offd <= 5.0 * eps * hn) | (hn < eps * h0n)):
            # its diagonal entries are the eigenvalues; the columns of
            # V are already the vectors
            vals[cols] = d
            _count(stats, "diagonal_blocks")
            continue
        spl = _split_spectrum(H, l0, stats)
        _count(stats, "splits")
        ok = ok and spl.ok
        V[:, cols] = V[:, cols] @ spl.Q
        k = spl.k
        agenda.append((off, k, spl.W[:k, :k]))
        agenda.append((off + k, sz - k, spl.W[k:, k:]))
    order = torch.argsort(vals, stable=True)
    return vals[order], V[:, order], ok


#: the environment switch of the reference's heev check
CHECK_POLAR_ENV = "SLATE_TPU_CHECK_POLAR"


def check_polar(ok) -> Optional[bool]:
    """The reference's opt-in polar check (``slate_tpu/linalg/eig.py``,
    heev's spectral D&C branch), for a caller of ``eigh_dc``: with
    ``SLATE_TPU_CHECK_POLAR=1`` it reads `ok`, records
    ``polar.unconverged`` through the metrics registry (counted when
    set, with obs on) and warns when a split's sign iteration did not
    converge. Returns the flag it read, or None with the switch off
    (nothing is read)."""
    if os.environ.get(CHECK_POLAR_ENV) != "1":
        return None
    ok_concrete = bool(ok)
    from ..obs import metrics as obs_metrics
    obs_metrics.flag_concrete("polar.unconverged", not ok_concrete)
    if not ok_concrete:
        warnings.warn(
            "heev: a spectral-D&C split's polar (sign) "
            "iteration hit its iteration cap without "
            "converging; eigenpairs may be degraded "
            "(polar.py capped-weight schedule)", stacklevel=2)
    return ok_concrete

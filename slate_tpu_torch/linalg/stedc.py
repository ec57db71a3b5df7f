"""Divide & conquer tridiagonal eigensolver (counterpart of
``slate_tpu/linalg/stedc.py``; reference src/stedc.cc +
stedc_{deflate,merge,secular,solve,sort,z_vector}.cc).

The tridiagonal is split into 2^k leaves (padded with decoupled
sentinels), the leaves are solved by one batched library eigensolver
(``blocked.library_eigh``), and each level merges all its equal-size pairs
by the Cuppen rank-one update T = diag(T1', T2') + rho v v^T, batched
over a leading dimension where the reference vmaps:

- stedc_z_vector: z from the adjacent rows of the two eigenvector
  blocks;
- stedc_sort: ascending sort of (D, z);
- stedc_deflate / _deflate_rotation_fused: tiny-|z| entries deflate as
  exact eigenpairs, near-tied poles are decoupled by a Givens rotation
  recorded for the back-transform; one sequential scan (a Python loop
  over the entries, vectorized over the batch) also composes the
  rotations into one matrix;
- stedc_secular: every retained root of
  1 + rho sum z_i^2 / (d_i - lambda) = 0 by lockstep bisection (f64: 80
  passes; f32: 30 bisections and 8 safeguarded Newton passes),
  eigenvectors by the Gu/Eisenstat recomputed z-hat;
- stedc_merge: the back-transform by the block-diagonal eigenvectors,
  the sort, the rotations and the secular eigenvectors.

At the reference's ``_on_tpu()`` site (the leaves) the port takes the
branch the reference takes off the TPU: the library's batched
eigensolver.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.tiles import ceil_div, next_pow2
from .blocked import library_eigh

#: secular-iteration schedule (the reference's, per type)
_BISECT_ITERS_F32 = 30
_NEWTON_ITERS_F32 = 8
_BISECT_ITERS_F64 = 80


def _batched(*xs):
    """Add a leading batch dimension to 1-D inputs; the flag says to
    drop it again."""
    if xs[0].dim() == 1:
        return True, tuple(x[None] for x in xs)
    return False, xs


def _rho(rho, like: torch.Tensor) -> torch.Tensor:
    """rho as a (B,) tensor of like's type and device."""
    r = torch.as_tensor(rho, dtype=like.dtype, device=like.device)
    return r.reshape(-1).expand(like.shape[0])


def stedc_z_vector(V1: torch.Tensor, V2: torch.Tensor) -> torch.Tensor:
    """z = [last row of V1, first row of V2]^T (reference
    stedc_z_vector.cc), per element of a leading batch."""
    return torch.cat([V1[..., -1, :], V2[..., 0, :]], dim=-1)


def stedc_sort(D: torch.Tensor, z: torch.Tensor):
    """Ascending sort of the merged spectrum (reference stedc_sort.cc).
    Returns (D_sorted, z_sorted, permutation)."""
    perm = torch.argsort(D, dim=-1, stable=True)
    return D.gather(-1, perm), z.gather(-1, perm), perm


class Deflation(NamedTuple):
    """Static-shape deflation result (reference stedc_deflate.cc /
    LAPACK dlaed2 compaction, as masks and a rotation log)."""
    d: torch.Tensor            # (n,) poles, modified by tie rotations
    z: torch.Tensor            # (n,) z vector, zeroed at deflated entries
    keep: torch.Tensor         # (n,) bool: True = retained in secular eq
    rot_accept: torch.Tensor   # (n,) bool: step t rotated plane (pj[t], t)
    rot_pj: torch.Tensor       # (n,) int partner column of step t
    rot_c: torch.Tensor        # (n,) cosine
    rot_s: torch.Tensor        # (n,) sine
    keep0: torch.Tensor        # (n,) bool: pre-rotation tiny-z retention


def _deflation_tol(D: torch.Tensor, z: torch.Tensor, rho) -> torch.Tensor:
    eps = torch.finfo(D.dtype).eps
    znorm2 = (z * z).sum(-1)
    return 8.0 * eps * torch.maximum(D.abs().amax(-1), rho.abs() * znorm2)


def _deflate_rotation_fused(D: torch.Tensor, z: torch.Tensor, rho
                            ) -> Tuple[Deflation, torch.Tensor]:
    """Deflate the sorted rank-one update diag(D) + rho z z^T (reference
    stedc_deflate.cc; LAPACK dlaed2) and compose the recorded rotations
    into one orthogonal matrix G, in ONE scan over the entries (the
    reference's fused scan; the rotation chain shares the deflation's
    partner state). Inputs (n,) or (B, n) with rho scalar or (B,);
    returns (Deflation, G) with G (n, n) or (B, n, n)."""
    squeeze, (D, z) = _batched(D, z)
    B, n = D.shape
    dt, dev = D.dtype, D.device
    rho = _rho(rho, D)
    tol = _deflation_tol(D, z, rho)
    znorm = torch.sqrt((z * z).sum(-1))
    keep0 = rho.abs()[:, None] * z.abs() * znorm[:, None] > tol[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    zz = torch.where(keep0, z, zero)
    d = D.clone()
    keep = keep0.clone()
    pj = torch.zeros((B, 1), dtype=torch.long, device=dev)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    alpha = torch.zeros((B, n), dtype=dt, device=dev)
    eye = torch.eye(n, dtype=dt, device=dev)
    recs = []
    for nj in range(n):
        knj = keep[:, nj]
        zpj = zz.gather(1, pj)[:, 0]
        znj = zz[:, nj]
        tau = torch.sqrt(zpj * zpj + znj * znj)
        tau_safe = torch.where(tau == 0, one, tau)
        c = torch.where(tau > 0, znj / tau_safe, one)
        s = torch.where(tau > 0, -zpj / tau_safe, zero)
        dpj = d.gather(1, pj)[:, 0]
        dnj = d[:, nj].clone()
        do_rot = knj & have & ((dnj - dpj) * c * s).abs().le(tol)
        zz[:, nj] = torch.where(do_rot, tau, znj)
        zz.scatter_(1, pj, torch.where(do_rot, zero,
                                       zz.gather(1, pj)[:, 0])[:, None])
        keep.scatter_(1, pj, (keep.gather(1, pj)[:, 0] & ~do_rot)[:, None])
        d.scatter_(1, pj, torch.where(do_rot, dpj * c * c + dnj * s * s,
                                      dpj)[:, None])
        d[:, nj] = torch.where(do_rot, dpj * s * s + dnj * c * c,
                               d[:, nj])
        # the rotation-matrix chain, on this step's (pj, have, c, s)
        e_t = eye[nj]
        flush = knj & ~do_rot & have
        tiny = ~knj
        col = torch.where(do_rot[:, None], c[:, None] * alpha
                          + s[:, None] * e_t,
                          torch.where(flush[:, None], alpha, e_t))
        idx = torch.where(tiny, nj, pj[:, 0])
        alpha = torch.where(knj[:, None],
                            torch.where(do_rot[:, None],
                                        -s[:, None] * alpha
                                        + c[:, None] * e_t, e_t), alpha)
        recs.append((do_rot, pj[:, 0], c, s, idx, col,
                     do_rot | flush | tiny))
        pj = torch.where(knj, nj, pj[:, 0])[:, None]
        have = have | knj
    acc, pjs, cs, ss, idxs, cols, dos = (torch.stack(x, dim=1)
                                         for x in zip(*recs))
    G = torch.zeros((B, n, n), dtype=dt, device=dev)
    G.scatter_add_(2, idxs[:, None, :].expand(B, n, n),
                   (cols * dos[..., None].to(dt)).transpose(1, 2))
    G.scatter_add_(2, pj[:, None, :].expand(B, n, 1),
                   (alpha * have[:, None].to(dt))[..., None])
    defl = Deflation(d=d, z=zz, keep=keep, rot_accept=acc, rot_pj=pjs,
                     rot_c=cs, rot_s=ss, keep0=keep0)
    if squeeze:
        return Deflation(*(x[0] for x in defl)), G[0]
    return defl, G


def stedc_deflate(D: torch.Tensor, z: torch.Tensor, rho) -> Deflation:
    """Deflate the sorted rank-one update diag(D) + rho z z^T (reference
    stedc_deflate.cc / LAPACK dlaed2): tiny |z_i| make (d_i, e_i) an
    eigenpair (z_i := 0); a tie d_pj ~ d_nj is decoupled by a Givens
    rotation that zeroes z_pj, recorded for the back-transform. The
    fused scan's deflation (the reference pins the two bitwise
    equal)."""
    return _deflate_rotation_fused(D, z, rho)[0]


def stedc_rotation_matrix(defl: Deflation) -> torch.Tensor:
    """Compose the recorded deflation rotations into ONE orthogonal
    matrix G (Q <- Q @ G), by the reference's scan over the steps
    carrying the current partner column alpha; each step finalizes at
    most one column."""
    n = defl.rot_accept.shape[-1]
    dt, dev = defl.d.dtype, defl.d.device
    eye = torch.eye(n, dtype=dt, device=dev)
    alpha = torch.zeros(n, dtype=dt, device=dev)
    G = torch.zeros((n, n), dtype=dt, device=dev)
    pj, have = 0, False
    for t in range(n):
        acc = bool(defl.rot_accept[t])
        kt = bool(defl.keep0[t])
        c, s = defl.rot_c[t], defl.rot_s[t]
        if acc:
            G[:, pj] += c * alpha + s * eye[t]
        elif kt and have:
            G[:, pj] += alpha
        elif not kt:
            G[:, t] += eye[t]
        if kt:
            alpha = -s * alpha + c * eye[t] if acc else eye[t]
            pj, have = t, True
    if have:
        G[:, pj] += alpha
    return G


def stedc_rotate(Q: torch.Tensor, defl: Deflation) -> torch.Tensor:
    """Apply the recorded deflation rotations to the columns of Q
    (reference drot calls in stedc_deflate.cc), as one product with the
    composed rotation matrix."""
    return Q @ stedc_rotation_matrix(defl).to(Q.dtype)


def stedc_secular(D: torch.Tensor, z: torch.Tensor, rho,
                  keep: torch.Tensor):
    """The retained roots of the secular equation (reference
    stedc_secular.cc) by lockstep bisection, each root solved relative
    to the pole nearest it (LAPACK dlaed4's shifted origin), in the
    gap to the next retained pole (the previous one for rho < 0).
    Returns (lam, U), U the eigenvectors of diag(D) + rho z z^T;
    deflated positions carry lam_i = d_i and an identity column.
    Inputs (n,) or batched (B, n) with rho scalar or (B,)."""
    squeeze, (D, z, keep) = _batched(D, z, keep)
    B, n = D.shape
    dt, dev = D.dtype, D.device
    rho = _rho(rho, D)
    tiny = torch.finfo(dt).tiny
    pos = (rho > 0)[:, None]
    ids = torch.arange(n, device=dev).expand(B, n)
    full = torch.full((B, 1), n, dtype=torch.long, device=dev)
    suf = torch.cummin(torch.where(keep, ids, n).flip(-1), -1).values.flip(-1)
    nxt = torch.cat([suf[:, 1:], full], dim=-1)
    pre = torch.cummax(torch.where(keep, ids, -1), -1).values
    prv = torch.cat([-torch.ones_like(full), pre[:, :-1]], dim=-1)
    znorm2 = (z * z).sum(-1)
    Dnxt = D.gather(-1, nxt.clamp(0, n - 1))
    Dprv = D.gather(-1, prv.clamp(0, n - 1))
    rz = (rho * znorm2)[:, None]
    zeros = torch.zeros((B, n), dtype=dt, device=dev)
    gap_up = torch.maximum(torch.where(nxt < n, Dnxt - D, rz), zeros)
    gap_dn = torch.minimum(torch.where(prv >= 0, Dprv - D, rz), zeros)
    s = torch.where(pos, 1.0, -1.0).to(dt)[:, :, None]
    z2 = (z * z)[:, :, None]
    rho3 = rho[:, None]

    def g_delta(delta_o, mu):
        # delta_o[b, i, k] = d_i - d_origin_k; s*g increasing in mu
        denom = delta_o - mu[:, None, :]
        safe = torch.where(denom == 0, tiny, denom)
        return s[:, 0] * (1.0 + rho3 * (z2 / safe).sum(1))

    far = torch.where(pos, nxt.clamp(0, n - 1), prv.clamp(0, n - 1))
    has_far = torch.where(pos, nxt < n, prv >= 0)
    half = torch.where(pos, 0.5 * gap_up, 0.5 * gap_dn)
    near_low = g_delta(D[:, :, None] - D[:, None, :], half) > 0
    use_k = torch.where(pos, near_low, ~near_low) | ~has_far
    origin = torch.where(use_k, ids, far)
    lo = torch.where(pos, torch.where(use_k, zeros, -gap_up),
                     torch.where(use_k, gap_dn, zeros))
    hi = torch.where(pos, torch.where(use_k, gap_up, zeros),
                     torch.where(use_k, zeros, -gap_dn))
    origin = torch.where(keep, origin, ids)
    delta = D[:, :, None] - D.gather(-1, origin)[:, None, :]

    def bisect(lo, hi, passes):
        for _ in range(passes):
            mid = 0.5 * (lo + hi)
            neg = g_delta(delta, mid) < 0
            lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
        return lo, hi

    if dt == torch.float64:
        lo, hi = bisect(lo, hi, _BISECT_ITERS_F64)
        mu = torch.where(keep, 0.5 * (lo + hi), zeros)
    else:
        lo, hi = bisect(lo, hi, _BISECT_ITERS_F32)
        # safeguarded Newton: a step that leaves the bracket is replaced
        # by the midpoint; the root is the last evaluated point
        cand = 0.5 * (lo + hi)
        for _ in range(_NEWTON_ITERS_F32):
            mid = 0.5 * (lo + hi)
            denom = delta - mid[:, None, :]
            safe = torch.where(denom == 0, tiny, denom)
            frac = z2 / safe
            g = s[:, 0] * (1.0 + rho3 * frac.sum(1))
            gp = rho3.abs() * (frac / safe).sum(1)
            lo, hi = torch.where(g < 0, mid, lo), torch.where(g < 0, hi, mid)
            step = torch.where(gp > 0, -g / torch.where(gp == 0, 1.0, gp),
                               zeros)
            cand = mid + step
            cand = torch.where((cand > lo) & (cand < hi), cand,
                               0.5 * (lo + hi))
            neg = g_delta(delta, cand) < 0
            lo, hi = torch.where(neg, cand, lo), torch.where(neg, hi, cand)
        mu = torch.where(keep, cand, zeros)
    lam, U = _secular_finish(D, z, rho, keep, origin, delta, mu)
    return (lam[0], U[0]) if squeeze else (lam, U)


def _secular_finish(D, z, rho, keep, origin, delta, mu):
    """The tail of stedc_secular: eigenvalues from the shifted roots and
    the Gu/Eisenstat recomputed z-hat eigenvectors,
    rho zhat_i^2 = prod_{k in R} (lam_k - d_i)
                 / prod_{k in R, k != i} (d_k - d_i),
    products over the retained set R in log space."""
    n = D.shape[-1]
    dt, dev = D.dtype, D.device
    tiny = torch.finfo(dt).tiny
    lam = D.gather(-1, origin) + mu
    keepf = keep.to(dt)[:, None, :]
    denom = delta - mu[:, None, :]                     # d_i - lam_k
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    diff_d = torch.where(eye, 1.0, D[:, None, :] - D[:, :, None]).to(dt)
    lognum = (keepf * torch.log(denom.abs() + tiny)).sum(-1)
    logden = (keepf * (~eye) * torch.log(diff_d.abs() + tiny)).sum(-1)
    logmag = 0.5 * (lognum - logden
                    - torch.log(rho.abs() + tiny)[:, None])
    sgn = torch.where(z >= 0, 1.0, -1.0).to(dt)
    zhat = sgn * torch.exp(logmag)
    zhat = torch.where(torch.isfinite(zhat) & (zhat != 0), zhat, z)
    zhat = torch.where(keep, zhat, torch.zeros((), dtype=dt, device=dev))
    safe = torch.where(denom.abs() < tiny, tiny, denom)
    U = zhat[:, :, None] / safe
    norms = torch.sqrt((U * U).sum(1))
    U = U / torch.where(norms == 0, 1.0, norms)[:, None, :]
    U = torch.where(keep[:, None, :], U, eye.to(dt))
    return lam, U


def stedc_merge(D1, V1, D2, V2, rho, product=None):
    """Merge two solved subproblems across a rank-one coupling
    (reference stedc_merge.cc), per element of a leading batch (the
    reference vmaps it). Returns (w, V) ascending. `product` forms the
    back-transform's two matrix products of an unbatched merge (the
    grid's dist.stedc.matmul_sharded); default the batched product."""
    squeeze, (D1, V1, D2, V2) = _batched(D1, V1, D2, V2)
    D = torch.cat([D1, D2], dim=-1)
    z = stedc_z_vector(V1, V2)
    Ds, zs, perm = stedc_sort(D, z)
    defl, G = _deflate_rotation_fused(Ds, zs, rho)
    lam, U = stedc_secular(defl.d, defl.z, rho, defl.keep)
    # back-transform: V = (blkdiag(V1, V2)[:, perm]) @ (G @ U)
    B, n1, n = D1.shape[0], D1.shape[-1], D.shape[-1]
    Q = torch.zeros((B, n, n), dtype=V1.dtype, device=V1.device)
    Q[:, :n1, :n1] = V1
    Q[:, n1:, n1:] = V2
    Q = Q.gather(-1, perm[:, None, :].expand(B, n, n))
    if product is None:
        V = Q @ (G @ U)
    else:
        V = torch.stack([product(q, product(g, u))
                         for q, g, u in zip(Q, G, U)])
    order = torch.argsort(lam, dim=-1, stable=True)
    w = lam.gather(-1, order)
    V = V.gather(-1, order[:, None, :].expand(B, n, n))
    return (w[0], V[0]) if squeeze else (w, V)


def stedc_split(d: torch.Tensor, e: torch.Tensor, leaf: int):
    """The split phase (reference stedc_solve.cc:97,162-171): pad to
    nl = 2^k leaves with decoupled sentinel diagonals above the
    Gershgorin bound (proportional to the spectrum's scale), and apply
    every Cuppen boundary adjustment d[b-1] -= rho, d[b] -= rho up
    front. Returns (dp, ep, N, nl)."""
    n = d.shape[0]
    dt, dev = d.dtype, d.device
    nl = next_pow2(ceil_div(n, leaf))
    N = nl * leaf
    emax = e.abs().max() if n > 1 else torch.zeros((), dtype=dt, device=dev)
    scale = d.abs().max() + 4.0 * emax
    scale = torch.where(scale > 0, scale, torch.ones((), dtype=dt,
                                                     device=dev))
    k = N - n
    sent = scale * (2.0 + torch.arange(1, k + 1, dtype=dt, device=dev)
                    / max(k, 1))
    dp = torch.cat([d, sent])
    ep = torch.cat([e, torch.zeros(N - n + 1, dtype=dt, device=dev)])
    bs = torch.arange(leaf, N, leaf, device=dev)
    rhos = ep[bs - 1]
    dp = dp.index_add(0, bs - 1, -rhos).index_add(0, bs, -rhos)
    return dp, ep, N, nl


def stedc_leaves(dblk: torch.Tensor, eblk: torch.Tensor):
    """The batched leaf solve: (nl, leaf) tridiagonals -> ascending
    (w (nl, leaf), V (nl, leaf, leaf)) by one batched library
    eigensolver. The reference runs lockstep QR sweeps on a TPU
    (stedc.py:528); the card is not one, so the port takes its other
    branch."""
    tmat = torch.diag_embed(dblk) + torch.diag_embed(eblk, -1) \
        + torch.diag_embed(eblk, 1)
    w, V = library_eigh(tmat)
    order = torch.argsort(w, dim=-1, stable=True)
    return (w.gather(-1, order),
            V.gather(-1, order[:, None, :].expand_as(V)))


def stedc_solve(d: torch.Tensor, e: torch.Tensor, leaf: int = 32):
    """Level-by-level D&C driver (reference stedc_solve.cc): split,
    solve the leaves as one batch, then merge all same-size pairs of a
    level as one batch per level. Returns (w, V) of the symmetric
    tridiagonal (d, e)."""
    d, e = torch.as_tensor(d), torch.as_tensor(e)
    n = d.shape[0]
    if n <= leaf:
        t = torch.diag(d)
        if n > 1:
            t = t + torch.diag(e, -1) + torch.diag(e, 1)
        w, v = library_eigh(t)
        order = torch.argsort(w, stable=True)
        return w[order], v[:, order]
    dp, ep, N, nl = stedc_split(d, e, leaf)
    w, V = stedc_leaves(dp.reshape(nl, leaf),
                        ep[:N].reshape(nl, leaf)[:, :-1])
    s = leaf
    while s < N:
        rhos = ep[torch.arange(s, N, 2 * s, device=d.device) - 1]
        w, V = stedc_merge(w[0::2], V[0::2], w[1::2], V[1::2], rhos)
        s *= 2
    return w[0][:n], V[0][:n, :n]

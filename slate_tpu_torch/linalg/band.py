"""Band bulge chases (counterpart of the stage-2 part of
``slate_tpu/linalg/band.py``): ``hb2st_band`` (Hermitian band ->
tridiagonal) and ``tb2bd_band`` (upper triangular band -> bidiagonal),
the windowed reductions eig.hb2st and svd.tb2bd take.

Each is a sequence of about n ceil(n/kd) small steps: a complete QR of
a (kd, kd) block (``torch.linalg.qr``) applied two-sidedly on a
3 kd-wide window of a zero-padded copy P of the band. The zero padding
makes the chase steps that fall past the matrix QRs of zero blocks,
which give exactly I, as in the reference. The steps update P in place
where the reference updates slices functionally (the same values).

The rest of the reference's band module (pbtrf / gbtrf / tbsm and the
band BLAS) is not ported: its entry points raise (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tiles import ceil_div


def _qr_q(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(x, mode="complete").Q


def _layout(n: int, kd: int):
    """Window width w, chase steps per sweep and the padded size."""
    w = max(kd, 1)
    tmax = ceil_div(max(n - 1, 1), w) + 1
    return w, tmax, (tmax + 4) * w + n


def hb2st_band(a: torch.Tensor, n: int, kd: int, want_q: bool):
    """Band (width kd) -> tridiagonal by windowed block bulge chasing
    (reference src/hb2st.cc sweeps; Lang's SBR stage-2 scheme). Sweep
    j: a length-kd reflector block zeroes column j below the first
    subdiagonal; the two-sided application spills a kd x kd bulge one
    band-width down, chased off the end by per-step QRs of the bulge.
    A final diagonal phase similarity makes the subdiagonal real and
    nonnegative. Returns (d, e, q) with band = q T q^H (q None without
    want_q)."""
    w, tmax, size = _layout(n, kd)
    dev, dt = a.device, a.dtype
    full = torch.tril(a[:n, :n]) + torch.tril(a[:n, :n], -1).mH
    # embedded at offset w so the first sweep's window never clips
    P = torch.zeros((size, size), dtype=dt, device=dev)
    P[w:w + n, w:w + n] = full
    q = torch.zeros((n, size), dtype=dt, device=dev)
    if want_q:
        q[:, w:w + n] = torch.eye(n, dtype=dt, device=dev)

    def apply(qmat, b):
        """Rows and columns [b, b+w) <- qmat^H . qmat over the 3w
        window from b-w; q's columns [b, b+w) <- . qmat."""
        Z = P[b - w:b + 2 * w, b - w:b + 2 * w]
        Z[w:2 * w, :] = qmat.mH @ Z[w:2 * w, :]
        Z[:, w:2 * w] = Z[:, w:2 * w] @ qmat
        if want_q:
            q[:, b:b + w] = q[:, b:b + w] @ qmat

    for jl in range(max(n - 2, 0)):
        j = jl + w
        apply(_qr_q(P[j + 1:j + 1 + w, j:j + 1]), j + 1)
        for t in range(1, tmax):
            b = j + 1 + t * w
            apply(_qr_q(P[b:b + w, b - w:b]), b)
    d = torch.diagonal(P)[w:w + n].real
    esub = torch.diagonal(P, -1)[w:w + max(n - 1, 0)]
    mag = esub.abs()
    one = torch.ones((), dtype=mag.dtype, device=dev)
    phase = torch.where(mag == 0, one.to(dt),
                        esub / torch.where(mag == 0, one, mag))
    dphase = torch.cat([torch.ones(1, dtype=dt, device=dev),
                        torch.cumprod(phase, 0)])
    e = mag.to(d.dtype)
    if want_q:
        return d, e, q[:, w:w + n] * dphase[None, :]
    return d, e, None


def tb2bd_band(a: torch.Tensor, n: int, kd: int, want_uv: bool):
    """Upper triangular band (width kd) -> upper bidiagonal by windowed
    bulge chasing (reference src/tb2bd.cc wavefront), with separate
    left and right transform streams (B' = U^H B V). Sweep j: a right
    reflector block compresses row j's tail onto the superdiagonal, a
    left QR restores the diagonal block it filled and spills a bulge
    one band-width right; the chase alternates right (QR of the bulge's
    adjoint) and left (QR of the refilled diagonal block) until the
    bulge falls into the zero padding. Returns (d, e, u, vh) with
    band = u bidiag(d, e) vh, d and e real nonnegative (the phases go
    into u and vh); u, vh None without want_uv."""
    w, tmax, size = _layout(n, kd)
    dev, dt = a.device, a.dtype
    P = torch.zeros((size, size), dtype=dt, device=dev)
    P[w:w + n, w:w + n] = torch.triu(a[:n, :n])
    u = torch.zeros((n, size), dtype=dt, device=dev)
    vh = torch.zeros((size, n), dtype=dt, device=dev)
    if want_uv:
        u[:, w:w + n] = torch.eye(n, dtype=dt, device=dev)
        vh[w:w + n, :] = torch.eye(n, dtype=dt, device=dev)

    def right(V, b):
        """Columns [b, b+w) <- . V over the 3w row window from b-w;
        vh's rows [b, b+w) <- V^H ."""
        P[b - w:b + 2 * w, b:b + w] = P[b - w:b + 2 * w, b:b + w] @ V
        if want_uv:
            vh[b:b + w, :] = V.mH @ vh[b:b + w, :]

    def left(Q, b):
        """Rows [b, b+w) <- Q^H . over the 3w column window from b-w;
        u's columns [b, b+w) <- . Q."""
        P[b:b + w, b - w:b + 2 * w] = Q.mH @ P[b:b + w, b - w:b + 2 * w]
        if want_uv:
            u[:, b:b + w] = u[:, b:b + w] @ Q

    for jl in range(max(n - 1, 0)):
        j = jl + w
        b0 = j + 1
        # compress row j's tail onto the superdiagonal (a vector QR)
        right(_qr_q(P[j:j + 1, b0:b0 + w].mH), b0)
        left(_qr_q(P[b0:b0 + w, b0:b0 + w]), b0)
        for t in range(1, tmax):
            b = b0 + t * w
            right(_qr_q(P[b - w:b, b:b + w].mH), b)
            left(_qr_q(P[b:b + w, b:b + w]), b)
    alpha = torch.diagonal(P)[w:w + n]
    beta = torch.diagonal(P, 1)[w:w + max(n - 1, 0)]
    dls, drs = _bidiag_phases(alpha, beta)
    d, e = alpha.abs(), beta.abs()
    if want_uv:
        # B_c = conj(Dl) D Dr, so u B_c vh = (u conj(Dl)) D (Dr vh)
        return (d, e, u[:, w:w + n] * dls.conj()[None, :],
                drs[:, None] * vh[w:w + n, :])
    return d, e, None, None


def _bidiag_phases(alpha: torch.Tensor, beta: torch.Tensor):
    """Unimodular diagonals Dl, Dr with Dl B Dr^H = bidiag(|alpha|,
    |beta|), by the reference's recurrence (dl_0 = 1,
    dr_k = phase(dl_k alpha_k),
    dl_{k+1} = phase(dl_k beta_k) conj(phase(alpha_{k+1}))): n scalar
    steps, on the host."""
    al = alpha.detach().cpu().numpy()
    be = beta.detach().cpu().numpy()
    n = al.shape[0]
    one = al.dtype.type(1)

    def phase(x):
        m = abs(x)
        return one if m == 0 else x / m

    dls = np.empty(n, al.dtype)
    drs = np.empty(n, al.dtype)
    dl = one
    for k in range(n):
        dls[k] = dl
        drs[k] = phase(dl * al[k])
        bk = be[k] if k < n - 1 else one
        dl = phase(dl * bk) * np.conj(phase(al[min(k + 1, n - 1)]))
    return (torch.from_numpy(dls).to(alpha.device),
            torch.from_numpy(drs).to(alpha.device))

"""Band algorithms (counterpart of ``slate_tpu/linalg/band.py``): the
windowed band factorizations and solves (``pbtrf_band``,
``gbtrf_band``, ``band_trsm_lower`` / ``band_trsm_upper``,
``gb_forward_solve`` / ``gb_backward_solve_trans``), the batched window
product ``band_mm``, the band-vs-dense crossover, and the bulge chases
``hb2st_band`` (Hermitian band -> tridiagonal) and ``tb2bd_band``
(upper triangular band -> bidiagonal) that eig.hb2st and svd.tb2bd
take.

Storage is the dense padded tile layout (band entries in place, zeros
outside), as in the reference. The factorizations and solves work on
one identity-padded copy of the matrix, so the trailing window always
fits; the reference's ``fori_loop`` over fixed windows is a Python loop
over block steps here, each step updating slices of that copy in place
(the same values as the reference's functional slice updates). The
row swaps of a block step (the reference's per-row swap loops) are
composed into one permutation of the window by ``lu._compose_swaps``
(on the card, the ``compose_swaps`` kernel) and applied as one gather;
an unswap applies its inverse. The nb x nb triangular inverses are
``blocked.invert_triangular`` and the diagonal Cholesky blocks
``blocked.chol_diag_factor``, library calls as the reference's are
XLA's.

The chases are sequences of about n ceil(n/kd) small steps: a complete
QR of a (kd, kd) block (``torch.linalg.qr``) applied two-sidedly on a
3 kd-wide window of a zero-padded copy P of the band. The zero padding
makes the chase steps that fall past the matrix QRs of zero blocks,
which give exactly I, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tiles import ceil_div, round_up


def band_width_of(A) -> int:
    """Effective half-bandwidth recorded on a TiledMatrix (0 if none)."""
    return max(A.kl if A.kl >= 0 else 0, A.ku if A.ku >= 0 else 0)


def band_is_narrow(n: int, nb: int, width: int) -> bool:
    """The band-vs-dense crossover shared by pbtrf/pbtrs, gbtrf/gbtrs
    and tbsm: the windowed O(n width^2) algorithms run when the
    (width-rounded + nb) window is at most half the matrix."""
    return width >= 0 and (round_up(max(width, 1), nb) + nb) * 2 <= n


def _pad_identity_to(a: torch.Tensor, size: int) -> torch.Tensor:
    """Embed an (N, N) matrix in a (size, size) one with identity past
    N (a new tensor)."""
    n = a.shape[0]
    out = torch.zeros((size, size), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    out.diagonal()[n:] = 1
    return out


def _pad_rows(b: torch.Tensor, size: int) -> torch.Tensor:
    """(size, nrhs) copy of b, zero past its rows."""
    out = torch.zeros((size, b.shape[1]), dtype=b.dtype, device=b.device)
    out[:b.shape[0]] = b
    return out


def _window_copy(x: torch.Tensor, m: int, k: int, count: int,
                 step_r: int, step_c: int, off_r: int, off_c: int,
                 rows: int, cols: int) -> torch.Tensor:
    """(count, rows, cols) copy of windows of x's logical (m, k) part:
    window t starts at (t step_r + off_r, t step_c + off_c), zero where
    it leaves (m, k). The windows that lie inside come as one strided
    view of x, copied once; the few that cross an edge are copied one
    by one. Nothing else of x is read."""
    out = x.new_empty((count, rows, cols))

    def corner(t):
        return t * step_r + off_r, t * step_c + off_c

    inside = [t for t in range(count)
              if min(corner(t)) >= 0 and corner(t)[0] + rows <= m
              and corner(t)[1] + cols <= k]
    lo, hi = (inside[0], inside[-1] + 1) if inside else (0, 0)
    if hi > lo:
        sr, sc = x.stride()
        r0, c0 = corner(lo)
        out[lo:hi] = x.as_strided(
            (hi - lo, rows, cols), (step_r * sr + step_c * sc, sr, sc),
            x.storage_offset() + r0 * sr + c0 * sc)
    for t in (*range(lo), *range(hi, count)):
        out[t] = 0
        r0, c0 = corner(t)
        ra, ca = max(0, -r0), max(0, -c0)
        rb, cb = min(rows, m - r0), min(cols, k - c0)
        if ra < rb and ca < cb:
            out[t, ra:rb, ca:cb] = x[r0 + ra:r0 + rb, c0 + ca:c0 + cb]
    return out


def _keep(win: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Zero every entry (r, c) of each window but lo <= c - r <= hi."""
    r = torch.arange(win.shape[-2], device=win.device)[:, None]
    c = torch.arange(win.shape[-1], device=win.device)[None, :]
    return win.masked_fill_((c - r < lo) | (c - r > hi), 0)


def band_windows(a: torch.Tensor, m: int, k: int, kl: int, ku: int,
                 nb: int, uplo=None) -> torch.Tensor:
    """The (nt, nb, kl + nb + ku) block-row windows of the band of the
    logical (m, k) matrix stored in `a`: window t holds rows
    [t nb, t nb + nb) and columns [t nb - kl, t nb + nb + ku), zero
    outside the band and the matrix. Only the windows are read. With
    `uplo` (Hermitian band, kl = ku) only that triangle is stored: the
    other is its conjugate transpose, read as column windows, and the
    diagonal is real, as ``TiledMatrix.to_dense`` mirrors it."""
    from ..core.enums import Uplo
    nt = ceil_div(max(m, 1), nb)
    W = kl + nb + ku
    if uplo is None:
        return _keep(_window_copy(a, m, k, nt, nb, nb, 0, -kl, nb, W),
                     0, kl + ku)
    kd = kl
    win = a.new_zeros((nt, nb, W))
    if uplo is Uplo.Lower:
        own = _keep(_window_copy(a, m, k, nt, nb, nb, 0, -kd, nb, kd + nb),
                    0, kd)
        diag, own_at = kd, slice(0, kd + nb)
        mirror = _keep(_window_copy(a, m, k, nt, nb, nb, 0, 0, kd + nb,
                                    nb), -kd, -1)
        mirror_at = slice(kd, W)
    else:
        own = _keep(_window_copy(a, m, k, nt, nb, nb, 0, 0, nb, nb + kd),
                    0, kd)
        diag, own_at = 0, slice(kd, W)
        mirror = _keep(_window_copy(a, m, k, nt, nb, nb, -kd, 0, kd + nb,
                                    nb), 1 - kd, 0)
        mirror_at = slice(0, kd + nb)
    if own.is_complex():
        own.diagonal(diag, -2, -1).imag.zero_()
    win[..., own_at] = own
    win[..., mirror_at] += mirror.mH
    return win


def band_mm(a: torch.Tensor, kl: int, ku: int, b: torch.Tensor,
            nb: int, shape=None, uplo=None) -> torch.Tensor:
    """C = A @ B with A banded (kl below / ku above the diagonal),
    given dense-with-zeros A (m, k) and dense B (k, p) (reference
    gbmm/hbmm, src/gbmm.cc). Block row i of C touches only A's columns
    [i nb - kl, i nb + nb + ku): every block-row window of A (nt, nb, W)
    (``band_windows``) and the matching row window of B (nt, W, p),
    W = kl + nb + ku, go into ONE batched product (``torch.bmm``):
    O(m W p) operations instead of the dense O(m k p), and only the
    windows are read. `shape` gives A's logical (m, k) when `a` is
    padded storage (a TiledMatrix's data), `uplo` the stored triangle of
    a Hermitian band. A plain product outside any kernel of the
    reference, so the library serves."""
    m, kdim = shape if shape is not None else a.shape
    awin = band_windows(a, m, kdim, kl, ku, nb, uplo)
    nt, _, W = awin.shape
    p = b.shape[1]
    bwin = _window_copy(b, kdim, p, nt, nb, 0, -kl, 0, W, p)
    return torch.bmm(awin, bwin).reshape(nt * nb, p)[:m]


def pbtrf_band(a: torch.Tensor, n: int, nb: int, kd: int) -> torch.Tensor:
    """Lower Cholesky of an SPD band matrix given as dense padded
    (N, N) with bandwidth kd (reference src/pbtrf.cc): per block step,
    factor the nb diagonal block, solve the in-band panel (only kd rows
    are nonzero), update the trailing (kd x kd) window. Cost
    O(n kd (nb + kd))."""
    from .blocked import chol_diag_factor, invert_triangular
    w = round_up(max(kd, 1), nb)            # in-band rows below the block
    W = nb + w
    steps = ceil_div(max(n, 1), nb)
    work = _pad_identity_to(a, steps * nb + W)
    for k in range(steps):
        o = k * nb
        win = work[o:o + W, o:o + W]
        lkk = chol_diag_factor(win[:nb, :nb])
        inv = invert_triangular(lkk, lower=True)
        pan = win[nb:, :nb] @ inv.mH
        win[nb:, nb:] -= pan @ pan.mH
        win[nb:, :nb] = pan
        win[:nb, :nb] = torch.tril(lkk)
        win[:nb, nb:] = 0
    N = a.shape[0]
    return torch.tril(work[:N, :N])


def band_trsm_lower(l: torch.Tensor, b: torch.Tensor, n: int, nb: int,
                    kd: int, unit_diagonal: bool = False,
                    conj_trans: bool = False) -> torch.Tensor:
    """Solve L X = B (or L^H X = B with conj_trans) where L is lower
    triangular with bandwidth kd, dense-stored: blocked substitution
    whose update touches only the kd in-band rows, O(n kd nrhs);
    conj_trans runs the sweep backwards on the conjugate transpose's
    windows."""
    from .blocked import invert_triangular
    w = round_up(max(kd, 1), nb)
    W = nb + w
    steps = ceil_div(max(n, 1), nb)
    size = steps * nb + W
    lp = _pad_identity_to(l, size)
    xp = _pad_rows(b, size)
    order = range(steps) if not conj_trans else reversed(range(steps))
    for k in order:
        o = k * nb
        lwin = lp[o:o + W, o:o + nb]
        inv = invert_triangular(lwin[:nb], lower=True,
                                unit_diagonal=unit_diagonal)
        if not conj_trans:
            xk = inv @ xp[o:o + nb]
            xp[o + nb:o + W] -= lwin[nb:] @ xk
        else:
            # L^H x_k = b_k - (L[below, k])^H x_below
            xk = inv.mH @ (xp[o:o + nb] - lwin[nb:].mH @ xp[o + nb:o + W])
        xp[o:o + nb] = xk
    return xp[:b.shape[0]]


def band_trsm_upper(u: torch.Tensor, b: torch.Tensor, n: int, nb: int,
                    ku_eff: int) -> torch.Tensor:
    """Backward solve U X = B with U upper triangular of bandwidth
    ku_eff, dense-stored: per block step only the in-band columns to
    the right contribute. O(n ku_eff nrhs)."""
    from .blocked import invert_triangular
    w = round_up(max(ku_eff, 1), nb)
    W = nb + w
    steps = ceil_div(max(n, 1), nb)
    size = steps * nb + W
    up = _pad_identity_to(u, size)
    xp = _pad_rows(b, size)
    for k in reversed(range(steps)):
        o = k * nb
        uwin = up[o:o + nb, o:o + W]
        rhs = xp[o:o + nb] - uwin[:, nb:] @ xp[o + nb:o + W]
        # the upper diagonal block's inverse through the lower one of
        # its conjugate transpose
        inv = invert_triangular(uwin[:, :nb].mH, lower=True).mH
        xp[o:o + nb] = inv @ rhs
    return xp[:b.shape[0]]


def _window_perm(ipad: torch.Tensor, o: int, nb: int, W: int
                 ) -> torch.Tensor:
    """The permutation of a W-row window that the block step at row o
    applies: its swaps j <-> ipad[o + j] - o (window-local; the entries
    past the factor's rows are identity) composed into one gather
    (``lu._compose_swaps``)."""
    from .lu import _compose_swaps
    return _compose_swaps(ipad[o:o + nb] - o, W)


def _pad_pivots(ipiv: torch.Tensor, size: int) -> torch.Tensor:
    """int32 swap targets over `size` rows: ipiv, then identity."""
    ipad = torch.arange(size, dtype=torch.int32, device=ipiv.device)
    ipad[:ipiv.shape[0]] = ipiv.to(torch.int32)
    return ipad


def gbtrf_band(a: torch.Tensor, n: int, nb: int, kl: int, ku: int):
    """Partial-pivot LU of a general band matrix (dense-stored,
    bandwidths kl / ku; reference src/gbtrf.cc). Row pivoting reaches
    only kl rows below the diagonal and fills the upper bandwidth to
    kl + ku (LAPACK gbtrf); each block step factors the (nb + kl) x nb
    window panel through ``lu._lu_panel`` (its route arbitration, the
    recursive hand kernel when the tune cache routes ``pallas_rec``),
    applies the panel's swaps to the window's trailing columns as one
    composed gather, and updates the (nb + kl) x (kl + ku) window.
    Returns (packed LU in dense storage, global pivot swaps).
    Cost O(n kl (kl + ku + nb))."""
    from .blocked import invert_triangular
    from .lu import _compose_swaps, _lu_panel
    wr = round_up(max(kl, 1), nb)                 # pivot reach below
    wc = round_up(max(kl + ku, 1), nb)            # fill-in reach right
    Wr, Wc = nb + wr, nb + wc
    steps = ceil_div(max(n, 1), nb)
    work = _pad_identity_to(a, steps * nb + max(Wr, Wc))
    ipiv = torch.arange(steps * nb, dtype=torch.int32, device=a.device)
    for k in range(steps):
        o = k * nb
        win = work[o:o + Wr, o:o + Wc]
        panel, piv = _lu_panel(win[:, :nb])
        rest = win[:, nb:][_compose_swaps(piv, Wr)]
        linv = invert_triangular(panel[:nb], lower=True,
                                 unit_diagonal=True)
        u12 = linv @ rest[:nb]
        win[:, :nb] = panel
        win[:nb, nb:] = u12
        win[nb:, nb:] = rest[nb:] - panel[nb:] @ u12
        ipiv[o:o + nb] = o + piv.to(torch.int32)
    N = a.shape[0]
    return work[:N, :N], ipiv


def gb_forward_solve(lu: torch.Tensor, ipiv: torch.Tensor, b: torch.Tensor,
                     n: int, nb: int, kl: int) -> torch.Tensor:
    """Forward sweep of gbtrs: per block, the block's recorded row
    swaps on the active rows of the right-hand side, then the unit-lower
    band solve step (gbtrf does not carry later swaps into earlier L
    columns, so swaps and elimination interleave by block, matching
    gbtrf_band's windows)."""
    from .blocked import invert_triangular
    wr = round_up(max(kl, 1), nb)
    W = nb + wr
    steps = ceil_div(max(n, 1), nb)
    size = steps * nb + W
    lp = _pad_identity_to(lu, size)
    xp = _pad_rows(b, size)
    ipad = _pad_pivots(ipiv, size)
    for k in range(steps):
        o = k * nb
        win = xp[o:o + W][_window_perm(ipad, o, nb, W)]
        lwin = lp[o:o + W, o:o + nb]
        inv = invert_triangular(lwin[:nb], lower=True, unit_diagonal=True)
        xk = inv @ win[:nb]
        xp[o:o + nb] = xk
        xp[o + nb:o + W] = win[nb:] - lwin[nb:] @ xk
    return xp[:b.shape[0]]


def gb_backward_solve_trans(lu: torch.Tensor, ipiv: torch.Tensor,
                            b: torch.Tensor, n: int, nb: int, kl: int,
                            conj: bool) -> torch.Tensor:
    """The transposed half of gbtrs (A^T or A^H systems): blocks in
    reverse, each solved with L_k^T (L_k^H with `conj`), then that
    block's row swaps undone (the inverse of the composed window
    permutation; LAPACK gbtrs 'T' loop)."""
    from .blocked import invert_triangular
    wr = round_up(max(kl, 1), nb)
    W = nb + wr
    steps = ceil_div(max(n, 1), nb)
    size = steps * nb + W
    lp = _pad_identity_to(lu, size)
    xp = _pad_rows(b, size)
    ipad = _pad_pivots(ipiv, size)

    def op(x):
        return x.mH if conj else x.mT

    for k in reversed(range(steps)):
        o = k * nb
        win = xp[o:o + W]
        lwin = lp[o:o + W, o:o + nb]
        # (P_k L_k)^H x = y  =>  z = L_k^-H y ; x = P_k z
        rhs = win[:nb] - op(lwin[nb:]) @ win[nb:]
        inv = invert_triangular(lwin[:nb], lower=True, unit_diagonal=True)
        win[:nb] = op(inv) @ rhs
        xp[o:o + W] = win[torch.argsort(_window_perm(ipad, o, nb, W))]
    return xp[:b.shape[0]]


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

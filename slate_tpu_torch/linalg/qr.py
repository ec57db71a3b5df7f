"""QR / LQ / least squares (counterpart of ``slate_tpu/linalg/qr.py``)
on one device: geqrf, unmqr, gelqf, unmlq, cholqr and gels over QR,
CholQR and TSQR.

Packed format as LAPACK / the reference: V below the diagonal (v0 = 1
implicit), R on and above it, taus beside. Compact-WY T factors are
rebuilt per panel (``_larft``). ``geqrf`` with Auto takes one library
geqrf (``torch.geqrf``) up to the tuned ``fused_max_n``, else the
carry-the-trailing-matrix blocked loop (``_geqrf_carry``), and ``unmqr``
applies the panels in a loop, at any number of block steps. Panels go
through ``_qr_panel``:
the library geqrf where its dtype set allows, then the hand-written
``qr_panel`` kernel (ops/kernels.py) where its gate takes the panel
(bf16 on the card, within the reference's caps), then the column loop
of reflections. Where the reference updates slices functionally, the
loops here update a copy in place (same values).

Under ``Option.Grid`` (a ``parallel.ProcessGrid``): a real tall-skinny
geqrf (m >= the tuned ``('tsqr', 'panel_aspect')`` times n, every rank's
chunk at least n rows) takes the grid TSQR tree (``_geqrf_tsqr_grid``,
``dist/tsqr.py``: R packed, the thin Q explicit in ``QRFactors.Q``);
elsewhere the owner-computes compact-WY loop ``_geqrf_grid`` at the tile
size, panels by ``_qr_panel_blocked`` on the diagonal's owner.
``MethodFactor.Fused`` on a grid warns and runs the loop, as the
reference's. ``gels_tsqr`` on a grid is ``dist.tsqr.tsqr_qt`` and the
grid trsm; ``MethodGels.select(on_grid=True)`` routes tall-skinny Auto
there. unmqr and unmlq on a grid run whole on every rank (ROADMAP
queue 3).

Left out on purpose: the reference's fixed-shape step forms
(``_geqrf_scan``, ``_unmqr_scan`` past ``QR_SCAN_THRESHOLD`` steps).
They exist to bound XLA's compile time, which eager PyTorch does not
have, and cost full-height rolled products every step (about twice the
loop's work); the loop computes the same factor.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.enums import Diag, MatrixType, Side, Uplo
from ..core.matrix import HermitianMatrix, TriangularMatrix
from ..core.methods import MethodFactor, MethodGels
from ..core.options import Option, OptionsLike, get_option, get_option_tuned
from ..core.tiles import TiledMatrix, ceil_div, round_up
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from ..ops.householder import reflect
from ..parallel.mesh import option_grid
from .blas3 import _store, trsm
from .blocked import assemble_packed, invert_triangular
from .chol import potrf


class QRFactors(NamedTuple):
    """Packed Householder factor (V below the diagonal, R on/above)
    plus taus (reference geqrf output). ``Q`` is an optional explicit
    orthogonal factor, square or thin (M, K), which unmqr applies by
    one product (the reference's mesh-TSQR route returns one)."""
    QR: TiledMatrix
    taus: torch.Tensor          # (min(M, N)_pad,)
    Q: Optional[TiledMatrix] = None


class LQFactors(NamedTuple):
    LQ: TiledMatrix
    taus: torch.Tensor          # (min(M, N)_pad,)


# -- panels -----------------------------------------------------------------

def _native_geqrf(a: torch.Tensor
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The library geqrf (``torch.geqrf``: LAPACK on the CPU, cuSOLVER
    on the card), or None where its dtype set ends (bf16, as the
    reference's native geqrf). Wide panels carry min(m, w) reflectors:
    the taus are padded with 0 (exact identities) to the (w,)
    contract."""
    if not MethodFactor.native_lu_dtype_ok(a.dtype):
        return None
    packed, taus = torch.geqrf(a)
    m, w = a.shape[-2:]
    if a.is_complex() and 1 <= m <= w:
        packed, taus = _larfg_last(packed, taus, m - 1)
    if taus.shape[-1] < w:
        taus = torch.cat([taus, taus.new_zeros(*taus.shape[:-1],
                                               w - taus.shape[-1])], dim=-1)
    return packed, taus


def _larfg_last(packed: torch.Tensor, taus: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAPACK zlarfg for n = 1 on reflector k, where the library skipped
    it: the last reflector of a complex panel with no more rows than
    columns acts on the 1x1 block R_kk. torch's geqrf leaves it alone
    (tau 0, complex R_kk) where LAPACK's zgeqr2 (and the reference)
    makes R_kk real: beta = -sign(alpha_r) |alpha|,
    tau = (beta - alpha_r) / beta - i alpha_i / beta, and the rest of
    row k is multiplied by 1 - conj(tau) (H^H from the left). Applied
    by masks (no host read) only where tau_k is 0 and R_kk is not
    real; leading batch dimensions ride along."""
    alpha = packed[..., k, k]
    ar, ai = alpha.real, alpha.imag
    fix = (taus[..., k] == 0) & (ai != 0)
    big = torch.maximum(ar.abs(), ai.abs())
    big = torch.where(big == 0, torch.ones_like(big), big)
    nrm = big * torch.sqrt((ar / big) ** 2 + (ai / big) ** 2)  # dlapy3
    beta = torch.where(ar >= 0, -nrm, nrm)
    safe = torch.where(beta == 0, torch.ones_like(beta), beta)
    tau = torch.complex((beta - ar) / safe, -ai / safe)
    packed, taus = packed.clone(), taus.clone()
    packed[..., k, k] = torch.where(fix, beta.to(packed.dtype), alpha)
    row = packed[..., k, k + 1:]
    packed[..., k, k + 1:] = torch.where(
        fix[..., None], row * (1 - tau.conj())[..., None], row)
    taus[..., k] = torch.where(fix, tau, taus[..., k])
    return packed, taus


def qr_panel_fori(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column loop of reflections (``householder.reflect``), in the
    panel's type: per column j, the reflector of rows >= j, applied to
    the columns right of j; beta on the diagonal, v below it."""
    m, w = a.shape
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(w, device=a.device)
    a = a.clone()
    taus = torch.zeros(w, dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(w):
        x = torch.where(rows >= j, a[:, j], zero)
        v, tau, beta = reflect(x, rows, j)
        vha = v.conj() @ a
        a = a - tau * torch.outer(v, torch.where(cols > j, vha, zero))
        newcol = torch.where(rows > j, v, a[:, j])
        a[:, j] = torch.where(rows == j, beta, newcol)
        taus[j] = tau
    return a, taus


def _qr_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder QR of an (m, w) panel, in the reference's order: the
    library geqrf, then the qr_panel kernel where its routing gate
    takes the panel (a CUDA tensor of f32/bf16 within the caps), then
    the column loop. Off the card the gate rejects, so bf16 panels take
    the column loop, as the reference's do off the TPU. A (B, m, w)
    stack of a type the library lacks goes element by element."""
    native = _native_geqrf(a)
    if native is not None:
        return native
    if a.dim() > 2:
        parts = [_qr_panel(x) for x in a]
        return (torch.stack([p for p, _ in parts]),
                torch.stack([t for _, t in parts]))
    m, w = a.shape
    if pk.qr_panel_eligible(m, w, a.dtype, a.device):
        fused = pk.qr_panel(a)
        if fused is not None:
            return fused
    return qr_panel_fori(a)


def _panel_V(a_panel: torch.Tensor, j0: int) -> torch.Tensor:
    """Unit-lower V from packed panel rows [j0:, :] (of each panel of a
    stack)."""
    m, w = a_panel.shape[-2:]
    ii = torch.arange(m, device=a_panel.device)[:, None] - j0
    jj = torch.arange(w, device=a_panel.device)[None, :]
    V = torch.where(ii > jj, a_panel, torch.zeros((), dtype=a_panel.dtype,
                                                  device=a_panel.device))
    return V + (ii == jj).to(a_panel.dtype)


def _larft(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T with Q = I - V T V^H (lapack larft), in the
    reference's closed form: T^{-1} = diag(1/tau) + striu(V^H V), one
    Gram product and one triangular inversion. Reflectors with tau = 0
    (H = I) are masked out of the Gram matrix and of T."""
    vhv = V.mH @ V
    active = taus != 0
    act2 = active[..., :, None] & active[..., None, :]
    zero = torch.zeros((), dtype=V.dtype, device=V.device)
    safe = torch.where(active, taus, torch.ones_like(taus))
    tinv = torch.diag_embed(1.0 / safe) \
        + torch.triu(torch.where(act2, vhv, zero), 1)
    T = invert_triangular(tinv, lower=False)
    return torch.where(act2, T, zero)


def _apply_left(V: torch.Tensor, Tm: torch.Tensor, C: torch.Tensor
                ) -> torch.Tensor:
    """C - V (Tm (V^H C)): one compact-WY application from the left."""
    return C - V @ (Tm @ (V.mH @ C))


def _qr_panel_blocked(a: torch.Tensor, ib: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Panel factorization: one library geqrf where the dtype allows,
    else ib-wide sub-panels (each one `_qr_panel`) with compact-WY
    updates of the panel columns right of them (the reference's inner
    blocking)."""
    native = _native_geqrf(a)
    if native is not None:
        return native
    w = a.shape[-1]
    if w <= ib:
        return _qr_panel(a)
    a = a.clone()
    taus = torch.zeros((*a.shape[:-2], w), dtype=a.dtype, device=a.device)
    for s in range(0, w, ib):
        e = min(s + ib, w)
        sub, stau = _qr_panel(a[..., s:, s:e])
        a[..., s:, s:e] = sub
        taus[..., s:e] = stau
        if e < w:
            V = _panel_V(sub, 0)
            a[..., s:, e:] = _apply_left(V, _larft(V, stau).mH,
                                         a[..., s:, e:])
    return a, taus


# -- blocked factorization ----------------------------------------------------

def _geqrf_carry(a: torch.Tensor, nb: int, kmax: int, ib: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device blocked Householder QR carrying the shrinking
    trailing matrix: after panel k its top rows are final R rows and
    drop out of the carried block. Leading batch dimensions ride
    along (the batch layer's geqrf core)."""
    M, N = a.shape[-2:]
    nt = ceil_div(kmax, nb)
    trail = a
    panels, taus_l, rtops = [], [], []
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0
        pan, ptau = _qr_panel_blocked(trail[..., :w], ib=ib)
        panels.append(pan)
        taus_l.append(ptau)
        if k1 < N:
            V = _panel_V(pan, 0)
            rest = _apply_left(V, _larft(V, ptau).mH, trail[..., w:])
            rtops.append(rest[..., :w, :])
            trail = rest[..., w:, :]
    out = assemble_packed(panels, rtops, nb, kmax, M, N, a.dtype)
    taus = torch.cat(taus_l, dim=-1)
    npad = min(M, N)
    if taus.shape[-1] < npad:           # padded-length contract
        taus = torch.cat([taus, taus.new_zeros(*taus.shape[:-1],
                                               npad - taus.shape[-1])],
                         dim=-1)
    return out, taus


def geqrf_default_nb(kmax: int, tile_nb: int) -> int:
    """The reference's frozen single-device blocking: nb grows with n to
    hold the carry step count near 16 (256/512/1024 at 4096/8192/16384;
    a TPU measurement, kept so both packages block alike)."""
    return max(min(tile_nb, 256),
               min(round_up(ceil_div(kmax, 16), 128), 1024))


def _geqrf_grid(a: torch.Tensor, nb: int, kmax: int, ib: int, grid,
                tiles: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's grid geqrf loop (qr.py:486-503) owner-computes:
    per step the current panel column is gathered, the diagonal's owner
    factors it (_qr_panel_blocked), forms T and broadcasts panel, taus
    and T; each rank applies C -= V T^H (V^H C) to its own tiles, the
    V^H C sums completed down its grid column (an all_reduce over 'p');
    the finished R row block is gathered to every rank."""
    from ..parallel import owner as own
    from ..parallel.collectives import all_reduce
    M, N = a.shape
    nt = ceil_div(kmax, nb)
    a = a.clone()
    dev = a.device
    o = own.Owner(grid, (M, N), tiles[0], tiles[1], dev)
    taus = torch.zeros((min(M, N),), dtype=a.dtype, device=dev)

    def factor(col):
        panel, ptau = _qr_panel_blocked(col, ib=ib)
        return panel, ptau, _larft(_panel_V(panel, 0), ptau)

    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0
        panel, ptau, T = own.step(
            o, a, slice(k0, M), slice(k0, k1), factor,
            [((M - k0, w), a.dtype), ((w,), a.dtype), ((w, w), a.dtype)])
        a[k0:, k0:k1] = panel
        taus[k0:k1] = ptau
        if k1 >= N:
            continue
        ri, ci, C = own.owned_block(o, a, k0, M, k1, N)
        if ci.numel():
            V = _panel_V(panel, 0)[ri - k0]
            W = all_reduce(grid, V.mH @ C, "p")
            own.count_product(ri.numel(), ci.numel(), 2 * w,
                              a.is_complex())
            a[ri[:, None], ci[None, :]] = C - V @ (T.mH @ W)
        a[k0:k1, k1:] = own.gather(o, a, slice(k0, k1), slice(k1, N))
    return a, taus


def _geqrf_tsqr_grid(grid, r: TiledMatrix, opts) -> QRFactors:
    """Tall-skinny grid geqrf by the grid TSQR tree (dist/tsqr.py): R in
    the packed slot (V region zero), the thin orthonormal factor in
    QRFactors.Q (unmqr applies it as the isometry), taus zero (exact
    identity reflectors), as the reference's qr.py:507-524."""
    from ..dist import tsqr as dtsqr
    from ..parallel.sharding import assemble
    a = r.data[:, :r.n]          # padded rows stay: zero rows are exact
    ql, R = dtsqr.tsqr(grid, a, opts=opts)
    M, N = r.data.shape
    mp = ql.shape[0] * grid.nprocs
    q = assemble(grid, ql, (mp, r.n), grid.row_sharding())[:M]
    packed = torch.zeros((M, N), dtype=a.dtype, device=a.device)
    packed[:r.n, :r.n] = R
    out = dataclasses.replace(r, data=packed, mtype=MatrixType.General)
    taus = torch.zeros((min(M, N),), dtype=a.dtype, device=a.device)
    return QRFactors(out, taus, Q=TiledMatrix.from_dense(
        q, r.mb, r.nb, device=q.device))


@instrument_driver("geqrf")
def geqrf(A: TiledMatrix, opts: OptionsLike = None, *,
          _allow_tsqr: bool = True) -> QRFactors:
    """Blocked Householder QR (reference src/geqrf.cc:26). Auto takes
    one library geqrf up to the tuned ("geqrf", "fused_max_n") size,
    the carry form above it, at every step count (the reference's
    fixed-shape step past its step cap is not ported: see the module
    docstring). On a grid: the TSQR tree for tall-skinny, else the
    owner-computes loop (module doc). _allow_tsqr=False (gelqf's
    conjugate dual) keeps the packed-Householder contract."""
    grid = option_grid(opts, "geqrf")
    r = A.uniform().resolve()
    a = r.data
    M, N = a.shape
    method = get_option(opts, Option.MethodFactor, MethodFactor.Auto)
    requested = method
    if grid is not None:
        if method is MethodFactor.Fused:
            warnings.warn("geqrf: MethodFactor.Fused is single-device; a "
                          "Grid was given, so the Tiled blocked path runs "
                          "instead", stacklevel=2)
        from ..dist import tsqr as dtsqr
        from ..tune.select import tuned_int
        from ..parallel.collectives import agree
        aspect = tuned_int("tsqr", "panel_aspect", 4, opts=opts, n=r.n,
                           dtype=a.dtype)
        kmax = max(min(r.m, r.n), 1)
        ib = get_option_tuned(opts, Option.InnerBlocking, "geqrf",
                              n=kmax, dtype=a.dtype)
        # both came from this rank's tune cache: grid rank 0's run
        aspect, ib = agree(grid, aspect, ib)
        if _allow_tsqr and not a.is_complex() \
                and method in (MethodFactor.Auto, MethodFactor.Tiled) \
                and r.n >= 1 and r.m >= aspect * r.n \
                and dtsqr.eligible(grid, (r.m, r.n)):
            return _geqrf_tsqr_grid(grid, r, opts)
        packed, taus = _geqrf_grid(a, r.nb, kmax, ib, grid, (r.mb, r.nb))
        return QRFactors(dataclasses.replace(r, data=packed,
                                             mtype=MatrixType.General),
                         taus)
    if method is MethodFactor.Auto:
        from ..tune.select import resolve
        fused_max_n = int(resolve("geqrf", "fused_max_n", opts=opts,
                                  n=min(r.m, r.n), dtype=a.dtype))
        if min(r.m, r.n) <= fused_max_n:
            method = MethodFactor.Fused
    if method is MethodFactor.Fused:
        native = _native_geqrf(a)
        if native is not None:
            packed, ntaus = native
            return QRFactors(dataclasses.replace(
                r, data=packed, mtype=MatrixType.General),
                ntaus[:min(M, N)])
        if requested is MethodFactor.Fused:
            warnings.warn(f"geqrf: the library geqrf does not implement "
                          f"{a.dtype}; falling back to the Tiled blocked "
                          f"path", stacklevel=2)
    kmax = max(min(r.m, r.n), 1)     # number of reflectors (logical)
    ib = get_option_tuned(opts, Option.InnerBlocking, "geqrf", n=kmax,
                          dtype=a.dtype)
    from ..tune.select import tuned_int
    nb_frozen = geqrf_default_nb(kmax, r.nb)
    cand = tuned_int("geqrf", "nb", nb_frozen, opts=opts,
                     option=Option.BlockSize, n=kmax,
                     dtype=a.dtype) or nb_frozen
    packed, taus = _geqrf_carry(a, cand, kmax, ib)
    return QRFactors(dataclasses.replace(r, data=packed,
                                         mtype=MatrixType.General),
                     taus[:min(M, N)])


# -- applying Q -------------------------------------------------------------

def _fit(x: torch.Tensor, count: int, axis: int) -> torch.Tensor:
    """x cropped or zero-padded to `count` along `axis`."""
    if x.shape[axis] >= count:
        return x[:count] if axis == 0 else x[:, :count]
    pad = [0, 0, 0, count - x.shape[0]] if axis == 0 \
        else [0, count - x.shape[1]]
    return torch.nn.functional.pad(x, pad)


def unmqr(side: Side, A: QRFactors, C: TiledMatrix, trans: bool = True,
          opts: OptionsLike = None) -> TiledMatrix:
    """Multiply C by Q or Q^H from geqrf (reference src/unmqr.cc).
    trans=True applies Q^H (the gels case). An explicit Q applies by
    one product; a thin (M, K) Q applies as the isometry (rows or
    columns past K come out zero)."""
    if A.Q is not None:
        qm = A.Q.to_dense()
        qm = qm.mH if trans else qm
        c_log = C.to_dense()
        cm, cn = c_log.shape
        if side is Side.Left:
            return _store(C, _fit(qm @ _fit(c_log, qm.shape[1], 0), cm, 0))
        return _store(C, _fit(_fit(c_log, qm.shape[0], 1) @ qm, cn, 1))
    r = A.QR.resolve()
    a = r.data
    M = a.shape[0]
    nb = r.nb
    kmax = max(min(r.m, r.n), 1)     # number of reflectors (logical)
    nt = ceil_div(kmax, nb)
    c_log = C.to_dense()
    cm, cn = c_log.shape
    left = side is Side.Left
    # pad C to the factor's padded extent on the applied side; V's
    # padded rows are zero, so the extra rows/cols stay zero
    c = torch.nn.functional.pad(c_log, (0, 0, 0, M - cm) if left
                                else (0, M - cn))
    # Left Q^H C and right C Q take the panels forward, the other two
    # in reverse (Q = Q_1 Q_2 ... Q_nt)
    forward = trans if left else not trans
    for k in (range(nt) if forward else reversed(range(nt))):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        V = _panel_V(a[k0:, k0:k1], 0)
        T = _larft(V, A.taus[k0:k1])
        Tm = T.mH if trans else T
        if left:
            c[k0:] = _apply_left(V, Tm, c[k0:])
        else:
            c[:, k0:] = c[:, k0:] - ((c[:, k0:] @ V) @ Tm) @ V.mH
    return _store(C, c[:cm, :cn])


def qr_multiply_by_q(*args, **kw):
    """Simplified-API name of unmqr (reference simplified_api.hh:638)."""
    return unmqr(*args, **kw)


def gelqf(A: TiledMatrix, opts: OptionsLike = None) -> LQFactors:
    """LQ factorization A = L Q (reference src/gelqf.cc), the conjugate
    dual of QR on A^H; packed with V rows above the diagonal."""
    F = geqrf(A.conj_transpose(), opts, _allow_tsqr=False)
    r = F.QR.resolve()
    packed = dataclasses.replace(r, data=r.data.mH, m=r.n, n=r.m,
                                 mb=r.nb, nb=r.mb)
    return LQFactors(packed, F.taus)


def unmlq(side: Side, A: LQFactors, C: TiledMatrix, trans: bool = False,
          opts: OptionsLike = None) -> TiledMatrix:
    """Multiply by Q from gelqf (reference src/unmlq.cc): Q_lq is the
    dual QR's Q^H, so the dual apply runs with trans flipped."""
    r = A.LQ.resolve()
    qr_packed = dataclasses.replace(r, data=r.data.mH, m=r.n, n=r.m,
                                    mb=r.nb, nb=r.mb)
    return unmqr(side, QRFactors(qr_packed, A.taus), C, trans=not trans,
                 opts=opts)


def cholqr(A: TiledMatrix, opts: OptionsLike = None
           ) -> Tuple[TiledMatrix, TiledMatrix]:
    """Cholesky QR (reference src/cholqr.cc): R = chol(A^H A) (upper),
    Q = A R^-1; one product forms A^H A, whichever MethodCholQR is
    named."""
    r = A.resolve()
    a = r.to_dense()
    H = HermitianMatrix(Uplo.Upper, a.mH @ a, mb=r.nb, device=a.device)
    R = potrf(H, opts)
    Q = trsm(Side.Right, 1.0, R,
             dataclasses.replace(r, mtype=MatrixType.General), opts)
    return Q, R


# -- least squares ------------------------------------------------------------

def _rhs(x: torch.Tensor, B: TiledMatrix) -> TiledMatrix:
    return TiledMatrix.from_dense(x, B.mb, B.nb, device=x.device)


@instrument_driver("gels")
def gels(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None
         ) -> TiledMatrix:
    """Least squares / minimum-norm solve (reference src/gels.cc:99).
    m >= n: minimize ||A x - b|| by QR, CholQR or TSQR (MethodGels;
    Auto is CholQR for m >= 3n, else QR). m < n: the minimum-norm
    solution through LQ."""
    m, n = A.shape
    if m >= n:
        method = get_option(opts, Option.MethodGels, None)
        if method is None or method is MethodGels.Auto:
            method = MethodGels.select(
                m, n, on_grid=get_option(opts, Option.Grid, None)
                is not None)
        if method is MethodGels.CholQR:
            return gels_cholqr(A, B, opts)
        if method is MethodGels.TSQR:
            return gels_tsqr(A, B, opts)
        return gels_qr(A, B, opts)
    # underdetermined: A = L Q, x = Q^H L^-1 b
    F = gelqf(A, opts)
    L = dataclasses.replace(F.LQ.resolve(), mtype=MatrixType.Triangular,
                            uplo=Uplo.Lower, diag=Diag.NonUnit)
    y = trsm(Side.Left, 1.0, L.slice(0, m - 1, 0, m - 1), B,
             opts).to_dense()
    ypad = torch.zeros((n, y.shape[1]), dtype=y.dtype, device=y.device)
    ypad[:m] = y
    return unmlq(Side.Left, F, _rhs(ypad, B), trans=True, opts=opts)


def gels_qr(A: TiledMatrix, B: TiledMatrix,
            opts: OptionsLike = None) -> TiledMatrix:
    """Least squares by Householder QR (reference slate.hh:917)."""
    from ..utils.trace import phases
    ph = phases(opts)
    n = A.shape[1]
    with ph("gels::geqrf"):
        F = geqrf(A, opts)
    with ph("gels::unmqr"):
        QtB = unmqr(Side.Left, F, B, trans=True, opts=opts)
    R = dataclasses.replace(F.QR.resolve(), mtype=MatrixType.Triangular,
                            uplo=Uplo.Upper, diag=Diag.NonUnit)
    return trsm(Side.Left, 1.0, R.slice(0, n - 1, 0, n - 1),
                _rhs(QtB.to_dense()[:n], B), opts)


@instrument_driver("gels_tsqr")
def gels_tsqr(A: TiledMatrix, B: TiledMatrix,
              opts: OptionsLike = None) -> TiledMatrix:
    """Least squares by the tree QR, Q implicit: on a grid the grid tree
    (dist.tsqr.tsqr_qt: each rank QRs its rows, Q^H B rides the R
    exchanges) where every rank's chunk is at least n rows, else the
    one-device tree (linalg/ca.py); then one triangular solve."""
    from ..utils.trace import phases
    from .ca import tsqr_factors, tsqr_qt_apply
    grid = option_grid(opts, "gels_tsqr")
    ph = phases(opts)
    r = A.resolve()
    a = A.to_dense()
    if grid is not None:
        from ..dist import tsqr as dtsqr
        if dtsqr.eligible(grid, tuple(a.shape)):
            with ph("gels_tsqr::tsqr_qt"):
                R, qtb = dtsqr.tsqr_qt(grid, a, B.to_dense(), opts=opts)
            Rt = TriangularMatrix(Uplo.Upper, R, mb=r.nb, device=R.device)
            with ph("gels_tsqr::trsm"):
                return trsm(Side.Left, 1.0, Rt, _rhs(qtb, B), opts)
    n = A.shape[1]
    with ph("gels_tsqr::tree"):
        qs, R = tsqr_factors(a, chunk=max(r.mb, 4 * n))
        qtb = tsqr_qt_apply(qs, B.to_dense(), a.shape[0])
    Rt = TriangularMatrix(Uplo.Upper, R, mb=r.nb, device=R.device)
    with ph("gels_tsqr::trsm"):
        return trsm(Side.Left, 1.0, Rt, _rhs(qtb, B), opts)


def gels_cholqr(A: TiledMatrix, B: TiledMatrix,
                opts: OptionsLike = None) -> TiledMatrix:
    """Least squares by Cholesky QR (reference src/gels_cholqr.cc)."""
    Q, R = cholqr(A, opts)
    qtb = Q.to_dense().mH @ B.to_dense()
    return trsm(Side.Left, 1.0, R, _rhs(qtb, B), opts)

"""SVD (counterpart of ``slate_tpu/linalg/svd.py``) on one device: svd
(Auto, QRIteration, DC), svd_vals / gesvd, and the staged pipeline
ge2tb (dense -> triangular band) -> tb2bd (band -> bidiagonal) -> bdsqr
(bidiagonal QR iteration) with the back-transforms unmbr_ge2tb /
unmbr_tb2bd.

Auto and DC take the library SVD (``torch.linalg.svd``: LAPACK gesdd on
the CPU, cuSOLVER on the card), where the reference takes XLA's. The QR
iteration (``bdsqr_qr``) runs its passes in ``bdsqr_sweeps`` launches
of up to ``BDSQR_PASSES_PER_LAUNCH`` passes each (ops/kernels.py: the
clamp, the block search, the shift and the bulge chase on the card,
stopping where the reference's while_loop stops; the host reads the
passes run and the count once a launch) and accumulates each pass's
two rotation chains into Gu and Gvh, in order: by the dense compose
(``_givens_chain_matrix``, one product each) on a cold tune cache, or,
when the cache routes ``('bdsqr', 'chain') = 'pallas_rec'``, by the
``givens_chain_apply`` kernel.

At each of the reference's ``_on_tpu()`` sites the port takes the branch
the reference takes off the TPU, on the CPU and on the card alike.

Left out on purpose: ge2tb's fixed-shape step form (``_ge2tb_scan``,
past the reference's 64 panels). It bounds XLA's compile time, which
eager PyTorch does not have; the loop takes every size.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.enums import MatrixType
from ..core.methods import MethodSVD
from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix, ceil_div
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from ..ops.householder import reflect
from .blas3 import _store
from .qr import _larft, _panel_V, _qr_panel_blocked


class SVDResult(NamedTuple):
    s: torch.Tensor                    # (min(m,n),) descending
    U: Optional[TiledMatrix]
    Vh: Optional[TiledMatrix]


class BidiagResult(NamedTuple):
    d: torch.Tensor          # (k,) diagonal
    e: torch.Tensor          # (k-1,) superdiagonal
    U: Optional[TiledMatrix]
    Vh: Optional[TiledMatrix]


class Ge2tbResult(NamedTuple):
    """Stage-1 output: upper triangular band B of width nb with
    A = U B Vh (transforms accumulated explicitly)."""
    B: TiledMatrix
    U: TiledMatrix
    Vh: TiledMatrix


#: above this size the QR iteration's O(k^4) transform accumulation
#: loses to the library SVD (the reference's cap)
BDSQR_QR_MAX_N = 512


def _tm(x: torch.Tensor, mb: int, nb: int, **kw) -> TiledMatrix:
    """A result tensor as a TiledMatrix on its own device."""
    return TiledMatrix.from_dense(x, mb, nb, device=x.device, **kw)


@instrument_driver("svd")
def svd(A: TiledMatrix, opts: OptionsLike = None,
        want_u: bool = True, want_vh: bool = True) -> SVDResult:
    """Singular value decomposition (reference src/svd.cc): Auto and DC
    take the library SVD; QRIteration runs ge2tb -> tb2bd -> bdsqr with
    both back-transforms composed. A measured tune-cache entry
    ('svd', 'method_svd') may route Auto; a cold cache keeps the
    library."""
    method = get_option(opts, Option.MethodSVD, MethodSVD.Auto)
    if method is MethodSVD.Auto:
        from ..tune.select import tuned_method
        cached = tuned_method("svd", "svd", opts=opts,
                              option=Option.MethodSVD,
                              n=min(A.shape), dtype=A.dtype)
        if cached is not None and cached is not MethodSVD.Auto:
            method = cached
    if method is MethodSVD.QRIteration:
        # the reference warns here on a TPU only (svd.py:71); the card
        # is not one, and its bdsqr runs the QR iteration
        Bd = tb2bd(ge2tb(A, opts), opts)
        if not (want_u or want_vh):
            Bd = Bd._replace(U=None, Vh=None)
        res = bdsqr(Bd, opts)
        return SVDResult(res.s, res.U if want_u else None,
                         res.Vh if want_vh else None)
    a = A.to_dense()
    if want_u or want_vh:
        u, s, vh = _library_svd(a)
        r = A.resolve()
        return SVDResult(s, _tm(u, r.mb, r.nb) if want_u else None,
                         _tm(vh, r.mb, r.nb) if want_vh else None)
    return SVDResult(torch.linalg.svdvals(a, driver=_svd_driver(a)), None,
                     None)


def _svd_driver(a: torch.Tensor) -> Optional[str]:
    """cuSOLVER's QR-based gesvd on the card: torch's default there
    (Jacobi gesvdj) stops at a tolerance far above f32 rounding (a
    512 x 512 f32 reconstruction error of 1.7e-4 on an H100). The CPU
    takes LAPACK's gesdd, as the reference."""
    return "gesvd" if a.is_cuda else None


def _library_svd(a: torch.Tensor):
    return torch.linalg.svd(a, full_matrices=False, driver=_svd_driver(a))


def svd_vals(A: TiledMatrix, opts: OptionsLike = None) -> torch.Tensor:
    """Reference slate.hh:997 svd_vals."""
    return svd(A, opts, want_u=False, want_vh=False).s


def gesvd(A: TiledMatrix, opts: OptionsLike = None, **kw) -> SVDResult:
    return svd(A, opts, **kw)


# -- stage 1: dense -> band ---------------------------------------------------

def _golub_kahan(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """Golub-Kahan bidiagonalization with accumulated U, V^H (LAPACK
    gebrd contract, upper bidiagonal): A = U B Vh, column by column,
    a left reflector then a right one."""
    m, n = a.shape
    dev = a.device
    u = torch.eye(m, dtype=a.dtype, device=dev)
    vh = torch.eye(n, dtype=a.dtype, device=dev)
    rowsm = torch.arange(m, device=dev)
    rowsn = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    k = min(m, n)
    for j in range(k):
        x = torch.where(rowsm >= j, a[:, j], zero)
        v, tau, _ = reflect(x, rowsm, j)
        w = tau * (v.conj() @ a)
        a = a - torch.outer(v, w)
        u = u - tau.conj() * torch.outer(u @ v, v.conj())
        y = torch.where(rowsn >= j + 1, a[j].conj(), zero)
        vr, taur, _ = reflect(y, rowsn, j + 1)
        a = a - taur.conj() * torch.outer(a @ vr, vr.conj())
        vh = vh - taur * torch.outer(vr, vr.conj() @ vh)
    return (torch.diagonal(a)[:k], torch.diagonal(a, 1)[:max(k - 1, 0)],
            u, vh)


def ge2tb(A: TiledMatrix, opts: OptionsLike = None) -> Ge2tbResult:
    """Stage 1: dense -> upper triangular band of width nb (reference
    src/ge2tb.cc): alternating blocked QR column panels and LQ row
    panels (the library geqrf where the dtype allows) with compact-WY
    trailing updates, transforms accumulated explicitly."""
    r = A.resolve()
    nb = r.nb
    m, n = r.m, r.n
    kmax = min(m, n)
    nt = ceil_div(max(kmax, 1), nb)
    a = A.to_dense().clone()
    dev, dt = a.device, a.dtype
    u = torch.eye(m, dtype=dt, device=dev)
    vh = torch.eye(n, dtype=dt, device=dev)
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0
        # left QR panel: zero the column block below the diagonal
        packed, taus = _qr_panel_blocked(a[k0:, k0:k1])
        V = _panel_V(packed, 0)
        T = _larft(V, taus)
        a[k0:, k0:k1] = 0
        a[k0:k0 + w, k0:k1] = torch.triu(packed[:w])
        if k1 < n:
            C = a[k0:, k1:]
            a[k0:, k1:] = C - V @ (T.mH @ (V.mH @ C))
        Uc = u[:, k0:]
        u[:, k0:] = Uc - ((Uc @ V) @ T) @ V.mH
        # right LQ panel: zero the row block beyond the band
        if k1 < n:
            packed2, taus2 = _qr_panel_blocked(a[k0:k1, k1:].mH)
            V2 = _panel_V(packed2, 0)
            T2 = _larft(V2, taus2)
            L = torch.triu(packed2[:w]).mH
            a[k0:k1, k1:] = 0
            a[k0:k1, k1:k1 + L.shape[1]] = L
            if k1 < m:
                C = a[k1:, k1:]
                a[k1:, k1:] = C - ((C @ V2) @ T2) @ V2.mH
            Vr = vh[k1:, :]
            vh[k1:, :] = Vr - (V2 @ T2.mH) @ (V2.mH @ Vr)
    ku = min(nb, max(n - 1, 0))
    return Ge2tbResult(_tm(a, r.mb, r.nb, mtype=MatrixType.GeneralBand,
                           kl=0, ku=ku),
                       _tm(u, r.mb, r.mb), _tm(vh, r.nb, r.nb))


# -- stage 2: band -> bidiagonal ----------------------------------------------

def tb2bd(F, opts: OptionsLike = None) -> BidiagResult:
    """Stage 2: band -> bidiagonal (reference src/tb2bd.cc). A genuine
    upper band (2 <= kd <= n/3, square, kl <= 0) takes the windowed
    bulge chase (band.tb2bd_band); anything else the dense Golub-Kahan
    loop. Stage 1's transforms are composed into the result's U, Vh. A
    BidiagResult passes through."""
    if isinstance(F, BidiagResult):
        return F
    r = F.B.resolve()
    n = min(r.m, r.n)
    kd = r.ku if r.ku >= 0 else 0
    b = F.B.to_dense()
    # the reference takes the chase off the TPU (svd.py:370; it warns
    # at :374 on a TPU only); the card is not one
    if 2 <= kd <= n // 3 and r.m == r.n and r.kl <= 0:
        from .band import tb2bd_band
        d, e, u2, vh2 = tb2bd_band(b, n, kd, want_uv=True)
    else:
        d, e, u2, vh2 = _golub_kahan(b)
    u = F.U.to_dense() @ u2
    vh = vh2 @ F.Vh.to_dense()
    return BidiagResult(d, e, _tm(u, F.U.mb, F.U.nb),
                        _tm(vh, F.Vh.mb, F.Vh.nb))


# -- stage 3: the bidiagonal QR iteration --------------------------------------

def _givens_chain_matrix(cs: torch.Tensor, sn: torch.Tensor, n: int,
                         dtype=None) -> torch.Tensor:
    """Compose the chained Givens rotations G_0 ... G_{n-2} (G_k acts
    on the index pair (k, k+1): out_k = c x_k + s x_{k+1},
    out_{k+1} = -s x_k + c x_{k+1}) into ONE (n, n) orthogonal matrix,
    for (..., n-1) rotations ((..., n, n) out).

    The reference builds it with a scan of n-1 steps carrying the
    partner column alpha (alpha_0 = e_0; column k = c_k alpha_k +
    s_k e_{k+1}; alpha_{k+1} = -s_k alpha_k + c_k e_{k+1}). Unrolled,
    alpha_k[i] = c_{i-1} (-s_i) ... (-s_{k-1}) (c_{-1} = 1), so one
    cumulative product along the rows of a masked (n, n) array gives
    every alpha at once, with the factors in the scan's order: where
    the cumulative product runs sequentially (the CPU), the result is
    bitwise the scan's."""
    dtype = dtype or cs.dtype
    cs, sn = cs.to(dtype), sn.to(dtype)
    dev = cs.device
    one = torch.ones(*cs.shape[:-1], 1, dtype=dtype, device=dev)
    cprev = torch.cat([one, cs], dim=-1)           # c_{i-1}
    negs = torch.cat([one, -sn], dim=-1)           # -s_{j-1}
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    x = torch.where(j == i, cprev[..., :, None], negs[..., None, :])
    x = torch.where(j < i, torch.ones((), dtype=dtype, device=dev), x)
    alpha = torch.cumprod(x, dim=-1)               # alpha[i, k] = alpha_k[i]
    cext = torch.cat([cs, one], dim=-1)            # the last column: alpha
    G = torch.where(j >= i, cext[..., None, :] * alpha,
                    torch.zeros((), dtype=dtype, device=dev))
    G.diagonal(offset=-1, dim1=-2, dim2=-1).copy_(sn)
    return G


def _select_chain_apply(op: str, rows: int, n: int, dt, device=None):
    """Pick the sweep-chain application route ONCE for a QR-iteration
    driver (steqr2_qr / bdsqr_qr): an applier with
    apply(Z, cs, sn) == Z @ _givens_chain_matrix(cs, sn, n), or None,
    meaning the caller keeps the dense compose. A MEASURED tune-cache
    entry (op, 'chain') == 'pallas_rec' routes to
    ops/kernels.givens_chain_apply when its gate takes the shape, type
    and device; the frozen default is 'dense'."""
    from ..tune.select import resolve
    route = resolve(op, "chain", n=n, dtype=dt, fallback="dense")
    if str(route) != "pallas_rec" \
            or not pk.givens_chain_eligible(rows, n, dt, device=device):
        return None

    def apply_blocked(Z, cs, sn):
        out = pk.givens_chain_apply(Z, cs, sn)
        if out is None:        # the gate took (rows, n) but not Z itself
            return Z @ _givens_chain_matrix(cs, sn, n, dt).to(Z.dtype)
        return out

    return apply_blocked


def bdsqr_qr(d: torch.Tensor, e: torch.Tensor, maxit_factor: int = 12):
    """Real bidiagonal SVD by the shifted implicit QR ITERATION
    (reference src/bdsqr.cc -> LAPACK bdsqr): while an off-diagonal is
    above tolerance and the pass count is below maxit_factor * n, one
    pass (clamp, block, dlas2 shift, chase), then the pass's left and
    right chains accumulate into Gu and Gvh. The passes run in
    ops/kernels.bdsqr_sweeps launches of up to BDSQR_PASSES_PER_LAUNCH
    passes, each given what is left of the cap; the chains are applied
    in pass order after each launch, so s, Gu, Gvh and info are bitwise
    what one launch a pass gives. ``bdsqr_qr.passes`` counts the passes
    run.

    Returns (s, Gu, Gvh, info) descending with
    bidiag(d, e) = Gu diag(s) Gvh; info counts the off-diagonals still
    above tolerance at the cap (LAPACK bdsqr INFO; a 0-d int32
    tensor)."""
    n = d.shape[0]
    dt, dev = d.dtype, d.device
    apply_chain = _select_chain_apply("bdsqr", n, n, dt, dev)
    Gu = torch.eye(n, dtype=dt, device=dev)
    Gvh = torch.eye(n, dtype=dt, device=dev)
    cap, it, count = maxit_factor * n, 0, 0
    while n > 1:
        d, e, cr, sr, cl, sl, ran = pk.bdsqr_sweeps(
            d, e, min(pk.BDSQR_PASSES_PER_LAUNCH, cap - it))
        passes, count = ran.tolist()        # the launch's one host read
        for q in range(passes):
            if apply_chain is not None:
                # Gu @ Gl right-applies the left chain; Gr^T @ Gvh is
                # the right chain applied to Gvh^T (a view: no copy)
                Gu = apply_chain(Gu, cl[q], sl[q])
                Gvh = apply_chain(Gvh.T, cr[q], sr[q]).T
            else:
                # B' = Gl^T B Gr  =>  B = Gl B' Gr^T
                Gu = Gu @ _givens_chain_matrix(cl[q], sl[q], n, dt)
                Gvh = _givens_chain_matrix(cr[q], sr[q], n, dt).T @ Gvh
        it += passes
        bdsqr_qr.passes += passes
        if count == 0 or it >= cap:
            break
    info = torch.tensor(count, dtype=torch.int32, device=dev)
    sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    s = d.abs()
    Gu = Gu * sgn[None, :]
    order = torch.argsort(-s, stable=True)
    return s[order], Gu[:, order], Gvh[order, :], info


bdsqr_qr.passes = 0


def bdsqr(B: BidiagResult, opts: OptionsLike = None,
          return_info: bool = False):
    """Bidiagonal SVD (reference src/bdsqr.cc): the QR iteration
    (bdsqr_qr) for real 1 < k <= BDSQR_QR_MAX_N, the library SVD of the
    bidiagonal otherwise (with the reference's warning), then the
    stage transforms composed. return_info=True returns (result, info):
    0 converged; k > 0 off-diagonals above tolerance at the cap (the
    QR iteration only; the library route reports 0)."""
    d, e = B.d, B.e
    k = d.shape[0]
    info = torch.zeros((), dtype=torch.int32, device=d.device)
    # the reference takes this branch off the TPU (svd.py:621, and warns
    # at :625 off it); the card is not one
    if 1 < k <= BDSQR_QR_MAX_N and not d.is_complex():
        s, u2, vh2, info = bdsqr_qr(d, e)
    else:
        if k > 1:
            warnings.warn(
                "bdsqr: n=%d exceeds BDSQR_QR_MAX_N=%d (or dtype is "
                "complex); the library SVD of the bidiagonal runs "
                "instead of rotation-chain QR iteration. Singular values "
                "match; the rotation-chain INFO convention does not "
                "apply (info=0)." % (k, BDSQR_QR_MAX_N), stacklevel=2)
        u2, s, vh2 = _library_svd(torch.diag(d) + torch.diag(e, 1))
    U = Vh = None
    if B.U is not None:
        U = _tm(B.U.to_dense()[:, :k] @ u2.to(B.U.dtype), B.U.mb, B.U.nb)
    if B.Vh is not None:
        Vh = _tm(vh2.to(B.Vh.dtype) @ B.Vh.to_dense()[:k, :], B.Vh.mb,
                 B.Vh.nb)
    res = SVDResult(s, U, Vh)
    return (res, info) if return_info else res


# -- back-transforms ------------------------------------------------------------

def unmbr_ge2tb(U: TiledMatrix, Vh: TiledMatrix, C: TiledMatrix,
                side_left: bool = True, opts: OptionsLike = None):
    """Apply the ge2tb transforms to C (reference src/unmbr_ge2tb.cc):
    ge2tb returns U and Vh accumulated, so one product."""
    f = (U if side_left else Vh).to_dense()
    c = C.to_dense()
    return _store(C, f @ c if side_left else c @ f)


def unmbr_tb2bd(U: TiledMatrix, Vh: TiledMatrix, C: TiledMatrix,
                side_left: bool = True, opts: OptionsLike = None):
    """Reference src/unmbr_tb2bd.cc: tb2bd composes its transforms into
    the returned U / Vh, so the apply is unmbr_ge2tb's product."""
    return unmbr_ge2tb(U, Vh, C, side_left, opts)

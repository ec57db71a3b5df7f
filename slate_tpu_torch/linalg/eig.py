"""Hermitian eigensolvers (counterpart of ``slate_tpu/linalg/eig.py``)
on one device: heev / syev / eig_vals (Auto, QRIteration, DC), hegst /
hegv / sygv, and the staged pipeline he2hb (full -> band) -> hb2st
(band -> tridiagonal) -> steqr2 / stedc / sterf with the
back-transforms unmtr_he2hb / unmtr_hb2st.

Auto takes the library eigensolver (``blocked.library_eigh`` over
``torch.linalg.eigh``), as the
reference takes XLA's off the TPU. The tridiagonal QR iteration
(``steqr2_qr``) runs its passes in ``steqr_sweeps`` launches of up to
``STEQR_PASSES_PER_LAUNCH`` passes each (ops/kernels.py: clamp, block
search, Wilkinson shift and bulge chase on the card, stopping where the
reference's while_loop stops; the host reads the passes run and the
count once a launch) and accumulates each pass's rotation chain into Z,
in order: by the dense compose (svd._givens_chain_matrix and one
product) on a cold tune cache, or, when the cache routes
``('steqr2', 'chain') = 'pallas_rec'``, by the ``givens_chain_apply``
kernel.

At each of the reference's ``_on_tpu()`` sites the port takes the
branch the reference takes off the TPU, on the CPU and on the card
alike. The spectral divide & conquer that the reference's Auto takes on
a TPU is ported as a public entry (``spectral_dc.eigh_dc``, with
``polar.py`` and the ``SLATE_TPU_CHECK_POLAR`` check as
``spectral_dc.check_polar``), and heev does not route to it on the
card.

Under ``Option.Grid`` (a ``parallel.ProcessGrid``): steqr2 runs
``dist.steqr2.steqr2_qr_dist`` (each rank's rows of Z, gathered), stedc
``dist.stedc.stedc_solve_dist`` with the Q back-transform by
``matmul_sharded``, and hegst (itype 1, lower) the owner-computes
blocked transform. Left out on purpose: he2hb's fixed-shape step form
(``_he2hb_scan``, past
the reference's 64 panels), which bounds XLA's compile time; the
loop takes every size.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.enums import MatrixType, Uplo
from ..core.exceptions import slate_assert
from ..core.matrix import HermitianBandMatrix
from ..core.methods import MethodEig
from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix, ceil_div
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from ..ops.householder import reflect
from ..parallel.mesh import option_grid
from ..utils.backend import DeviceLike, resolve_device
from .blas3 import _store
from .blocked import library_eigh, solve_triangular
from .chol import potrf
from .qr import _larft, _panel_V, _qr_panel_blocked
from .svd import _givens_chain_matrix, _select_chain_apply, _tm


class EigResult(NamedTuple):
    values: torch.Tensor                  # (n,) real ascending
    vectors: Optional[TiledMatrix]        # columns are eigenvectors


class TridiagResult(NamedTuple):
    d: torch.Tensor          # (n,) diagonal
    e: torch.Tensor          # (n-1,) off-diagonal
    Q: Optional[TiledMatrix]   # accumulated transform (if requested)


def _vec(x, device: DeviceLike) -> torch.Tensor:
    """A tensor stays where it is; anything else (numpy) goes to
    `device`, the card unless named."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))


@instrument_driver("heev")
def heev(A: TiledMatrix, opts: OptionsLike = None,
         want_vectors: bool = True) -> EigResult:
    """Hermitian eigendecomposition (reference src/heev.cc). MethodEig
    routes: QRIteration runs he2hb -> hb2st -> steqr2 with the two
    back-transforms, DC the same with stedc, Auto the library
    eigensolver. A measured tune-cache entry ('heev', 'method_eig') may
    route Auto; a cold cache keeps the library."""
    slate_assert(A.mtype in (MatrixType.Hermitian, MatrixType.Symmetric,
                             MatrixType.HermitianBand),
                 "heev: A must be Hermitian/symmetric")
    method = get_option(opts, Option.MethodEig, MethodEig.Auto)
    if method is MethodEig.Auto:
        from ..tune.select import tuned_method
        cached = tuned_method("heev", "eig", opts=opts,
                              option=Option.MethodEig,
                              n=A.shape[0], dtype=A.dtype)
        if cached is not None and cached is not MethodEig.Auto:
            method = cached
        grid = option_grid(opts, "heev")
        if grid is not None:
            # the route decides the grid's collectives: grid rank 0's
            from ..parallel.collectives import agree
            members = list(MethodEig)
            method = members[agree(grid, members.index(method))[0]]
    if method is MethodEig.QRIteration:
        return _heev_two_stage(A, opts, want_vectors, use_dc=False)
    if method is MethodEig.DC:
        return _heev_two_stage(A, opts, want_vectors, use_dc=True)
    # the reference's spectral D&C runs on a TPU only (eig.py:86); the
    # card is not one, so Auto is the library eigensolver
    w, v = library_eigh(A.to_dense())
    order = torch.argsort(w, stable=True)
    w = w[order]
    if not want_vectors:
        return EigResult(w, None)
    r = A.resolve()
    return EigResult(w, _tm(v[:, order], r.mb, r.nb))


def _heev_two_stage(A: TiledMatrix, opts, want_vectors: bool,
                    use_dc: bool) -> EigResult:
    """The staged pipeline (heev.cc): he2hb, hb2st, then the
    tridiagonal solver with the two-step back-transform; values only
    skips both transform accumulations."""
    from ..utils.trace import phases
    ph = phases(opts)
    with ph("heev::he2hb"):
        Band, Q1 = he2hb(A, opts, want_q=want_vectors)
    with ph("heev::hb2st"):
        tri = hb2st(Band, opts, want_q=want_vectors)
    if not want_vectors:
        with ph("heev::sterf"):
            return EigResult(sterf(tri.d, tri.e, opts), None)
    solver = stedc if use_dc else steqr2
    with ph("heev::unmtr_he2hb"):
        Qfull = unmtr_he2hb(Q1, tri.Q, opts) if tri.Q is not None else Q1
    with ph("heev::stedc" if use_dc else "heev::steqr2"):
        w, V = solver(tri.d, tri.e, Qfull, opts)
    return EigResult(w, V)


def syev(A: TiledMatrix, opts: OptionsLike = None,
         want_vectors: bool = True) -> EigResult:
    """Reference slate.hh:1115."""
    return heev(A, opts, want_vectors)


def eig_vals(A: TiledMatrix, opts: OptionsLike = None):
    """Simplified-API name (simplified_api.hh:695-800)."""
    return heev(A, opts, want_vectors=False).values


# -- generalized problems -------------------------------------------------------

def _solve_lh(l, b, left=True):
    """X with L^H X = B (left) or X L^H = B, L lower triangular."""
    return solve_triangular(l.mH, b, upper=True, left=left)


def _hegst_blocked_lower(a: torch.Tensor, l: torch.Tensor, nb: int
                         ) -> torch.Tensor:
    """Blocked two-sided reduction C = L^-1 A L^-H in nb-panels (the
    reference's blocked transform, src/hegst.cc; LAPACK dsygst itype=1
    Lower block structure)."""
    a = a.clone()
    n = a.shape[0]
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        A11, mid, A21 = _hegst_step(a[k0:, k0:k1], l, k0, k1)
        a[k0:k1, k0:k1] = A11
        if k1 < n:
            upd = l[k1:, k0:k1] @ mid.mH
            a[k1:, k1:] -= upd + upd.mH
            a[k1:, k0:k1] = A21
    return torch.tril(a) + torch.tril(a, -1).mH


def _hegst_grid(a: torch.Tensor, l: torch.Tensor, nb: int, grid,
                tiles) -> torch.Tensor:
    """_hegst_blocked_lower owner-computes (reference eig.py:178-230
    with its her2k constraint): the current column block is gathered,
    the diagonal's owner runs the block's solves and both half
    corrections and publishes A11, the mid A21 (the her2k operand) and
    the finished A21; each rank applies the her2k update to its own
    tiles (`tiles`: A's tiling)."""
    from ..parallel import owner as own
    a = a.clone()
    n = a.shape[0]
    o = own.Owner(grid, tuple(a.shape), tiles[0], tiles[1], a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        A11, mid, A21 = own.step(
            o, a, slice(k0, n), slice(k0, k1),
            lambda col: _hegst_step(col, l, k0, k1),
            [((w, w), a.dtype)] + [((n - k1, w), a.dtype)] * 2)
        a[k0:k1, k0:k1] = A11
        if k1 < n:
            L21 = l[k1:, k0:k1]
            own.update(o, a, k1, n, k1, n, L21, mid.mH)
            own.update(o, a, k1, n, k1, n, mid, L21.mH)
            a[k1:, k0:k1] = A21
    return torch.tril(a) + torch.tril(a, -1).mH


def _hegst_step(col: torch.Tensor, l: torch.Tensor, k0: int, k1: int):
    """One block step of the two-sided reduction on the column block
    col = a[k0:, k0:k1]: (A11 <- L11^-1 A11 L11^-H, the mid A21 that
    the her2k update takes, the finished A21 <- L22^-1 (A21 - corr))."""
    w = k1 - k0
    L11 = l[k0:k1, k0:k1]
    t = solve_triangular(L11, col[:w], upper=False)
    A11 = solve_triangular(L11, t.mH, upper=False).mH
    if col.shape[0] == w:
        return A11, col[w:], col[w:]
    L21 = l[k1:, k0:k1]
    corr = 0.5 * (L21 @ A11)
    mid = _solve_lh(L11, col[w:], left=False) - corr
    A21 = solve_triangular(l[k1:, k1:], mid - corr, upper=False)
    return A11, mid, A21


def hegst(itype: int, A: TiledMatrix, B: TiledMatrix,
          opts: OptionsLike = None) -> TiledMatrix:
    """Reduce the generalized problem to standard form (reference
    src/hegst.cc); B is the Cholesky factor from potrf. itype 1:
    C = L^-1 A L^-H (the blocked form on an explicit BlockSize, else
    two whole-matrix solves); itype 2/3: C = L^H A L."""
    slate_assert(itype in (1, 2, 3), "hegst: itype in {1,2,3}")
    grid = option_grid(opts, "hegst")
    a = A.to_dense()
    rl = B.resolve()
    lower = rl.uplo is Uplo.Lower
    l = rl.to_dense()
    if itype == 1:
        if lower:
            explicit_nb = int(get_option(opts, Option.BlockSize, 0))
            nb = explicit_nb or rl.nb
            # blocked where it buys something: under a grid (the her2k
            # updates divide) or on explicit request
            if a.shape[0] > nb and (grid is not None or explicit_nb):
                ra = A.resolve()
                c = _hegst_grid(a, l, nb, grid, (ra.mb, ra.nb)) \
                    if grid is not None else _hegst_blocked_lower(a, l, nb)
            else:
                t = solve_triangular(l, a, upper=False)
                c = solve_triangular(l, t.mH, upper=False).mH
        else:
            # B = U^H U: C = U^-H A U^-1
            t = solve_triangular(l.mH, a, upper=False)
            c = solve_triangular(l.mH, t.mH, upper=False).mH
    elif lower:
        c = (l.mH @ a) @ l
    else:
        c = (l @ a) @ l.mH
    out = _store(dataclasses.replace(A.resolve()), c)
    return dataclasses.replace(out, mtype=A.mtype)


@instrument_driver("hegv")
def hegv(itype: int, A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None, want_vectors: bool = True) -> EigResult:
    """Generalized Hermitian eigenproblem (reference src/hegv.cc):
    potrf(B), hegst, heev, back-transform."""
    L = potrf(B, opts)
    C = hegst(itype, A, L, opts)
    w, V = heev(C, opts, want_vectors)
    if not want_vectors:
        return EigResult(w, None)
    rl = L.resolve()
    lower = rl.uplo is Uplo.Lower
    l = rl.to_dense()
    v = V.to_dense()
    if itype in (1, 2):
        # x = L^-H y (or U^-1 y)
        x = _solve_lh(l, v) if lower \
            else solve_triangular(l, v, upper=True)
    else:
        # itype 3: x = L y (or U^H y)
        x = l @ v if lower else l.mH @ v
    return EigResult(w, _store(V, x))


def sygv(itype: int, A: TiledMatrix, B: TiledMatrix,
         opts: OptionsLike = None, want_vectors: bool = True) -> EigResult:
    return hegv(itype, A, B, opts, want_vectors)


# -- stage 1: full -> band ----------------------------------------------------

def _householder_tridiag(a: torch.Tensor, want_q: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """Householder tridiagonalization of a dense Hermitian a (LAPACK
    sytrd contract), column by column, optionally accumulating Q; a
    final diagonal phase similarity makes the subdiagonal |e|."""
    n = a.shape[0]
    dev, dt = a.device, a.dtype
    q = torch.eye(n if want_q else 1, dtype=dt, device=dev)
    rows = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for j in range(n - 2):
        x = torch.where(rows > j, a[:, j], zero)
        v, tau, _ = reflect(x, rows, j + 1)
        w = tau * (a @ v)
        k = 0.5 * tau * torch.vdot(v, w)
        w = w - k * v
        a = a - torch.outer(w, v.conj()) - torch.outer(v, w.conj())
        if want_q:
            q = q - tau * torch.outer(q @ v, v.conj())
    d = torch.diagonal(a).real
    esub = torch.diagonal(a, -1)
    mag = esub.abs()
    one = torch.ones((), dtype=mag.dtype, device=dev)
    phase = torch.where(mag == 0, one.to(dt),
                        esub / torch.where(mag == 0, one, mag))
    dphase = torch.cat([torch.ones(1, dtype=dt, device=dev),
                        torch.cumprod(phase, 0)])
    e = mag.to(d.dtype)
    return d, e, (q * dphase[None, :] if want_q else None)


def he2hb(A: TiledMatrix, opts: OptionsLike = None, want_q: bool = True):
    """Stage 1: full -> band of width nb (reference src/he2hb.cc):
    blocked panel QR (the library geqrf where the dtype allows) and
    compact-WY two-sided trailing updates
    (A <- A - X V^H - V X^H, X = A V T - (1/2) V (T^H V^H A V T)).
    Returns (band, Q) with A = Q B Q^H; Q is None without want_q."""
    r = A.resolve()
    nb, n = r.mb, r.n
    a = A.to_dense().clone()
    dev, dt = a.device, a.dtype
    q = torch.eye(n if want_q else 1, dtype=dt, device=dev)
    for k in range(ceil_div(max(n, 1), nb) - 1):
        k0, k1 = k * nb, min((k + 1) * nb, n)
        if n - k1 <= 0:
            break
        w = k1 - k0
        packed, taus = _qr_panel_blocked(a[k1:, k0:k1])
        V = _panel_V(packed, 0)
        T = _larft(V, taus)
        a[k1:, k0:k1] = 0
        a[k1:k1 + w, k0:k1] = torch.triu(packed[:w])
        S = a[k1:, k1:]
        W = (S @ V) @ T
        X = W - 0.5 * (V @ (T.mH @ (V.mH @ W)))
        a[k1:, k1:] = S - X @ V.mH - V @ X.mH
        if want_q:
            Qc = q[:, k1:]
            q[:, k1:] = Qc - ((Qc @ V) @ T) @ V.mH
    B = HermitianBandMatrix(Uplo.Lower, min(nb, max(n - 1, 0)),
                            torch.tril(a), mb=r.mb, device=dev)
    return B, (_tm(q, r.mb, r.nb) if want_q else None)


# -- stage 2: band -> tridiagonal --------------------------------------------

def hb2st(B: TiledMatrix, opts: OptionsLike = None,
          want_q: bool = True) -> TridiagResult:
    """Stage 2: band -> tridiagonal (reference src/hb2st.cc). Band
    width 1 is the identity extraction; 2 <= kd <= n/3 takes the
    windowed bulge chase (band.hb2st_band); wider bands the dense
    Householder loop. Returns the tridiagonal and this stage's own
    transform Q2 (the full back-transform is
    unmtr_he2hb(Q_stage1, Q2))."""
    b = B.to_dense()
    kd = max(B.kl, B.ku)
    if kd <= 1:
        return TridiagResult(torch.diagonal(b).real,
                             torch.diagonal(b, -1).real, None)
    r = B.resolve()
    # the reference takes the chase off the TPU (eig.py:519, and warns
    # at :531 on a TPU only); the card is not one
    if 2 <= kd <= r.n // 3:
        from .band import hb2st_band
        d, e, q = hb2st_band(b, r.n, kd, want_q=want_q)
    else:
        d, e, q = _householder_tridiag(b, want_q=want_q)
    return TridiagResult(d, e, _tm(q, r.mb, r.nb) if want_q else None)


# -- stage 3: the tridiagonal solvers ------------------------------------------

def sterf(d, e, opts: OptionsLike = None, device: DeviceLike = None):
    """Tridiagonal eigenvalues, no vectors (reference src/sterf.cc):
    the library's values-only eigensolver (``torch.linalg.eigvalsh``)
    of the dense tridiagonal, ascending. (The reference calls
    ``eigh_tridiagonal``, which torch lacks.)"""
    d, e = _vec(d, device), _vec(e, device)
    t = torch.diag(d)
    if d.shape[0] > 1:
        t = t + torch.diag(e, 1) + torch.diag(e, -1)
    return library_eigh(t, eigenvectors=False)


def steqr2_qr(d: torch.Tensor, e: torch.Tensor,
              z0: Optional[torch.Tensor] = None, maxit_factor: int = 30):
    """Symmetric tridiagonal eigensolver by shifted implicit QR
    ITERATION (reference src/dsteqr2.f driven by src/steqr2.cc): while
    an off-diagonal is above tolerance and the pass count is below
    maxit_factor * n, one pass (clamp, block [ll, m], Wilkinson shift,
    chase), then Z <- Z G with G the pass's composed rotation chain.
    The passes run in ops/kernels.steqr_sweeps launches of up to
    STEQR_PASSES_PER_LAUNCH passes, each given what is left of the cap;
    the chains are applied in pass order after each launch, so w, Z
    and info are bitwise what one launch a pass gives.
    ``steqr2_qr.passes`` counts the passes run.

    z0: optional initial transform (rows, n) the passes accumulate onto
    (the identity by default), e.g. the caller's back-transform Q.

    Returns (w, Z, info) ascending with Z = z0 @ (accumulated
    rotations), so for z0 = I, tridiag(d, e) = Z diag(w) Z^T; info
    counts the off-diagonals still above tolerance at the cap (LAPACK
    steqr INFO; a 0-d int32 tensor)."""
    n = d.shape[0]
    dt, dev = d.dtype, d.device
    if z0 is None:
        Z = torch.eye(n, dtype=dt, device=dev)
    else:
        Z = z0.to(torch.promote_types(z0.dtype, dt))
    apply_chain = _select_chain_apply("steqr2", Z.shape[0], n, dt, dev)
    cap, it, count = maxit_factor * n, 0, 0
    while n > 1:
        d, e, cs, sn, ran = pk.steqr_sweeps(
            d, e, min(pk.STEQR_PASSES_PER_LAUNCH, cap - it))
        passes, count = ran.tolist()        # the launch's one host read
        for q in range(passes):
            # the sweep computes T' = G^T T G: the eigenvectors
            # accumulate on the right, Z <- Z G
            if apply_chain is not None:
                Z = apply_chain(Z, cs[q], sn[q])
            else:
                Z = Z @ _givens_chain_matrix(cs[q], sn[q], n,
                                             dt).to(Z.dtype)
        it += passes
        steqr2_qr.passes += passes
        if count == 0 or it >= cap:
            break
    order = torch.argsort(d, stable=True)
    return d[order], Z[:, order], torch.tensor(count, dtype=torch.int32,
                                              device=dev)


steqr2_qr.passes = 0


@instrument_driver("steqr2")
def steqr2(d, e, Q: Optional[TiledMatrix] = None,
           opts: OptionsLike = None, want_vectors: bool = True,
           device: DeviceLike = None):
    """Tridiagonal QR iteration driver (reference src/steqr2.cc): the
    QR iteration at every n for real types, accumulating onto Q when
    given (the dsteqr2.f slot); complex types take stedc (with the
    reference's warning); values only take sterf. numpy inputs go to
    `device` (the card unless named)."""
    d, e = _vec(d, device), _vec(e, device)
    if not want_vectors:
        slate_assert(Q is None, "steqr2: want_vectors=False cannot apply Q")
        return sterf(d, e, opts), None
    n = d.shape[0]
    if n <= 1 or d.is_complex():
        if n > 1:
            warnings.warn(
                "steqr2: dtype %s is complex; the divide & conquer solver "
                "(stedc) runs instead. Spectra match; deflation "
                "tolerances differ in ulps." % d.dtype, stacklevel=2)
        return stedc(d, e, Q, opts)
    grid = option_grid(opts, "steqr2")
    z0 = Q.to_dense() if Q is not None else None
    if grid is not None:
        from ..dist.steqr2 import steqr2_qr_dist
        from ..parallel.sharding import assemble
        w, Zl, _info = steqr2_qr_dist(grid, d, e, z0=z0)
        rows = n if z0 is None else z0.shape[0]
        Z = assemble(grid, Zl, (Zl.shape[0] * grid.nprocs, n),
                     grid.row_sharding())[:rows]
        return w, (_store(Q, Z) if Q is not None else Z)
    if n > 2048:
        warnings.warn(
            "steqr2: n=%d single-device QR iteration accumulates ~2n^3 "
            "flops PER SWEEP over O(n) sweeps. It runs as requested; "
            "stedc is the O(n^3) D&C." % n, stacklevel=2)
    w, Z, _info = steqr2_qr(d, e, z0=z0)
    if Q is not None:
        return w, _store(Q, Z)
    return w, Z


@instrument_driver("stedc")
def stedc(d, e, Q: Optional[TiledMatrix] = None,
          opts: OptionsLike = None, device: DeviceLike = None):
    """Divide & conquer tridiagonal eigensolver (reference src/stedc.cc;
    linalg/stedc.py has the phases), then the Q back-transform as one
    product. The leaf size is a tunable ('stedc', 'leaf'; frozen
    default 32)."""
    from ..tune.select import tuned_int
    from .stedc import stedc_solve
    d, e = _vec(d, device), _vec(e, device)
    leaf = tuned_int("stedc", "leaf", 32, opts=opts, n=d.shape[0],
                     dtype=d.dtype)
    grid = option_grid(opts, "stedc")
    if grid is not None:
        from ..parallel.collectives import agree
        (leaf,) = agree(grid, leaf)         # the split is grid rank 0's
    if grid is not None and d.shape[0] > leaf:
        from ..dist.stedc import matmul_sharded, stedc_solve_dist
        w, v = stedc_solve_dist(grid, d, e, leaf=leaf)
        if Q is not None:
            return w, _store(Q, matmul_sharded(grid, Q.to_dense(),
                                               v.to(Q.dtype)))
        return w, v
    w, v = stedc_solve(d, e, leaf=leaf)
    if Q is not None:
        return w, _store(Q, Q.to_dense() @ v.to(Q.dtype))
    return w, v


# -- back-transforms -------------------------------------------------------------

def unmtr_he2hb(Q: TiledMatrix, C: TiledMatrix,
                opts: OptionsLike = None) -> TiledMatrix:
    """Apply the stage-1 transform to C (reference src/unmtr_he2hb.cc):
    he2hb returns Q accumulated, so one product."""
    return _store(C, Q.to_dense() @ C.to_dense())


def unmtr_hb2st(V: TiledMatrix, C: TiledMatrix,
                opts: OptionsLike = None) -> TiledMatrix:
    """Apply the stage-2 transform (reference src/unmtr_hb2st.cc)."""
    return unmtr_he2hb(V, C, opts)

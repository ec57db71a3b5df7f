"""scipy.linalg-compatible shim (counterpart of
``slate_tpu/api/lapack_compat.py``; reference lapack_api/): numpy in,
numpy out, the port's drivers underneath, the work on `device` (the
CUDA card unless the caller passes ``device="cpu"``: the one keyword
each function adds to scipy's signature).

Signatures follow scipy.linalg where the reference intercepts the
corresponding LAPACK entry; only the commonly used argument subsets are
supported (unsupported combinations raise, never silently diverge).

Stacked inputs (ndim > 2, numpy broadcasting convention): cholesky,
lu_factor, solve (gen / pos), eigh and inv route stacked matrices
through the batch layer (``slate_tpu_torch/batch/``: bucketed or, under
an earned ``batch/strategy`` = "ragged" tune row, the ragged kernels),
as the reference's do. The routes that stay 2-D only (lstsq,
lu_solve, solve_triangular, svdvals, and solve with 'sym' / 'her')
raise a ValueError that names the alternative.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.backend import DeviceLike


def _st():
    import slate_tpu_torch as st
    return st


def _nb(n: int) -> int:
    return min(max(int(n), 1), 256)


def _np(x) -> np.ndarray:
    """A tensor (or TiledMatrix's dense view) on the host as numpy."""
    if not isinstance(x, torch.Tensor):
        x = x.to_dense()
    return x.detach().cpu().numpy()


def _batch_run(op, a, rhs=None, device: DeviceLike = None):
    """Route a stacked (..., m, n) input through the batch layer: the
    leading dims flatten to one batch, each slice coalesces into the
    batched dispatch, the results restack. Returns the per-slice results
    (CPU tensors) and the leading shape. Mixed a / rhs dtypes promote
    numpy-style here (the queue itself refuses a mismatched rhs)."""
    from .. import batch
    lead = a.shape[:-2]
    if rhs is not None:
        dt = np.result_type(a, rhs)
        a, rhs = a.astype(dt, copy=False), rhs.astype(dt, copy=False)
    mats = list(a.reshape((-1,) + a.shape[-2:]))
    rhss = None
    if rhs is not None:
        rhss = list(rhs.reshape((-1,) + rhs.shape[-2:]))
    return batch.run(op, mats, rhs=rhss, device=device), lead


def _mirror_hermitian(a, lower):
    """The Hermitian matrix a stacked triangular-storage input
    designates (scipy: only the `lower`-selected triangle is
    referenced, the other may hold garbage). The batch cores read the
    whole array, so the unreferenced triangle is rebuilt from the
    referenced one before dispatch (the 2-D paths get this from
    HermitianMatrix(uplo, ...) / to_dense)."""
    if lower:
        return np.tril(a) + np.conj(np.swapaxes(np.tril(a, -1), -1, -2))
    return np.triu(a) + np.conj(np.swapaxes(np.triu(a, 1), -1, -2))


def _no_batch(name: str, why: str):
    """The ndim > 2 refusal of the routes that stay 2-D only."""
    raise ValueError(
        f"{name}: batched (ndim > 2) input is not supported — {why}. "
        "For uniform-shape stacks use slate_tpu_torch.batch directly "
        "(CoalescingQueue / batch.run); otherwise loop the 2-D call.")


def cholesky(a, lower=False, overwrite_a=False, check_finite=True,
             device: DeviceLike = None):
    """scipy.linalg.cholesky (LAPACK potrf). Stacked (..., n, n) input
    routes through the batch layer."""
    st = _st()
    a = np.asarray(a)
    if a.ndim > 2:
        outs, lead = _batch_run("potrf", _mirror_hermitian(a, lower),
                                device=device)
        ls = np.stack([_np(L) for L in outs])
        if not np.isfinite(ls).all():
            raise np.linalg.LinAlgError(
                "a stacked matrix is not positive definite")
        if not lower:
            ls = np.conj(np.swapaxes(ls, -1, -2))
        return ls.reshape(a.shape)
    n = a.shape[0]
    uplo = st.Uplo.Lower if lower else st.Uplo.Upper
    L, info = st.potrf(st.HermitianMatrix(uplo, a, mb=_nb(n),
                                          device=device),
                       return_info=True)
    if int(info) != 0:
        raise np.linalg.LinAlgError(
            f"{int(info)}-th leading minor not positive definite")
    out = L.to_numpy()
    return np.tril(out) if lower else np.triu(out)


def lu_factor(a, overwrite_a=False, check_finite=True,
              device: DeviceLike = None):
    """scipy.linalg.lu_factor (LAPACK getrf): (lu, piv). Stacked square
    input routes through the batch layer."""
    st = _st()
    a = np.asarray(a)
    if a.ndim > 2:
        if a.shape[-2] != a.shape[-1]:
            _no_batch("lu_factor", "the batch getrf route is "
                      "square-only")
        outs, lead = _batch_run("getrf", a, device=device)
        lus = np.stack([_np(lu) for lu, _ in outs])
        pivs = np.stack([_np(p) for _, p in outs])
        return (lus.reshape(a.shape),
                pivs.reshape(lead + pivs.shape[-1:]))
    F = st.getrf(st.Matrix(a, mb=_nb(a.shape[0]), device=device))
    n = min(a.shape)
    return F.LU.to_numpy()[: a.shape[0], : a.shape[1]], \
        _np(F.pivots)[:n]


def lu_solve(lu_and_piv, b, trans=0, overwrite_b=False,
             check_finite=True, device: DeviceLike = None):
    """scipy.linalg.lu_solve (LAPACK getrs)."""
    st = _st()
    import dataclasses

    from ..core.enums import MatrixType, Op
    from ..linalg.lu import LUFactors
    lu, piv = lu_and_piv
    lu = np.asarray(lu)
    b = np.asarray(b)
    if lu.ndim > 2 or b.ndim > 2:
        _no_batch("lu_solve", "stacked factors would need a batched "
                  "getrs; factor+solve together batches via "
                  "solve(..., assume_a='gen')")
    n = lu.shape[0]
    nb = _nb(n)
    LU = dataclasses.replace(
        st.TiledMatrix.from_dense(lu, nb, device=device),
        mtype=MatrixType.General)
    pivots = np.arange(max(n, 1), dtype=np.int32)
    pivots[: len(piv)] = piv
    F = LUFactors(LU, torch.as_tensor(pivots, device=LU.device))
    op = {0: Op.NoTrans, 1: Op.Trans, 2: Op.ConjTrans}[trans]
    b2 = b[:, None] if b.ndim == 1 else b
    X = st.getrs(F, st.TiledMatrix.from_dense(b2, nb, device=device),
                 trans=op)
    x = X.to_numpy()
    return x[:, 0] if b.ndim == 1 else x


def solve(a, b, assume_a="gen", lower=False, overwrite_a=False,
          overwrite_b=False, check_finite=True,
          device: DeviceLike = None):
    """scipy.linalg.solve (gesv / posv / hesv by assume_a). Stacked
    (..., n, n) systems route through the batch layer (gesv / posv;
    'her' / 'sym' stay 2-D: there is no batched indefinite solver)."""
    st = _st()
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim > 2:
        if assume_a not in ("gen", "pos"):
            _no_batch("solve", f"assume_a={assume_a!r} has no batched "
                      "driver (gen and pos do)")
        squeeze = b.ndim == a.ndim - 1
        b3 = b[..., None] if squeeze else b
        if b3.shape[: a.ndim - 2] != a.shape[:-2]:
            _no_batch("solve", "rhs leading dims must match the "
                      "matrix stack")
        a3 = _mirror_hermitian(a, lower) if assume_a == "pos" else a
        outs, lead = _batch_run("posv" if assume_a == "pos" else "gesv",
                                a3, rhs=b3, device=device)
        xs = np.stack([_np(x) for x in outs])
        if not np.isfinite(xs).all():
            raise np.linalg.LinAlgError(
                "a stacked matrix is not positive definite"
                if assume_a == "pos" else
                "a stacked matrix is singular")
        xs = xs.reshape(lead + xs.shape[-2:])
        return xs[..., 0] if squeeze else xs
    nb = _nb(a.shape[0])
    b2 = b[:, None] if b.ndim == 1 else b
    B = st.TiledMatrix.from_dense(b2, nb, device=device)
    uplo = st.Uplo.Lower if lower else st.Uplo.Upper
    if assume_a == "pos":
        _, X, info = st.posv(st.HermitianMatrix(uplo, a, mb=nb,
                                                device=device), B,
                             return_info=True)
        if int(info) != 0:
            raise np.linalg.LinAlgError("matrix not positive definite")
    elif assume_a in ("her", "sym"):
        # symmetric-indefinite solver (reference hesv / sysv)
        _, X = st.hesv(st.HermitianMatrix(uplo, a, mb=nb, device=device),
                       B)
    elif assume_a == "gen":
        F, X = st.gesv(st.Matrix(a, mb=nb, device=device), B)
        if int(F.info) != 0:
            raise np.linalg.LinAlgError("singular matrix")
    else:
        raise NotImplementedError(f"assume_a={assume_a!r}")
    x = X.to_numpy()
    return x[:, 0] if b.ndim == 1 else x


def solve_triangular(a, b, trans=0, lower=False, unit_diagonal=False,
                     overwrite_b=False, check_finite=True,
                     device: DeviceLike = None):
    """scipy.linalg.solve_triangular (LAPACK trtrs)."""
    st = _st()
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim > 2:
        _no_batch("solve_triangular", "triangular solves of a stack are "
                  "one batched library call; torch.linalg."
                  "solve_triangular on the stack is the direct route")
    nb = _nb(a.shape[0])
    uplo = st.Uplo.Lower if lower else st.Uplo.Upper
    diag = st.Diag.Unit if unit_diagonal else st.Diag.NonUnit
    T = st.TriangularMatrix(uplo, a, mb=nb, diag=diag, device=device)
    if trans == 1:
        T = T.transpose()
    elif trans == 2:
        T = T.conj_transpose()
    b2 = b[:, None] if b.ndim == 1 else b
    X = st.trsm(st.Side.Left, 1.0, T,
                st.TiledMatrix.from_dense(b2, nb, device=device))
    x = X.to_numpy()
    return x[:, 0] if b.ndim == 1 else x


def lstsq(a, b, cond=None, overwrite_a=False, overwrite_b=False,
          check_finite=True, lapack_driver=None,
          device: DeviceLike = None):
    """scipy.linalg.lstsq (LAPACK gels): (x, resid, rank, s) with rank
    and s None (gels assumes full rank, as the reference). 2-D only:
    scipy's contract ties each matrix to its own right-hand side, which
    stacked callers almost always carry ragged; batch.gels_batched
    serves the uniform case."""
    st = _st()
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim > 2 or b.ndim > 2:
        _no_batch("lstsq", "per-item rhs is ragged in general; "
                  "uniform overdetermined stacks go through "
                  "slate_tpu_torch.batch.gels_batched / "
                  "batch.run('gels')")
    m, n = a.shape
    nb = _nb(m)
    b2 = b[:, None] if b.ndim == 1 else b
    X = st.gels(st.Matrix(a, mb=nb, device=device),
                st.TiledMatrix.from_dense(b2, nb, device=device))
    x = X.to_numpy()[:n]
    resid = np.linalg.norm(b2 - a @ x, axis=0) ** 2 if m > n else \
        np.empty((0,))
    return (x[:, 0] if b.ndim == 1 else x), resid, None, None


def eigh(a, lower=True, eigvals_only=False, overwrite_a=False,
         check_finite=True, device: DeviceLike = None):
    """scipy.linalg.eigh (LAPACK heev) for the standard problem.
    Stacked (..., n, n) input routes through the batch layer."""
    st = _st()
    a = np.asarray(a)
    if a.ndim > 2:
        outs, lead = _batch_run("heev", _mirror_hermitian(a, lower),
                                device=device)
        ws = np.stack([_np(w) for w, _ in outs])
        ws = ws.reshape(lead + ws.shape[-1:])
        if eigvals_only:
            return ws
        vs = np.stack([_np(v) for _, v in outs])
        return ws, vs.reshape(a.shape)
    n = a.shape[0]
    uplo = st.Uplo.Lower if lower else st.Uplo.Upper
    A = st.HermitianMatrix(uplo, a, mb=_nb(n), device=device)
    if eigvals_only:
        return _np(st.heev(A, want_vectors=False).values)[:n]
    w, V = st.heev(A)
    return _np(w)[:n], V.to_numpy()


def svdvals(a, overwrite_a=False, check_finite=True,
            device: DeviceLike = None):
    """scipy.linalg.svdvals."""
    st = _st()
    a = np.asarray(a)
    if a.ndim > 2:
        _no_batch("svdvals", "no batched SVD driver yet (the staged "
                  "svd pipeline is single-matrix)")
    return _np(st.svd_vals(st.Matrix(a, mb=_nb(a.shape[0]),
                                     device=device)))


def inv(a, overwrite_a=False, check_finite=True,
        device: DeviceLike = None):
    """scipy.linalg.inv (getrf + getri). Stacked input routes through
    the batched gesv against a stacked identity."""
    st = _st()
    a = np.asarray(a)
    if a.ndim > 2:
        n = a.shape[-1]
        if a.shape[-2] != n:
            _no_batch("inv", "stacked matrices must be square")
        eye = np.broadcast_to(np.eye(n, dtype=a.dtype), a.shape).copy()
        outs, lead = _batch_run("gesv", a, rhs=eye, device=device)
        xs = np.stack([_np(x) for x in outs])
        if not np.isfinite(xs).all():
            raise np.linalg.LinAlgError("a stacked matrix is singular")
        return xs.reshape(a.shape)
    F = st.getrf(st.Matrix(a, mb=_nb(a.shape[0]), device=device))
    if int(F.info) != 0:
        raise np.linalg.LinAlgError("singular matrix")
    return st.getri(F).to_numpy()

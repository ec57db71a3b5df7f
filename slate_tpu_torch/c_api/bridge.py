"""Python side of the C API (counterpart of
``slate_tpu/c_api/bridge.py``; reference src/c_api/wrappers.cc role).

Every function receives scalars plus raw host buffer ADDRESSES from the
C shim (slate_c.c), maps them with ctypes/numpy (zero copy), runs the
corresponding driver of the port on the configured device, writes the
results back into the caller's memory, and returns the LAPACK info
code as an int. Row-major (C order) buffers, lda/ldb = row stride in
elements.

This module must stay importable inside a bare embedded interpreter:
only the standard library and numpy at import time; torch and the port
load lazily on first call. The device is the CUDA card unless
``slate_tpu_init`` named another (``set_platform``); without a card,
a call on the default device fails (info -1).
"""

from __future__ import annotations

import ctypes

import numpy as np

_DT = {"s": np.float32, "d": np.float64}

#: slate_tpu_init's platform names -> torch device types
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def _wrap(addr: int, rows: int, cols: int, ld: int, dtype):
    """View caller memory as a (rows, cols) row-major array (stride ld)."""
    if rows <= 0 or cols <= 0:
        return np.empty((max(rows, 0), max(cols, 0)), dtype)
    buf = (ctypes.c_byte * (rows * ld * np.dtype(dtype).itemsize)
           ).from_address(addr)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, ld)[:, :cols]


def _vec(addr: int, n: int, dtype):
    buf = (ctypes.c_byte * (n * np.dtype(dtype).itemsize)
           ).from_address(addr)
    return np.frombuffer(buf, dtype=dtype)


#: the device slate_tpu_init() named (None: the card)
_device = None


def set_platform(platform):
    """Record the device for the drivers (called by slate_c.c at
    initialization): "cpu", "cuda", or "gpu" for "cuda". An unknown
    name raises, which slate_tpu_init reports as -102."""
    global _device
    if platform not in PLATFORMS:
        raise ValueError(f"slate_tpu_init: unknown platform {platform!r} "
                         f"(one of {', '.join(PLATFORMS)})")
    _device = PLATFORMS[platform]
    return 0


def _st():
    """The port, imported lazily, and the device its data goes to."""
    import slate_tpu_torch as st
    return st, _device


def _nb(n: int) -> int:
    return min(max(n, 1), 256)


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def _fail():
    import traceback
    traceback.print_exc()
    return -1


def potrf(dtype, n, a_addr, lda):
    try:
        st, dev = _st()
        a = _wrap(a_addr, n, n, lda, _DT[dtype])
        A = st.HermitianMatrix(st.Uplo.Lower, np.ascontiguousarray(a),
                               mb=_nb(n), device=dev)
        L, info = st.potrf(A, return_info=True)
        a[:] = np.tril(L.to_numpy())
        return int(info)
    except Exception:
        return _fail()


def gesv(dtype, n, nrhs, a_addr, lda, ipiv_addr, b_addr, ldb):
    if n == 0 or nrhs == 0:
        return 0                    # LAPACK quick return
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, n, n, lda, dt)
        b = _wrap(b_addr, n, nrhs, ldb, dt)
        nb = _nb(n)
        F, X = st.gesv(
            st.Matrix(np.ascontiguousarray(a), mb=nb, device=dev),
            st.TiledMatrix.from_dense(np.ascontiguousarray(b), nb,
                                      device=dev))
        a[:] = F.LU.to_numpy()
        b[:] = X.to_numpy()
        _vec(ipiv_addr, n, np.int32)[:] = _np(F.pivots)[:n]
        return int(F.info)
    except Exception:
        return _fail()


def posv(dtype, n, nrhs, a_addr, lda, b_addr, ldb):
    if n == 0 or nrhs == 0:
        return 0                    # LAPACK quick return
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, n, n, lda, dt)
        b = _wrap(b_addr, n, nrhs, ldb, dt)
        nb = _nb(n)
        A = st.HermitianMatrix(st.Uplo.Lower, np.ascontiguousarray(a),
                               mb=nb, device=dev)
        L, X, info = st.posv(
            A, st.TiledMatrix.from_dense(np.ascontiguousarray(b), nb,
                                         device=dev),
            return_info=True)
        if int(info) == 0:
            a[:] = np.tril(L.to_numpy())
            b[:] = X.to_numpy()
        return int(info)
    except Exception:
        return _fail()


def gemm(dtype, m, n, k, alpha, a_addr, lda, b_addr, ldb, beta,
         c_addr, ldc):
    if m == 0 or n == 0:
        return 0                    # LAPACK quick return
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, m, k, lda, dt)
        b = _wrap(b_addr, k, n, ldb, dt)
        c = _wrap(c_addr, m, n, ldc, dt)
        nb = _nb(max(m, n, k))
        C = st.gemm(dt(alpha),
                    st.Matrix(np.ascontiguousarray(a), mb=nb, device=dev),
                    st.Matrix(np.ascontiguousarray(b), mb=nb, device=dev),
                    dt(beta),
                    st.TiledMatrix.from_dense(np.ascontiguousarray(c), nb,
                                              device=dev))
        c[:] = C.to_numpy()
        return 0
    except Exception:
        return _fail()


def gels(dtype, m, n, nrhs, a_addr, lda, b_addr, ldb):
    if m == 0 or n == 0 or nrhs == 0:
        return 0                    # LAPACK quick return
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, m, n, lda, dt)
        b = _wrap(b_addr, m, nrhs, ldb, dt)
        nb = _nb(m)
        X = st.gels(
            st.Matrix(np.ascontiguousarray(a), mb=nb, device=dev),
            st.TiledMatrix.from_dense(np.ascontiguousarray(b), nb,
                                      device=dev))
        b[:n] = X.to_numpy()[:n]
        return 0
    except Exception:
        return _fail()


def heev(dtype, n, a_addr, lda, w_addr):
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, n, n, lda, dt)
        A = st.HermitianMatrix(st.Uplo.Lower, np.ascontiguousarray(a),
                               mb=_nb(n), device=dev)
        w, V = st.heev(A)
        _vec(w_addr, n, dt)[:] = _np(w)[:n].astype(dt)
        a[:] = V.to_numpy()
        return 0
    except Exception:
        return _fail()


def svd_vals(dtype, m, n, a_addr, lda, s_addr):
    try:
        st, dev = _st()
        dt = _DT[dtype]
        a = _wrap(a_addr, m, n, lda, dt)
        s = st.svd_vals(st.Matrix(np.ascontiguousarray(a), mb=_nb(m),
                                  device=dev))
        k = min(m, n)
        _vec(s_addr, k, dt)[:] = _np(s)[:k].astype(dt)
        return 0
    except Exception:
        return _fail()

"""Native (C++) host-side layout engine (counterpart of
``slate_tpu/native/__init__.py``).

``layout.cc`` (the port's own copy) is compiled with ``g++ -O3
-fopenmp -shared -fPIC`` at first use into ``build/`` at the root of
the checkout, never next to its source; the library's name carries a
hash of the source and flags, so an edited source is rebuilt. It loads
through ``ctypes``. A failed build or load RAISES: it never quietly
takes the numpy path. The numpy loops stay as the plain versions,
under ``_plain`` names, for a caller that asks for them (the tests
hold the library to them bitwise).

The library is built for f32 and f64; other dtypes have no native
entry and take the plain loop, as in the reference. Inputs in another
memory order than an entry reads are copied into it first.

OpenMP: torch's CPU build ships its own ``libgomp.so.1``; the library
names the same soname, so the dynamic loader hands it the runtime
torch already loaded instead of a second one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "layout.cc")
#: portable: a library built on one host must not SIGILL on another
CXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
ABI_VERSION = 1

_I64, _P = ctypes.c_int64, ctypes.c_void_p
#: C entry (less its dtype suffix) -> argtypes
_ENTRIES = {
    "pack_colmajor": [_P, _I64, _I64, _I64, _P, _I64, _I64],
    "unpack_colmajor": [_P, _I64, _I64, _P, _I64, _I64, _I64],
    "bc_import": [_P, _I64, _I64, _P, _I64, _I64, _I64, _I64, _I64,
                  _I64, _I64, _I64, _I64],
    "bc_export": [_P, _I64, _I64, _I64, _P, _I64, _I64, _I64, _I64,
                  _I64, _I64, _I64, _I64],
}
_SUFFIX = {np.dtype(np.float32): "f32", np.dtype(np.float64): "f64"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "liblayout_%s.so" % h.hexdigest()[:12])


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + ".tmp.%d" % os.getpid()
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError("native layout build failed: %s" % e) from e
    if proc.returncode != 0:
        raise RuntimeError("native layout build failed (g++ exited %d):\n%s"
                           % (proc.returncode, proc.stderr))
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded layout library, built first if needed. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError("native layout library %s does not "
                                   "load: %s" % (path, e)) from e
            lib.slate_tpu_native_abi_version.restype = _I64
            lib.slate_tpu_native_abi_version.argtypes = []
            abi = lib.slate_tpu_native_abi_version()
            if abi != ABI_VERSION:
                raise RuntimeError("native layout library ABI %d, want %d"
                                   % (abi, ABI_VERSION))
            for name, argtypes in _ENTRIES.items():
                for suffix in _SUFFIX.values():
                    fn = getattr(lib, "%s_%s" % (name, suffix))
                    fn.argtypes = argtypes
                    fn.restype = None
            _lib = lib
        return _lib


def _entry(name: str, dtype) -> Optional[ctypes._CFuncPtr]:
    """The C entry for `dtype`, or None for a dtype it is not built
    for (module doc)."""
    suffix = _SUFFIX.get(np.dtype(dtype))
    return None if suffix is None else getattr(get_lib(),
                                               "%s_%s" % (name, suffix))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check_grid(m: int, n: int, mb: int, nb: int, p: int, q: int,
                pi: int, qi: int) -> None:
    if min(mb, nb, p, q) < 1 or not (0 <= pi < p and 0 <= qi < q) \
            or min(m, n) < 0:
        raise ValueError("bad block-cyclic descriptor m=%d n=%d mb=%d "
                         "nb=%d p=%d q=%d rank=(%d, %d)"
                         % (m, n, mb, nb, p, q, pi, qi))


def _local_rows(mt: int, p: int, pi: int) -> int:
    """Tile rows of the block-cyclic local on process row pi."""
    return sum(1 for ti in range(mt) if ti % p == pi)


# -- the plain versions ------------------------------------------------------

def pack_colmajor_plain(src: np.ndarray, mpad: int, npad: int
                        ) -> np.ndarray:
    m, n = src.shape
    out = np.zeros((mpad, npad), src.dtype)
    out[:m, :n] = src
    return out


def unpack_colmajor_plain(src: np.ndarray, m: int, n: int) -> np.ndarray:
    return np.asfortranarray(src[:m, :n])


def _tiles(m, n, mb, nb, p, q, pi, qi):
    """(local row, local col, global row, global col, rows, cols) of
    each tile rank (pi, qi) owns."""
    for ti in range(-(-m // mb)):
        for tj in range(-(-n // nb)):
            if ti % p != pi or tj % q != qi:
                continue
            gi, gj = ti * mb, tj * nb
            yield ((ti // p) * mb, (tj // q) * nb, gi, gj,
                   min(mb, m - gi), min(nb, n - gj))


def bc_import_plain(local: np.ndarray, dst: np.ndarray, m: int, n: int,
                    mb: int, nb: int, p: int, q: int, pi: int, qi: int
                    ) -> None:
    for li, lj, gi, gj, hm, hn in _tiles(m, n, mb, nb, p, q, pi, qi):
        dst[gi:gi + hm, gj:gj + hn] = local[li:li + hm, lj:lj + hn]


def bc_export_plain(src: np.ndarray, m: int, n: int, mb: int, nb: int,
                    p: int, q: int, pi: int, qi: int, llm: int, lln: int
                    ) -> np.ndarray:
    local = np.zeros((llm, lln), src.dtype, order="F")
    for li, lj, gi, gj, hm, hn in _tiles(m, n, mb, nb, p, q, pi, qi):
        local[li:li + hm, lj:lj + hn] = src[gi:gi + hm, gj:gj + hn]
    return local


# -- the native entries ------------------------------------------------------

def pack_colmajor(src: np.ndarray, mpad: int, npad: int) -> np.ndarray:
    """Column-major (m, n) -> zero-padded row-major (mpad, npad)
    (reference fromLAPACK layout adoption, Matrix.hh:58)."""
    m, n = src.shape
    if mpad < m or npad < n:
        raise ValueError("pack_colmajor: (%d, %d) does not fit (%d, %d)"
                         % (m, n, mpad, npad))
    fn = _entry("pack_colmajor", src.dtype)
    if fn is None:
        return pack_colmajor_plain(src, mpad, npad)
    src = np.asfortranarray(src)
    out = np.empty((mpad, npad), src.dtype)
    fn(_ptr(src), m, n, max(m, 1), _ptr(out), mpad, npad)
    return out


def unpack_colmajor(src: np.ndarray, m: int, n: int) -> np.ndarray:
    """Padded row-major -> column-major (m, n) (reference in-place
    output adoption for LAPACK-layout users)."""
    mpad, npad = src.shape
    if m > mpad or n > npad:
        raise ValueError("unpack_colmajor: (%d, %d) exceeds (%d, %d)"
                         % (m, n, mpad, npad))
    fn = _entry("unpack_colmajor", src.dtype)
    if fn is None:
        return unpack_colmajor_plain(src, m, n)
    src = np.ascontiguousarray(src)
    out = np.empty((m, n), src.dtype, order="F")
    fn(_ptr(src), mpad, npad, _ptr(out), m, n, max(m, 1))
    return out


def bc_import(local: np.ndarray, dst: np.ndarray, m: int, n: int,
              mb: int, nb: int, p: int, q: int, pi: int, qi: int) -> None:
    """Scatter one rank's ScaLAPACK 2D-block-cyclic local (column-major)
    into the global padded row-major dense `dst`, in place (the
    scalapack_api import path, scalapack_slate.hh:27-29)."""
    _check_grid(m, n, mb, nb, p, q, pi, qi)
    need = (_local_rows(-(-m // mb), p, pi) * mb,
            _local_rows(-(-n // nb), q, qi) * nb)
    if local.shape[0] < need[0] or local.shape[1] < need[1] \
            or dst.shape[0] < m or dst.shape[1] < n:
        raise ValueError("bc_import: local %s (needs %s), dst %s for "
                         "(%d, %d)" % (local.shape, need, dst.shape, m, n))
    if not dst.flags.c_contiguous:
        raise ValueError("bc_import writes a C-contiguous dst in place")
    fn = _entry("bc_import", local.dtype)
    if fn is None or local.dtype != dst.dtype:
        return bc_import_plain(local, dst, m, n, mb, nb, p, q, pi, qi)
    local = np.asfortranarray(local)
    fn(_ptr(local), local.shape[0], local.shape[1], _ptr(dst), m, n,
       dst.shape[1], mb, nb, p, q, pi, qi)


def bc_export(src: np.ndarray, m: int, n: int, mb: int, nb: int,
              p: int, q: int, pi: int, qi: int, llm: int, lln: int
              ) -> np.ndarray:
    """Gather rank (pi, qi)'s block-cyclic local array (column-major,
    llm x lln) from the global padded row-major dense."""
    _check_grid(m, n, mb, nb, p, q, pi, qi)
    need = (_local_rows(-(-m // mb), p, pi) * mb,
            _local_rows(-(-n // nb), q, qi) * nb)
    if llm < need[0] or lln < need[1] or src.shape[0] < m \
            or src.shape[1] < n:
        raise ValueError("bc_export: local (%d, %d) (needs %s), src %s "
                         "for (%d, %d)" % (llm, lln, need, src.shape, m, n))
    fn = _entry("bc_export", src.dtype)
    if fn is None:
        return bc_export_plain(src, m, n, mb, nb, p, q, pi, qi, llm, lln)
    src = np.ascontiguousarray(src)
    local = np.zeros((llm, lln), src.dtype, order="F")
    fn(_ptr(src), m, n, src.shape[1], _ptr(local), llm, lln, mb, nb, p,
       q, pi, qi)
    return local

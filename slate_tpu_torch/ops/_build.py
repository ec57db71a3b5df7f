"""Build and load the hand-written CUDA kernels (no counterpart in the
JAX package, whose Pallas kernels compile inside ``pallas_call``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a`` (Hopper), under
``build/`` at the root of the checkout, at first use. All sources are
compiled at once, one ``nvcc`` process each. The library name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. Libraries load through ``ctypes``;
every C entry returns ``cudaGetLastError()`` and :func:`check` raises
when it is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

#: library -> (source, {C entry: argtypes}); every entry returns int
LIBS = {
    "lu_panel_rec": ("lu_panel_rec.cu", {
        "slate_set_device": [_I],
        "lu_rec_base": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P],
        "lu_rec_solve_leaf": [_P, _I, _I, _I, _I, _I, _I, _P],
        "lu_rec_mm_update": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    }),
    "rank_update": ("rank_update.cu", {
        "slate_set_device": [_I],
        "rank_update": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    }),
    "lu_panel": ("lu_panel.cu", {
        "slate_set_device": [_I],
        "lu_panel": [_P, _P, _I, _I, _P, _P, _I, _P],
        "lu_panel_block_takes": [_I, _I, _I],
    }),
    "compose_swaps": ("compose_swaps.cu", {
        "slate_set_device": [_I],
        "compose_swaps": [_P, _I, _I, _I, _P, _P],
    }),
    "qr_panel": ("qr_panel.cu", {
        "slate_set_device": [_I],
        "qr_panel": [_P, _P, _I, _I, _I, _P, _I, _P],
    }),
    "chol_panel": ("chol_panel.cu", {
        "slate_set_device": [_I],
        "chol_panel": [_P, _P, _I, _I, _P],
    }),
    "trtri_lower": ("trtri_lower.cu", {
        "slate_set_device": [_I],
        "trtri_lower": [_P, _P, _I, _I, _P],
    }),
    "ragged_potrf": ("ragged_potrf.cu", {
        "slate_set_device": [_I],
        "ragged_potrf": [_P, _P, _P, _I, _I, _I, _I, _P],
    }),
    "ragged_getrf": ("ragged_getrf.cu", {
        "slate_set_device": [_I],
        "ragged_getrf": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "ragged_getrf_cluster": [_I],
    }),
    "ragged_trsm": ("ragged_trsm.cu", {
        "slate_set_device": [_I],
        "ragged_trsm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P],
    }),
    "givens_chain": ("givens_chain.cu", {
        "slate_set_device": [_I],
        "givens_chain": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I, _P],
    }),
    "qr_sweep": ("qr_sweep.cu", {
        "slate_set_device": [_I],
        "steqr_sweep": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P],
        "steqr_sweeps": [_P, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P],
        "steqr_chain_cycles": [_P, _P, _I, _P, _P],
        "bdsqr_sweep": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P, _P],
        "bdsqr_sweeps": [_P, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P],
        "bdsqr_chain_cycles": [_P, _P, _I, _P, _P],
    }),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: what the last build did: per library, seconds and ptxas report
build_log: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, "
                           "/usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> str:
    src = LIBS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f == src or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, "lib%s_%s.so" % (name,
                                                     h.hexdigest()[:12]))


def build_all() -> float:
    """Compile every library that is missing, all nvcc processes at
    once; returns the wall seconds. Raises with nvcc's output when a
    build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {n: _lib_path(n) for n in LIBS
            if not os.path.exists(_lib_path(n))}
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    procs: List = []
    for name, out in todo.items():
        tmp = out + ".tmp.%d" % os.getpid()
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, LIBS[name][0])]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT,
                                       text=True)))
    errors = []
    for name, out, tmp, t_start, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t_start,
                           "ptxas": [ln for ln in log.splitlines()
                                     if "ptxas info" in ln]}
        if proc.returncode != 0:
            errors.append("%s: nvcc exited %d\n%s" % (name, proc.returncode,
                                                      log))
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn, argtypes in LIBS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


_current = threading.local()


def set_device(lib: ctypes.CDLL, name: str, device: int) -> None:
    """Make `device` current for library `name`'s runtime (each library
    links its own), calling into it only when this thread last set
    another device there."""
    if getattr(_current, name, None) != device:
        check(lib.slate_set_device(device), "slate_set_device")
        setattr(_current, name, device)


_sms: Dict[int, int] = {}


def sm_count(device: int) -> int:
    """Streaming multiprocessors of CUDA device `device` (cached)."""
    if device not in _sms:
        import torch
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def check(rc: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError("%s: cudaError_t %d" % (what, rc))

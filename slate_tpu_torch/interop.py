"""Carrying state over from the JAX package (no counterpart there).

:func:`from_jax_state` takes only numpy arrays and plain metadata, so
the port never imports JAX: the caller does the ``np.asarray`` on the
JAX side. A bf16 array arrives as numpy's view of JAX's bfloat16 type
(``ml_dtypes``, which the port does not import): it is recognised by
its dtype name and taken bit for bit. The metadata of a matrix are the TiledMatrix fields
``m, n, mb, nb`` and, optionally, ``mtype, uplo, op, diag`` (enum
names or values, which the two packages share), ``kl, ku`` and a
non-uniform matrix's tile boundaries ``rb, cb`` (sequences of ints;
its storage is the exact (m, n) array, as ``TiledMatrix.from_func``
makes it on both sides).
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .core.enums import Diag, MatrixType, Op, Uplo
from .core.exceptions import SlateError
from .core.tiles import TiledMatrix
from .linalg.eig import TridiagResult
from .linalg.indefinite import LTLFactors
from .linalg.lu import LUFactors
from .linalg.qr import LQFactors, QRFactors
from .linalg.svd import BidiagResult, Ge2tbResult
from .utils.backend import DeviceLike, resolve_device

_ENUMS = {"mtype": MatrixType, "uplo": Uplo, "op": Op, "diag": Diag}


def _enum(cls, v):
    if isinstance(v, cls):
        return v
    for mem in cls:
        if v in (mem.name, mem.value):
            return mem
    raise SlateError(f"from_jax_state: unknown {cls.__name__} {v!r}")


def _tensor(arr, device: torch.device) -> torch.Tensor:
    """A copy of `arr` on `device`. numpy has no bfloat16 of its own:
    an array whose dtype is named "bfloat16" (2 bytes) is reinterpreted
    through uint16, so every bit carries over."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        bits = np.array(arr, order="C").view(np.uint16)   # a copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _matrix(data: np.ndarray, meta: Mapping, device: torch.device
            ) -> TiledMatrix:
    kw = {k: _enum(cls, meta[k]) for k, cls in _ENUMS.items() if k in meta}
    for k in ("kl", "ku"):
        if k in meta:
            kw[k] = int(meta[k])
    for k in ("rb", "cb"):
        if meta.get(k) is not None:
            kw[k] = tuple(int(b) for b in meta[k])
    t = _tensor(data, device)
    return TiledMatrix(data=t, m=int(meta["m"]), n=int(meta["n"]),
                       mb=int(meta["mb"]), nb=int(meta["nb"]), **kw)


def _pivots(arrays, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arrays["pivots"], np.int32), device=dev)


def _opt_matrix(arrays, meta, key, dev):
    x = arrays.get(key)
    return None if x is None else _matrix(x, meta[key], dev)


def from_jax_state(arrays: Dict[str, np.ndarray], meta: Mapping,
                   device: DeviceLike = None
                   ) -> Union[TiledMatrix, LUFactors, LTLFactors,
                              QRFactors, LQFactors, TridiagResult,
                              BidiagResult, Ge2tbResult]:
    """Turn a JAX ``TiledMatrix``, ``LUFactors``, ``LTLFactors``,
    ``QRFactors`` or ``LQFactors``, given as numpy, into the port's
    counterpart on `device` (CUDA unless named):

      * ``arrays={"data": A.data}`` + the matrix metadata -> TiledMatrix
        (potrf's triangular factor: its mtype and uplo in the metadata);
      * ``arrays={"LU": F.LU.data, "pivots": F.pivots[, "info": F.info]}``
        + the metadata of ``F.LU`` -> LUFactors; ``meta["band"]`` true
        for gbtrf's windowed band factors (``F.band``);
      * ``arrays={"L": F.L.data, "T": F.T.data, "pivots": F.pivots}``,
        each matrix's metadata under its own key of ``meta`` and
        ``meta["hermitian"] = F.hermitian`` -> LTLFactors (hetrf);
      * ``arrays={"QR": F.QR.data, "taus": F.taus[, "Q": F.Q.data]}`` +
        the metadata of ``F.QR`` (with that of ``F.Q`` under
        ``meta["Q"]``) -> QRFactors;
      * ``arrays={"LQ": F.LQ.data, "taus": F.taus}`` + the metadata of
        ``F.LQ`` -> LQFactors;
      * the eigen / SVD stages' results, each matrix's metadata under
        its own key of ``meta``: ``arrays={"B": R.B.data, "U": R.U.data,
        "Vh": R.Vh.data}`` -> Ge2tbResult (ge2tb's band, with its
        ``kl``, ``ku``); ``arrays={"d": R.d, "e": R.e[, "Q": R.Q.data]}``
        -> TridiagResult (hb2st); ``arrays={"d": R.d, "e": R.e[,
        "U": R.U.data][, "Vh": R.Vh.data]}`` with ``meta["kind"] =
        "bidiag"`` -> BidiagResult (tb2bd). A band matrix (he2hb's
        ``HermitianBand``) is a TiledMatrix with its ``mtype``, ``kl``
        and ``ku`` in the metadata.

    The padded storage is taken as it is, padding included; bf16
    factors (gesv_mixed's) included."""
    dev = resolve_device(device)
    if "B" in arrays:
        return Ge2tbResult(_matrix(arrays["B"], meta["B"], dev),
                           _matrix(arrays["U"], meta["U"], dev),
                           _matrix(arrays["Vh"], meta["Vh"], dev))
    if "d" in arrays:
        d, e = _tensor(arrays["d"], dev), _tensor(arrays["e"], dev)
        if meta.get("kind", "tridiag") == "bidiag":
            return BidiagResult(d, e, _opt_matrix(arrays, meta, "U", dev),
                                _opt_matrix(arrays, meta, "Vh", dev))
        return TridiagResult(d, e, _opt_matrix(arrays, meta, "Q", dev))
    if "QR" in arrays:
        q = arrays.get("Q")
        return QRFactors(_matrix(arrays["QR"], meta, dev),
                         _tensor(arrays["taus"], dev),
                         None if q is None else _matrix(q, meta["Q"], dev))
    if "LQ" in arrays:
        return LQFactors(_matrix(arrays["LQ"], meta, dev),
                         _tensor(arrays["taus"], dev))
    if "LU" in arrays:
        info = arrays.get("info")
        return LUFactors(
            _matrix(arrays["LU"], meta, dev), _pivots(arrays, dev),
            None if info is None else torch.tensor(
                np.asarray(info, np.int32), device=dev),
            band=bool(meta.get("band", False)))
    if "T" in arrays:
        return LTLFactors(_matrix(arrays["L"], meta["L"], dev),
                          _matrix(arrays["T"], meta["T"], dev),
                          _pivots(arrays, dev),
                          bool(meta.get("hermitian", True)))
    return _matrix(arrays["data"], meta, dev)

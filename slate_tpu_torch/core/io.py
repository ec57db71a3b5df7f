"""Layout import / export (counterpart of ``slate_tpu/core/io.py``):
the reference constructors fromLAPACK (Matrix.hh:58), fromScaLAPACK
(:73-96) and the scalapack_api distribution-import role. The host-side
repack runs through the native C++ layout engine
(``slate_tpu_torch.native``, which raises when it cannot be built);
the matrices land on `device` (the CUDA card unless the caller passes
``device="cpu"``), exports come back as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..utils.backend import DeviceLike, resolve_device
from .tiles import TiledMatrix, round_up


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def fromLAPACK(a: np.ndarray, mb: int = 256, nb: Optional[int] = None,
               device: DeviceLike = None) -> TiledMatrix:
    """Adopt a column-major (LAPACK-layout) host array."""
    nb = nb or mb
    a = np.asfortranarray(a)
    m, n = a.shape
    packed = native.pack_colmajor(a, round_up(max(m, 1), mb),
                                  round_up(max(n, 1), nb))
    return TiledMatrix(data=torch.from_numpy(packed).to(
        resolve_device(device)), m=m, n=n, mb=mb, nb=nb)


def toLAPACK(A: TiledMatrix) -> np.ndarray:
    """Export to a column-major host array."""
    r = A.resolve()
    return native.unpack_colmajor(_host(r.data), r.m, r.n)


def fromScaLAPACK(locals_: Iterable[Tuple[int, int, np.ndarray]],
                  m: int, n: int, mb: int, nb: int, p: int, q: int,
                  device: DeviceLike = None) -> TiledMatrix:
    """Assemble a TiledMatrix from per-rank 2D-block-cyclic local
    arrays: locals_ yields (pi, qi, local_colmajor). The block-cyclic
    descriptor decode runs in the native engine."""
    dst = np.zeros((round_up(max(m, 1), mb), round_up(max(n, 1), nb)))
    first = True
    for pi, qi, local in locals_:
        local = np.asfortranarray(local)
        if first:
            dst = dst.astype(local.dtype)
            first = False
        native.bc_import(local, dst, m, n, mb, nb, p, q, pi, qi)
    return TiledMatrix(data=torch.from_numpy(dst).to(
        resolve_device(device)), m=m, n=n, mb=mb, nb=nb)


def toScaLAPACK(A: TiledMatrix, p: int, q: int
                ) -> Dict[Tuple[int, int], np.ndarray]:
    """Export to per-rank 2D-block-cyclic local arrays, each padded to
    whole tiles (at least one)."""
    r = A.resolve()
    src = _host(r.data)
    m, n, mb, nb = r.m, r.n, r.mb, r.nb
    mt = -(-m // mb)
    nt = -(-n // nb)
    out = {}
    for pi in range(p):
        for qi in range(q):
            ntile_rows = max(sum(1 for ti in range(mt)
                                 if ti % p == pi), 1)
            ntile_cols = max(sum(1 for tj in range(nt)
                                 if tj % q == qi), 1)
            out[(pi, qi)] = native.bc_export(
                src, m, n, mb, nb, p, q, pi, qi,
                ntile_rows * mb, ntile_cols * nb)
    return out

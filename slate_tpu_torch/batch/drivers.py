"""Batched many-matrix drivers (counterpart of
``slate_tpu/batch/drivers.py``).

N independent factorizations or solves of one padded shape become one
batched call. The reference vmaps its single-matrix carry cores; here
each core is written over a leading batch dimension, on the port's own
building blocks:

  * potrf: the pipelined blocked Cholesky (``blocked.cholesky_blocked``,
    batched library Cholesky on the diagonal blocks), lower triangle
    kept;
  * getrf: the reference's masked column-loop panel
    (``lu.lu_panel_fori``, which takes the stack: argmax along a
    dimension and gathers, so no column reads a value back to the
    host), the swaps composed on
    the card for the whole stack at once (``compose_swaps``), the
    unit-lower U12 solve and the trailing product;
  * geqrf / gels: the carry driver (``qr._geqrf_carry``) with batched
    library panels; a bf16 stack, whose type the library QR lacks,
    takes its panels element by element (the ``qr_panel`` kernel where
    its gate takes the panel, else the column loop);
  * heev: ``blocked.library_eigh`` on the stack, values ascending.

Inputs are stacked, already padded (batch/bucket.py prepares them).
The reference warns when its raw-array entries turn f64 into f32 (JAX
with x64 off does); torch keeps the dtype, so no such warning exists
here. ``from_jax_state`` needs nothing new for this layer: batched
stacks and pivots are plain arrays.

The RAGGED dispatch (:func:`ragged_dispatch`) runs the square
factorizations and solves of a stack padded to one ceiling through
the ragged kernels (ops/kernels.ragged_potrf/getrf/trsm), with a
per-element sizes vector.

Entry points put their data on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.tiles import ceil_div
from ..linalg.blocked import library_eigh, solve_triangular
from ..linalg.lu import lu_panel_fori
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from ..utils.backend import DeviceLike, resolve_device

#: algorithmic blocking of the batched cores (the reference's value)
DEFAULT_NB = 256
#: QR inner blocking
DEFAULT_IB = 128


# -- batched cores -----------------------------------------------------------

def potrf_core(a: torch.Tensor, nb: int = DEFAULT_NB) -> torch.Tensor:
    """Lower Cholesky of each (N, N) SPD element of a padded stack: the
    pipelined blocked loop, lower triangle kept (the loop leaves stale
    strips above the diagonal)."""
    from ..linalg.blocked import cholesky_blocked
    return torch.tril(cholesky_blocked(a, nb))


def _gather_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x[b, perm[b]] for every element b."""
    return torch.take_along_dim(x, perm[..., None], dim=-2)


def getrf_core(a: torch.Tensor, nb: int = DEFAULT_NB
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked partial-pivot LU of each (M, N) element of a padded
    stack with the batch-safe panel (module doc). Returns (packed
    L\\U, (B, min(M, N)) int32 LAPACK swap targets)."""
    B, M, N = a.shape
    kmax = min(M, N)
    a = a.clone()
    ipiv = torch.arange(kmax, dtype=torch.int32,
                        device=a.device).repeat(B, 1)
    for k in range(ceil_div(kmax, nb)):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        panel, piv = lu_panel_fori(a[:, k0:, k0:k1])
        a[:, k0:, k0:k1] = panel
        ipiv[:, k0:k1] = k0 + piv
        perm = pk.lu_pivots_to_permutation(piv, M - k0)
        if k0 > 0:
            a[:, k0:, :k0] = _gather_rows(a[:, k0:, :k0], perm)
        if k1 < N:
            a[:, k0:, k1:] = _gather_rows(a[:, k0:, k1:], perm)
            u12 = solve_triangular(a[:, k0:k1, k0:k1], a[:, k0:k1, k1:],
                                   upper=False, unitriangular=True)
            a[:, k0:k1, k1:] = u12
            if k1 < M:
                a[:, k1:, k1:] -= a[:, k1:, k0:k1] @ u12
    return a, ipiv


def geqrf_core(a: torch.Tensor, nb: int = DEFAULT_NB,
               ib: int = DEFAULT_IB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked Householder QR of each (M, N) element of a padded stack:
    the carry driver (module doc for bf16). Returns (packed V\\R,
    taus)."""
    from ..linalg.qr import _geqrf_carry
    M, N = a.shape[-2:]
    return _geqrf_carry(a, min(nb, max(min(M, N), 1)), min(M, N), ib)


def potrs_core(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve on already-factored padded lower Cholesky factors: the
    two triangular solves of posv_core without the factorization."""
    y = solve_triangular(l, b, upper=False)
    return solve_triangular(l.mH, y, upper=True)


def getrs_core(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """General solve on already-factored padded packed L\\U, the pivot
    permutation already applied to ``b`` by the caller: the unit-lower
    and upper solves of gesv_core."""
    x = solve_triangular(lu, b, upper=False, unitriangular=True)
    return solve_triangular(lu, x, upper=True)


def posv_core(a: torch.Tensor, b: torch.Tensor, nb: int = DEFAULT_NB
              ) -> torch.Tensor:
    """SPD solve of each padded system: potrf_core, then potrs_core."""
    return potrs_core(potrf_core(a, nb), b)


def gesv_core(a: torch.Tensor, b: torch.Tensor, nb: int = DEFAULT_NB
              ) -> torch.Tensor:
    """General solve of each padded system: getrf_core, the pivots
    applied by one gather, then getrs_core."""
    lu, piv = getrf_core(a, nb)
    perm = pk.lu_pivots_to_permutation(piv, a.shape[-2])
    return getrs_core(lu, _gather_rows(b, perm))


def gels_core(a: torch.Tensor, b: torch.Tensor, nb: int = DEFAULT_NB,
              ib: int = DEFAULT_IB) -> torch.Tensor:
    """Overdetermined least squares of each padded (M, N) system,
    M >= N: geqrf_core, the compact-WY Q^H b sweep panel by panel, the
    R back-solve. Minimizer only (x = R^{-1} (Q^H b)[:N])."""
    from ..linalg.qr import _larft, _panel_V
    packed, taus = geqrf_core(a, nb, ib)
    M, N = a.shape[-2:]
    kmax = min(M, N)
    c = b.clone()
    for k in range(ceil_div(kmax, nb)):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        V = _panel_V(packed[..., k0:, k0:k1], 0)
        T = _larft(V, taus[..., k0:k1])
        Ck = c[..., k0:, :]
        c[..., k0:, :] = Ck - V @ (T.mH @ (V.mH @ Ck))
    return solve_triangular(packed[..., :N, :N], c[..., :N, :], upper=True)


#: dtypes torch.linalg.eigh takes
_EIGH_DTYPES = (torch.float32, torch.float64, torch.complex64,
                torch.complex128)


def heev_core(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian eigendecomposition of each padded (N, N) element,
    values ascending (``blocked.library_eigh``; a bf16 stack is solved in
    f32 and rounded). Returns (w, V)."""
    if a.dtype in _EIGH_DTYPES:
        return library_eigh(a)
    w, v = library_eigh(a.float())
    return w.to(a.dtype), v.to(a.dtype)


class BatchOp(NamedTuple):
    """Registry row: the core, whether it takes a right-hand side, the
    bucket pad mode of the matrix operand, and whether the core takes
    the (nb, ib) blocking keywords."""
    core: object
    has_rhs: bool
    pad_mode: str
    blocked: bool


OPS = {
    "potrf": BatchOp(potrf_core, False, "identity", True),
    "getrf": BatchOp(getrf_core, False, "identity", True),
    "geqrf": BatchOp(geqrf_core, False, "identity", True),
    "posv": BatchOp(posv_core, True, "identity", True),
    "gesv": BatchOp(gesv_core, True, "identity", True),
    "potrs": BatchOp(potrs_core, True, "identity", False),
    "getrs": BatchOp(getrs_core, True, "identity", False),
    "gels": BatchOp(gels_core, True, "identity", True),
    "heev": BatchOp(heev_core, False, "shift", False),
}


def _dispatch(op: str, stack: torch.Tensor, rhs=None,
              nb: Optional[int] = None, ib: Optional[int] = None,
              donate: bool = False):
    """One batched call of `op`'s core on tensors already on their
    device. ``donate`` is accepted as the reference's: these cores copy
    before they write, so the stack is never written either way."""
    spec = OPS[op]
    kw = {}
    if spec.blocked:
        kw["nb"] = int(nb) if nb else DEFAULT_NB
        if op in ("geqrf", "gels"):
            kw["ib"] = int(ib) if ib else DEFAULT_IB
    if spec.has_rhs:
        if rhs is None:
            raise ValueError(f"{op} needs a right-hand-side stack")
        return spec.core(stack, rhs, **kw)
    if rhs is not None:
        raise ValueError(f"{op} takes no right-hand side")
    return spec.core(stack, **kw)


def _check_stack(op: str, stack, rhs):
    spec = OPS[op]
    if getattr(stack, "ndim", 0) != 3:
        raise ValueError(
            f"{op}_batched wants a stacked (batch, m, n) array, got "
            f"shape {tuple(getattr(stack, 'shape', ()))} — wrap a single "
            f"matrix as a[None] or use the single-matrix driver")
    m, n = stack.shape[-2:]
    if op == "gels":
        if m < n:
            raise ValueError(
                "gels_batched is overdetermined-only (m >= n); the "
                "minimum-norm LQ route stays single-matrix")
    elif op != "geqrf" and m != n:
        raise ValueError(f"{op}_batched wants square matrices, got "
                         f"({m}, {n})")
    if spec.has_rhs:
        if rhs is None:
            raise ValueError(f"{op}_batched needs a right-hand-side "
                             f"stack")
        if getattr(rhs, "ndim", 0) != 3 or rhs.shape[0] != stack.shape[0] \
                or rhs.shape[1] != m:
            raise ValueError(
                f"{op}_batched rhs must be (batch, {m}, nrhs) matching "
                f"the matrix stack, got "
                f"{tuple(getattr(rhs, 'shape', ()))}")


def _run(op: str, stack, rhs, device: DeviceLike, **kw):
    """Validate, move the operands to the device, dispatch."""
    _check_stack(op, stack, rhs)
    dev = resolve_device(device)
    stack = torch.as_tensor(stack, device=dev)
    if rhs is not None:
        rhs = torch.as_tensor(rhs, device=dev)
    return _dispatch(op, stack, rhs, **kw)


# -- public batched drivers --------------------------------------------------

@instrument_driver("potrf_batched")
def potrf_batched(stack, nb: Optional[int] = None, donate: bool = False,
                  device: DeviceLike = None):
    """Batched lower Cholesky: (B, n, n) SPD stack -> (B, n, n) L."""
    return _run("potrf", stack, None, device, nb=nb, donate=donate)


@instrument_driver("getrf_batched")
def getrf_batched(stack, nb: Optional[int] = None, donate: bool = False,
                  device: DeviceLike = None):
    """Batched partial-pivot LU: stack -> (packed L\\U stack, pivot
    stack) with the batch-safe column-loop panel (module doc)."""
    return _run("getrf", stack, None, device, nb=nb, donate=donate)


@instrument_driver("geqrf_batched")
def geqrf_batched(stack, nb: Optional[int] = None,
                  ib: Optional[int] = None, donate: bool = False,
                  device: DeviceLike = None):
    """Batched Householder QR: stack -> (packed V\\R stack, taus)."""
    return _run("geqrf", stack, None, device, nb=nb, ib=ib, donate=donate)


@instrument_driver("posv_batched")
def posv_batched(stack, rhs, nb: Optional[int] = None,
                 donate: bool = False, device: DeviceLike = None):
    """Batched SPD solve: (B, n, n), (B, n, k) -> (B, n, k) X."""
    return _run("posv", stack, rhs, device, nb=nb, donate=donate)


@instrument_driver("gesv_batched")
def gesv_batched(stack, rhs, nb: Optional[int] = None,
                 donate: bool = False, device: DeviceLike = None):
    """Batched general solve: (B, n, n), (B, n, k) -> (B, n, k) X."""
    return _run("gesv", stack, rhs, device, nb=nb, donate=donate)


@instrument_driver("potrs_batched")
def potrs_batched(stack, rhs, donate: bool = False,
                  device: DeviceLike = None):
    """Batched SPD solve on cached lower Cholesky factors: (B, n, n) L
    stack, (B, n, k) rhs -> (B, n, k) X."""
    return _run("potrs", stack, rhs, device, donate=donate)


@instrument_driver("getrs_batched")
def getrs_batched(stack, rhs, donate: bool = False,
                  device: DeviceLike = None):
    """Batched general solve on cached packed L\\U factors with the
    pivot permutation ALREADY applied to rhs (getrs_core doc):
    (B, n, n), (B, n, k) -> (B, n, k) X."""
    return _run("getrs", stack, rhs, device, donate=donate)


@instrument_driver("gels_batched")
def gels_batched(stack, rhs, nb: Optional[int] = None,
                 ib: Optional[int] = None, donate: bool = False,
                 device: DeviceLike = None):
    """Batched overdetermined least squares: (B, m, n), (B, m, k) ->
    (B, n, k) minimizers."""
    return _run("gels", stack, rhs, device, nb=nb, ib=ib, donate=donate)


@instrument_driver("heev_batched")
def heev_batched(stack, donate: bool = False, device: DeviceLike = None):
    """Batched Hermitian eigendecomposition: (B, n, n) -> ((B, n) w
    ascending, (B, n, n) V)."""
    return _run("heev", stack, None, device, donate=donate)


# -- ragged batched dispatch -------------------------------------------------

#: ops the ragged strategy serves: the square factorizations and their
#: solves, plus the solve-only ops on cached factors. geqrf/gels/heev
#: keep the bucket route under any strategy (no ragged kernel).
RAGGED_OPS = ("potrf", "getrf", "posv", "gesv", "potrs", "getrs")


@instrument_driver("ragged_dispatch")
def ragged_dispatch(op, stack, sizes, rhs=None, blk=None,
                    donate: bool = False, device: DeviceLike = None):
    """One RAGGED batched dispatch: a (B, N, N) stack padded to ONE
    ceiling plus the per-element true orders ``sizes``, through the
    ragged kernels: potrf/getrf directly, posv/gesv as factor + ragged
    triangular solves (gesv applies each element's swaps between, by
    one ``compose_swaps`` launch for the stack and a gather). ``blk``
    is the block width the caller sized the ceiling with; None
    re-resolves the tuned row. Raises when the kernels are ineligible
    for this ceiling and dtype: the queue's submit-time gate
    (ragged_supported + bucket.ragged_ceiling) routes such requests to
    the bucket strategy instead. ``donate=True`` lets the kernels write
    into the stack and rhs (the queue's own throwaway copies)."""
    if op not in RAGGED_OPS:
        raise ValueError(f"op {op!r} has no ragged route; have "
                         f"{RAGGED_OPS}")
    spec = OPS[op]
    dev = resolve_device(device)
    stack = torch.as_tensor(stack, device=dev)
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
    blk = pk.ragged_blk(blk)
    if spec.has_rhs:
        if rhs is None:
            raise ValueError(f"{op} needs a right-hand-side stack")
        rhs = torch.as_tensor(rhs, device=dev)
    elif rhs is not None:
        raise ValueError(f"{op} takes no right-hand side")
    out = None
    if op == "potrf":
        out = pk.ragged_potrf(stack, sizes, blk=blk, donate=donate)
    elif op == "getrf":
        out = pk.ragged_getrf(stack, sizes, blk=blk, donate=donate)
    elif op in ("posv", "potrs"):
        L = pk.ragged_potrf(stack, sizes, blk=blk, donate=donate) \
            if op == "posv" else stack
        y = pk.ragged_trsm(L, rhs, sizes, blk=blk, donate=donate) \
            if L is not None else None
        out = pk.ragged_trsm(L, y, sizes, trans=True, blk=blk,
                             donate=donate) if y is not None else None
    else:                       # getrs (pivots pre-applied) or gesv
        lu = stack
        if op == "gesv":
            fac = pk.ragged_getrf(stack, sizes, blk=blk, donate=donate)
            lu = None
            if fac is not None:
                lu, piv = fac
                perm = pk.lu_pivots_to_permutation(piv, stack.shape[-1])
                rhs = _gather_rows(rhs, perm)
        y = pk.ragged_trsm(lu, rhs, sizes, unit=True, blk=blk,
                           donate=donate) if lu is not None else None
        out = pk.ragged_trsm(lu, y, sizes, upper=True, blk=blk,
                             donate=donate) if y is not None else None
    if out is None:
        raise ValueError(
            f"ragged {op} ineligible at ceiling {stack.shape[-1]} "
            f"dtype {stack.dtype} — route the bucket strategy")
    return out

"""Explicit collectives over the process grid (counterpart of
``slate_tpu/parallel/collectives.py``; reference BcastList / ReduceList,
BaseMatrix.hh:1999 listBcast, :2219 listReduce, internal_comm.cc:72).

The reference's helpers are ``shard_map`` programs; each of the port's
takes and returns the LOCAL block: what device (r, c) holds in the
reference before and after. The mapping is the reference's:

    tileBcast along a row of ranks   -> row_bcast   (all-gather on 'q')
    tileBcast down a column          -> col_bcast   (all-gather on 'p')
    listReduce of partial tiles      -> col_reduce / row_reduce
    reduce list, scattered           -> col_reduce_scatter
    hypercube pipelined patterns     -> ring_shift, tree_allreduce

Every call is counted under the reference's HLO kind (``counts()``,
keys ``obs.xprof.COLLECTIVE_KINDS``), whatever ``torch.distributed``
operation carries it: the gathers and the scatter are masked
``all_reduce`` sums (each rank adds its block at its place, zeros
elsewhere; ``x + 0`` is exact), because ``broadcast`` and
``all_reduce`` are the operations gloo also takes on CUDA tensors.
``ring_shift`` and the tree engine (``dist/tree.py``) exchange by
``isend`` / ``irecv`` (:func:`exchange`: NCCL on the card, gloo on the
CPU; gloo with a CUDA tensor through a host copy). The drivers'
own gathers and owner broadcasts (``parallel/owner.py``) go through
:func:`all_reduce` and :func:`broadcast` here and count as
``all-reduce``: the reference broadcasts a panel by a masked psum.

On a grid without a process group (``single_device_grid``) every
collective is the identity and counts nothing.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.tiles import round_up
from ..obs.xprof import COLLECTIVE_KINDS
from .mesh import WHOLE, Axis, ProcessGrid

_lock = threading.Lock()
_COUNTS: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}


def _count(kind: str, n: int = 1) -> None:
    with _lock:
        _COUNTS[kind] += n


def counts() -> Dict[str, int]:
    """Collectives issued by this process since the last reset, by the
    reference's HLO kind."""
    with _lock:
        return dict(_COUNTS)


def reset_counts() -> None:
    with _lock:
        for k in _COUNTS:
            _COUNTS[k] = 0


def counts_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Collectives issued since `before` (a :func:`counts` snapshot), by
    kind."""
    now = counts()
    return {k: now[k] - before.get(k, 0) for k in now}


# -- primitives ---------------------------------------------------------------

def all_reduce(grid: ProcessGrid, x: torch.Tensor, axis: Axis = WHOLE,
               op: str = "sum", kind: str = "all-reduce") -> torch.Tensor:
    """Sum (or max) of `x` over this rank's `axis` group, on every
    member; `x` is not modified. Counted under `kind`."""
    g = grid.group(axis)
    if g is None:
        return x
    _count(kind)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=g)
    return y


def broadcast(grid: ProcessGrid, x: torch.Tensor, src: int,
              axis: Axis = WHOLE, kind: str = "all-reduce"
              ) -> torch.Tensor:
    """The value of `x` at position `src` of this rank's `axis` group,
    on every member. Every rank passes a tensor of the same shape and
    dtype (the source's value; a buffer elsewhere)."""
    g = grid.group(axis)
    if g is None:
        return x
    _count(kind)
    y = x.contiguous().clone()
    dist.broadcast(y, src=grid.axis_ranks(axis)[src], group=g)
    return y


def broadcast_many(grid: ProcessGrid, xs: Sequence[torch.Tensor],
                   src: int, axis: Axis = WHOLE) -> List[torch.Tensor]:
    """:func:`broadcast` of several tensors, one call per dtype: each
    dtype's tensors travel flattened in one buffer."""
    if grid.group(axis) is None:
        return list(xs)
    out: List[torch.Tensor] = list(xs)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = broadcast(grid, torch.cat([xs[i].reshape(-1) for i in idx]),
                         src, axis)
        off = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = flat[off:off + n].view(xs[i].shape)
            off += n
    return out


def agree(grid: ProcessGrid, *values: int) -> Tuple[int, ...]:
    """Grid index 0's `values` on every rank: integer choices a driver
    resolved from this rank's own tune cache (a block width, a route, a
    tree fan-in, a leaf size). A grid driver passes each such choice
    that shapes its loop or its collectives through here before using
    it: ranks whose caches differ would otherwise issue collectives of
    different counts or sizes. One broadcast, counted as all-reduce."""
    if grid.group() is None:
        return tuple(int(v) for v in values)
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=grid.device)
    return tuple(int(v) for v in broadcast(grid, t, 0).tolist())


#: host staging of exchange(): None stages exactly when gloo carries a
#: CUDA tensor (gloo posts no point-to-point operation on one), True
#: forces it for any tensor (the tests' check that both paths agree)
STAGE_ON_HOST = None

_STAGED = {"bytes": 0}


def staged_bytes() -> int:
    """Bytes exchange() copied between the device and the host since
    the last reset_staged_bytes()."""
    with _lock:
        return _STAGED["bytes"]


def reset_staged_bytes() -> None:
    with _lock:
        _STAGED["bytes"] = 0


def _stages(grid: ProcessGrid, x: torch.Tensor) -> bool:
    if STAGE_ON_HOST is not None:
        return bool(STAGE_ON_HOST)
    return grid.backend == "gloo" and x.device.type == "cuda"


def exchange(grid: ProcessGrid, x: torch.Tensor, send_to: Sequence[int],
             recv_from: Sequence[int], axis: Axis) -> List[torch.Tensor]:
    """Point-to-point round: send `x` to each position of `send_to` and
    receive one tensor like `x` from each position of `recv_from`
    (positions along `axis`), posted together by ``batch_isend_irecv``
    (one NCCL group, so no pair of ranks waits on each other's send).
    Under gloo a CUDA `x` travels through a host copy and the received
    tensors are copied back to its device (:data:`STAGE_ON_HOST`; the
    bytes copied each way are counted, :func:`staged_bytes` and
    ``comms.host_staged_bytes``); the values are the same bits. Not
    counted here: callers count their rounds."""
    g = grid.group(axis)
    peers = grid.axis_ranks(axis)
    x = x.contiguous()
    dev = x.device
    staged = _stages(grid, x)
    if staged:
        x = x.to("cpu", copy=True)
    bufs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for _ in recv_from]
    ops = [dist.P2POp(dist.isend, x, peers[d], g) for d in send_to]
    ops += [dist.P2POp(dist.irecv, b, peers[s], g)
            for b, s in zip(bufs, recv_from)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not staged:
        return bufs
    nb = x.numel() * x.element_size() * (1 + len(bufs))
    with _lock:
        _STAGED["bytes"] += nb
    from ..obs import events as obs_events
    if obs_events.enabled():
        from ..obs import metrics as obs_metrics
        obs_metrics.inc("comms.host_staged_bytes", nb)
    return [b.to(dev, copy=True) for b in bufs]


def _gather(grid: ProcessGrid, x: torch.Tensor, axis: str, dim: int
            ) -> torch.Tensor:
    """Tiled all-gather of `x` along `dim` over `axis` by a masked
    all_reduce (module doc)."""
    size, pos = grid.axis_size(axis), grid.axis_index(axis)
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = w * size
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(dim, pos * w, w).copy_(x)
    if grid.group(axis) is None:
        return buf
    return all_reduce(grid, buf, axis, kind="all-gather")


# -- the reference's helpers -------------------------------------------------

def row_bcast(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Each q-shard to the whole grid row: the local (m/p, n/q) block
    becomes this row's (m/p, n) (reference tileBcast across a block
    row)."""
    return _gather(grid, x, "q", 1)


def col_bcast(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Each p-shard down its grid column: (m/p, n/q) -> (m, n/q)
    (reference tileBcast of the panel column, potrf.cc:108)."""
    return _gather(grid, x, "p", 0)


def col_reduce(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Sum of the local blocks over 'p', on every rank of the column
    (reference listReduce with tile::add, BaseMatrix.hh:2219)."""
    return all_reduce(grid, x, "p")


def row_reduce(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Sum of the local blocks over 'q', on every rank of the row."""
    return all_reduce(grid, x, "q")


def col_reduce_scatter(grid: ProcessGrid, x: torch.Tensor) -> torch.Tensor:
    """Sum over 'p', scattered back down the column: rank (r, c) keeps
    row block r of the (m/p, n/q) sum (the reference's psum_scatter,
    tiled)."""
    size, pos = grid.axis_size("p"), grid.axis_index("p")
    if x.shape[0] % size:
        raise ValueError("col_reduce_scatter: %d rows do not split over "
                         "p=%d" % (x.shape[0], size))
    s = all_reduce(grid, x, "p", kind="reduce-scatter")
    h = x.shape[0] // size
    return s[pos * h:(pos + 1) * h]


def ring_shift(grid: ProcessGrid, x: torch.Tensor, axis: str = "q",
               shift: int = 1) -> torch.Tensor:
    """Rotate the local blocks around a mesh axis ring: position i's
    block moves to position (i + shift) % size (the reference's
    ppermute, the building block of SUMMA / Cannon schedules)."""
    if grid.group(axis) is None:
        return x
    _count("collective-permute")
    size, pos = grid.axis_size(axis), grid.axis_index(axis)
    dst, src = (pos + shift) % size, (pos - shift) % size
    if dst == pos:
        return x
    return exchange(grid, x, [dst], [src], axis)[0]


def tree_allreduce(grid: ProcessGrid, x: torch.Tensor,
                   op: Callable = torch.add, axis: Axis = WHOLE,
                   fanin: int = 2) -> torch.Tensor:
    """Log-depth reduction over `axis` by the dist/tree.py butterfly:
    `x` is this rank's row block of the reference's row-sharded input,
    the result (the `op`-combination of every block, associated left
    to right in mesh order) is the same on every rank."""
    from ..dist import tree as _tree
    size = _tree.axis_size(grid, axis)
    _tree.record_schedule("tree_allreduce", size, fanin)
    return _tree.tree_combine(
        grid, x, lambda vals: functools.reduce(op, vals), axis, size,
        fanin=fanin)


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def summa_gemm(grid: ProcessGrid, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """SUMMA with the reference's one-panel-per-step schedule (gemmC
    SUMMA loop, gemmC.cc:84-117): `a` and `b` are this rank's blocks of
    A (m, k) and B (k, n) under P('p', 'q'); the result is its block of
    C = A B. k is split into p*q panels of width kb = k / (p q), so each
    panel lies in one q-shard of A and one p-shard of B; per step the
    owner's panel reaches its row (A) and column (B) by a masked
    all_reduce (the reference's masked psum) and every rank accumulates
    one (m/p, kb) x (kb, n/q) product, at f32 or wider. A k that is not
    a multiple of p*q is padded first (:func:`pad_k`, exact)."""
    p, q = grid.p, grid.q
    if a.shape[1] % p or b.shape[0] % q:
        raise ValueError(
            "summa_gemm: local k of %d (A) / %d (B) does not split into "
            "p*q panels; pad the global operands with pad_k first"
            % (a.shape[1], b.shape[0]))
    kb = a.shape[1] // p
    r, c = grid.coords
    out_dt = torch.promote_types(a.dtype, b.dtype)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=_acc_dtype(out_dt),
                      device=a.device)
    for s in range(p * q):
        apan = a[:, (s % p) * kb:(s % p + 1) * kb] if c == s // p \
            else torch.zeros((a.shape[0], kb), dtype=a.dtype,
                             device=a.device)
        apan = all_reduce(grid, apan, "q")
        bpan = b[(s % q) * kb:(s % q + 1) * kb] if r == s // q \
            else torch.zeros((kb, b.shape[1]), dtype=b.dtype,
                             device=b.device)
        bpan = all_reduce(grid, bpan, "p")
        acc += apan.to(acc.dtype) @ bpan.to(acc.dtype)
    return acc.to(out_dt)


def pad_k(grid: ProcessGrid, a: torch.Tensor, b: torch.Tensor):
    """Zero-pad global A (m, k) and B (k, n) along k to a multiple of
    p*q, the reference's ragged-k padding (zero panels add nothing)."""
    k = a.shape[1]
    kp = round_up(max(k, 1), grid.p * grid.q)
    if kp == k:
        return a, b
    return (torch.nn.functional.pad(a, (0, kp - k)),
            torch.nn.functional.pad(b, (0, 0, 0, kp - k)))


def summa_gemm_allgather(grid: ProcessGrid, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """The bulk-synchronous variant: gather A's whole block row and B's
    whole block column, one local product (fewer, larger collectives at
    O(m/p k + k n/q) memory a rank)."""
    a_row = row_bcast(grid, a)
    b_col = col_bcast(grid, b)
    out_dt = torch.promote_types(a.dtype, b.dtype)
    acc = _acc_dtype(out_dt)
    return (a_row.to(acc) @ b_col.to(acc)).to(out_dt)

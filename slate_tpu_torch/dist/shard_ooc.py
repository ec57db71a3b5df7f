"""Sharded out-of-core stream (counterpart of
``slate_tpu/dist/shard_ooc.py``): the out-of-core stream of
linalg/ooc.py carried over a process grid. Panels are owned
block-cyclically by grid positions, each rank's StreamEngine stages only
its own panels, and every factor frame reaches every rank through the
tree engine of dist/tree.py.

The reference runs every mesh position inside one SPMD process; here
each rank is a process at grid position ``(k // q, k % q)``
(parallel/mesh.py), so:

  * ``CyclicSchedule`` is the reference's walk (panel k at
    ``(k mod p, (k // p) mod q)``); ``is_mine(k)`` compares the owner's
    position with ``grid.index``. Ownership is static, so every rank
    knows before the stream starts which panels it stages and in what
    order: prefetch is exact, and an eviction-free run's
    ``ooc.h2d_bytes`` equals :meth:`CyclicSchedule.staged_bytes`.
  * per step k the owner factors its panel in core (the single-engine
    stream's panel functions), and ``PanelBroadcaster`` replicates the
    frame as the reference's exact add-combine: the owner holds the
    payload, every other rank exact zeros, and ``dist.tree.tree_combine``
    sums them over the whole grid (``ooc/shard_fanin``; each round counts
    as ``collective-permute``). Every rank keeps the full host input and
    a full host mirror of the factor, written from the frames.
  * every rank applies the frame to the trailing panels it owns
    (``StreamEngine.stash`` keeps them resident under the budget and
    spills evicted ones), while the engine prefetches its next
    first-touch input.

Bitwise: each trailing panel absorbs updates 0..k-1 in ascending order
through the same visit kernels on bitwise-equal operands as the
single-engine stream, so ``shard_potrf_ooc`` / ``shard_geqrf_ooc`` /
``shard_getrf_ooc`` give ``potrf_ooc`` / ``geqrf_ooc`` /
``getrf_tntpiv_ooc``'s results, on every rank, at budget 0 too.

Lookahead (``ooc/shard_lookahead``, FROZEN 0): at step k the owner of
panel k+1 applies its own k-update first, factors k+1 and issues its
broadcast before the rest of the k-updates; the frame is completed at
step k+1. The frames run on a thread of their own over a process group
of their own (made by ``dist.new_group`` in the same order on every
rank), so the main thread's collectives (``agree``, the epoch and speed
agreements) never interleave with them. Depth changes only when the
same kernels run, never their operands: every depth is bitwise depth 0.

Mixed precision (``ooc/precision`` bf16): the owner demotes the frame
before the tree (half the bytes), every rank applies the lo frame and
mirrors the promoted frame, so the factor is the same on every rank at
bf16-update accuracy. The LU pivot selection rides a byte-split pair of
rows (``hi * 256 + lo``, both exact in bf16).

``shard_getrf_ooc`` is tournament pivoting (the reference's): the owner
finalizes panel k's pivots before its column is written, the factor is
stored in original row order, and the frame carries the selection as an
extra row, from which every rank derives the same permutation.

Left out on purpose (ROADMAP): the reference's compiled-program cache of
the broadcast (``_BCAST_FNS`` and ``ooc.shard.bcast_compiles``) and its
fused sweeps' power-of-two bucket padding (``_fuse_bucket``): they
account for XLA compiles. The fused sweep here is one graph node whose
members each run the per-panel visit body at their true size.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tiles import ceil_div
from ..obs import events as obs_events
from ..obs import health as _health
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from ..obs.events import instrument_driver
from ..parallel.mesh import WHOLE, ProcessGrid
from ..resil import checkpoint as _ckpt
from ..resil import faults as _faults
from ..resil import guard as _guard
from . import tree as _tree


class CyclicSchedule:
    """Static block-cyclic panel -> grid position ownership (one per
    driver call); every rank computes the same map."""

    def __init__(self, nt: int, grid: ProcessGrid) -> None:
        self.nt = int(nt)
        self.grid = grid
        self.p, self.q = grid.p, grid.q

    @property
    def nranks(self) -> int:
        return self.p * self.q

    def owner_coords(self, k: int) -> Tuple[int, int]:
        """Grid position owning panel k: the column-major cyclic walk
        ('p' advances fastest, GridOrder.Col)."""
        return k % self.p, (k // self.p) % self.q

    def owner_flat(self, k: int) -> int:
        """The owner's row-major position (the broadcast's source)."""
        r, c = self.owner_coords(k)
        return r * self.q + c

    def owner_process(self, k: int) -> int:
        """World rank of panel k's owner."""
        return self.grid.ranks[self.owner_flat(k)]

    def is_mine(self, k: int) -> bool:
        return self.owner_flat(k) == self.grid.index

    def my_panels(self) -> List[int]:
        """Panels this rank stages, in factoring order."""
        return [k for k in range(self.nt) if self.is_mine(k)]

    def update_order(self, k: int, depth: int = 0,
                     epoch: int = 0) -> List[int]:
        """Step k's trailing-update order on this rank: panels inside the
        lookahead window ``(k, k + depth]`` first (the owner of k+1 must
        finish that panel's k-update before anyone can see frame k+1),
        then the rest ascending. The window panels are the smallest
        trailing indices, so the sequence is the same at every depth.
        Panels below ``epoch`` are durable on resume and never
        updated."""
        todo = [j for j in self.my_panels() if j > k and j >= epoch]
        if depth <= 0:
            return todo
        head = [j for j in todo if j <= k + depth]
        return head + [j for j in todo if j > k + depth]

    def staged_bytes(self, heights: Dict[int, int], width: int,
                     last_width: int, itemsize: int,
                     depth: int = 0) -> int:
        """Bytes this rank's engine stages in an eviction-free run: each
        owned panel's input once (`heights[k]` rows: n - k0 for the
        triangular stream, m for the full-height ones), found by walking
        the schedule. The same at every depth."""
        total = 0
        touched: set = set()
        for k in range(self.nt):
            walk = ([k] if self.is_mine(k) else []) \
                + self.update_order(k, depth)
            for j in walk:
                if j in touched:
                    continue
                touched.add(j)
                w = last_width if j == self.nt - 1 else width
                total += heights[j] * w * itemsize
        return total


#: the frames' process groups, by (world, ranks): made once, in the
#: same order on every rank
_FRAME_GROUPS: Dict[Tuple, Any] = {}


def _frame_grid(grid: ProcessGrid) -> Optional[ProcessGrid]:
    """The grid the frames travel on: `grid`'s ranks over a process
    group of their own, so the frame thread's collectives never share a
    group with the main thread's. None for a grid of one rank (its
    broadcast is the identity)."""
    if grid.group() is None or grid.nprocs == 1:
        return None
    import torch.distributed as dist
    from ..parallel.mesh import _WORLDS
    world = dist.distributed_c10d._get_default_group()
    if world not in _WORLDS:
        _WORLDS.append(world)       # keeps id(world) unique while cached
    key = (id(world), grid.ranks)
    g = _FRAME_GROUPS.get(key)
    if g is None:
        g = _FRAME_GROUPS[key] = dist.new_group(list(grid.ranks))
    return ProcessGrid(grid.p, grid.q, grid.order, grid.ranks, grid.rank,
                       grid.device, grid.backend, {WHOLE: g})


class _InflightFrame:
    """One issued, not yet completed broadcast: its future, panel and
    issue time."""

    __slots__ = ("fut", "panel", "issued_at")

    def __init__(self, fut: cf.Future, panel: Optional[int]) -> None:
        self.fut = fut
        self.panel = panel
        self.issued_at = time.perf_counter()


class PanelBroadcaster:
    """Factor-panel broadcast over the tree engine (module doc): the
    owner's payload, zeros elsewhere, summed over the grid (x + 0 is
    exact). ``broadcast_async`` issues a traversal on the frame thread
    and returns at once; ``complete`` waits for it. The wait is the
    ``shard::bcast_wait`` span and ``ooc.shard.bcast_wait_seconds``;
    issue-to-completion goes to ``ooc.shard.bcast_inflight_seconds``,
    and 1 - wait / in-flight is the overlap fraction. Each traversal is
    the ``ppermute`` fault site and takes the guard's bounded retry."""

    def __init__(self, grid: ProcessGrid, fanin: int = 2) -> None:
        self.grid = grid
        self.fanin = max(int(fanin), 2)
        self.size = grid.nprocs
        self._fgrid = _frame_grid(grid)
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._zeros: Dict[Tuple, torch.Tensor] = {}
        self.panels = 0
        self.bytes = 0
        self.wait_seconds = 0.0
        self.inflight_seconds = 0.0
        self.ahead = 0

    def _executor(self) -> cf.ThreadPoolExecutor:
        if self._pool is None:
            dev = self.grid.device
            init = (lambda: torch.cuda.set_device(dev)) \
                if dev.type == "cuda" else None
            self._pool = cf.ThreadPoolExecutor(
                1, thread_name_prefix="shard-bcast", initializer=init)
        return self._pool

    def close(self) -> None:
        """Stop the frame thread (after the last frame completed)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _zero(self, shape: Tuple[int, ...], dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        z = self._zeros.get(key)
        if z is None:
            z = self._zeros[key] = torch.zeros(shape, dtype=dtype,
                                               device=self.grid.device)
        return z

    def broadcast_async(self, payload, owner_flat: int,
                        shape: Tuple[int, ...], dtype,
                        panel: Optional[int] = None,
                        ahead: bool = False) -> _InflightFrame:
        """Issue the replication of `payload` (a `shape` device tensor
        on the owner; ignored elsewhere) from grid position `owner_flat`.
        Every rank calls in the same order. ``ahead`` marks a lookahead
        issue (``ooc.shard.bcast_ahead``)."""
        shape = tuple(int(s) for s in shape)
        if self.grid.index == owner_flat:
            x = payload.reshape(shape).contiguous()
        else:
            x = self._zero(shape, dtype)
        nb = x.element_size() * int(np.prod(shape))
        self.panels += 1
        self.bytes += nb
        if ahead:
            self.ahead += 1
        fgrid = self._fgrid

        def traverse():
            # the ppermute fault site, inside the retried unit: an
            # injected fault re-runs the whole traversal
            _tree.record_schedule("shard_bcast", self.size, self.fanin)
            if fgrid is None:
                return x
            return _tree.tree_combine(
                fgrid, x, lambda vals: functools.reduce(torch.add, vals),
                WHOLE, self.size, fanin=self.fanin)

        def run():
            if _faults.active() is not None:
                return _guard.retry(traverse, "ppermute",
                                    op="shard_bcast", size=self.size)
            try:
                return traverse()
            except Exception as e:
                if not _guard.is_transient(e):
                    raise
                return _guard.retry_after_failure(
                    traverse, "ppermute", e, op="shard_bcast",
                    size=self.size)

        def task():
            if obs_events.enabled():
                with obs_events.span("shard::bcast", cat="shard",
                                     owner=owner_flat, bytes=nb,
                                     ahead=ahead):
                    return run()
            return run()

        if obs_events.enabled():
            obs_metrics.inc("ooc.shard.bcast_panels")
            obs_metrics.inc("ooc.shard.bcast_bytes", nb)
            if ahead:
                obs_metrics.inc("ooc.shard.bcast_ahead")
        if fgrid is None:
            fut: cf.Future = cf.Future()
            fut.set_result(task())
        else:
            fut = self._executor().submit(task)
        return _InflightFrame(fut, panel)

    def complete(self, fr: _InflightFrame) -> torch.Tensor:
        """Wait for an issued frame and return the replicated panel."""
        t0 = time.perf_counter()
        if obs_events.enabled():
            with obs_events.span("shard::bcast_wait", cat="shard",
                                 panel=fr.panel):
                arr = fr.fut.result()
                _tree.complete_schedule("shard_bcast", arr)
        else:
            arr = fr.fut.result()
            _tree.complete_schedule("shard_bcast", arr)
        wait = time.perf_counter() - t0
        inflight = time.perf_counter() - fr.issued_at
        self.wait_seconds += wait
        self.inflight_seconds += inflight
        _ledger.credit("bcast_wait", wait)
        if obs_events.enabled():
            obs_metrics.inc("ooc.shard.bcast_wait_seconds", wait)
            obs_metrics.inc("ooc.shard.bcast_inflight_seconds", inflight)
        return arr

    def overlap_fraction(self) -> float:
        """The share of the issue-to-completion wall hidden behind other
        work (0 for the synchronous schedule)."""
        if self.inflight_seconds <= 0:
            return 0.0
        return max(0.0, 1.0 - self.wait_seconds / self.inflight_seconds)

    def broadcast(self, payload, owner_flat: int,
                  shape: Tuple[int, ...], dtype,
                  panel: Optional[int] = None) -> torch.Tensor:
        """Issue and complete (depth 0 and the m < n tail panels)."""
        return self.complete(self.broadcast_async(
            payload, owner_flat, shape, dtype, panel=panel))


def _shard_fanin(fanin: Optional[int], n: int, dtype) -> int:
    if fanin:
        return int(fanin)
    from ..tune.select import resolve
    return int(resolve("ooc", "shard_fanin", n=n, dtype=dtype))


def _shard_lookahead(lookahead: Optional[int], n: int, dtype) -> int:
    """Broadcast depth: explicit > ``ooc/shard_lookahead`` (FROZEN 0)."""
    if lookahead is not None:
        return max(int(lookahead), 0)
    from ..core.methods import MethodOOC
    return MethodOOC.lookahead(n, dtype)


def _panel_bounds(k: int, w: int, n: int, kmax: int
                  ) -> Tuple[int, int, int, int]:
    """Panel k's (k0, k1, wk, wf): its columns, their count, and the
    factored-column count (wf < wk only where kmax = min(m, n) falls
    inside the panel)."""
    k0, k1 = k * w, min(k * w + w, n)
    return k0, k1, k1 - k0, min(k1, kmax) - k0


def _host_ckpt_path(path: Optional[str], grid: ProcessGrid
                    ) -> Optional[str]:
    """This rank's checkpoint directory under `path` (one a grid
    position: each rank mirrors the whole factor on its own)."""
    if path is None:
        return None
    return os.path.join(path, "host%d" % grid.index)


def _agree_epoch(grid: ProcessGrid, epoch: int) -> int:
    """The resume epoch every rank starts from: the minimum of the
    ranks' committed epochs (ranks crash at different commit points)."""
    if grid.group() is None or grid.nprocs == 1:
        return int(epoch)
    from ..parallel.collectives import all_reduce
    t = torch.tensor([-int(epoch)], dtype=torch.int64, device=grid.device)
    return -int(all_reduce(grid, t, op="max")[0])


#: counters each per-step obs record reports as deltas
_STEP_OBS_KEYS = ("ooc.h2d_bytes", "ooc.d2h_bytes",
                  "ooc.shard.bcast_panels", "ooc.shard.bcast_bytes")


def _step_obs_fn(op: str) -> Callable[[int], None]:
    """Per-step publisher: after each panel step one ``shard::step_obs``
    instant carries that step's delta of the staging and broadcast
    counters (baseline taken at creation, so concurrent drivers never
    take each other's deltas). Free with obs off."""
    seed = obs_metrics.snapshot()["counters"]
    prev: Dict[str, float] = {key: seed.get(key, 0)
                              for key in _STEP_OBS_KEYS}

    def publish(k: int) -> None:
        if not obs_events.enabled():
            return
        cur = obs_metrics.snapshot()["counters"]
        delta = {key.rsplit(".", 1)[-1]:
                 cur.get(key, 0) - prev.get(key, 0)
                 for key in _STEP_OBS_KEYS}
        prev.update({key: cur.get(key, 0) for key in _STEP_OBS_KEYS})
        obs_events.instant("shard::step_obs", cat="shard", op=op,
                           step=k, **delta)

    return publish


class _ShardState:
    """This rank's trailing-panel working set: the first touch stages
    the input through the engine (exact prefetch), later touches hit the
    stash or re-stage a spilled state from the host scratch `ws`
    (allocated only for panels that spill). ``upto`` maps a panel to the
    next update step it has not absorbed (the lookahead prologue marks
    promoted steps applied, so the sweep skips them)."""

    def __init__(self, eng, loader: Callable[[int], Callable],
                 scratch: Callable[[int], Tuple[int, ...]],
                 dtype) -> None:
        self.eng = eng
        self._loader = loader
        self._scratch = scratch
        self.dtype = dtype
        self.ws: Dict[int, np.ndarray] = {}
        self.staged: set = set()
        self.upto: Dict[int, int] = {}

    def applied_through(self, j: int) -> int:
        return self.upto.get(j, 0)

    def mark_applied(self, j: int, step: int) -> None:
        self.upto[j] = step + 1

    def spill_view(self, k: int) -> Callable[[], np.ndarray]:
        def view():
            if k not in self.ws:
                self.ws[k] = np.empty(self._scratch(k), self.dtype)
            return self.ws[k]
        return view

    def take(self, k: int):
        if k not in self.staged:
            self.staged.add(k)
            return self.eng.fetch("S", k, self._loader(k), cache=False)
        return self.eng.fetch("S", k, lambda: self.ws[k])

    def prefetch_panel(self, k: Optional[int]) -> None:
        """Stage k's first-touch input ahead (re-stages of spilled
        states stay synchronous)."""
        if k is not None and k not in self.staged:
            self.eng.prefetch("S", k, self._loader(k), cache=False)

    def prefetch_next(self, todo: List[int], i: int) -> None:
        self.prefetch_panel(
            next((j for j in todo[i + 1:] if j not in self.staged),
                 None))

    def stash(self, k: int, arr) -> None:
        self.eng.stash("S", k, arr, self.spill_view(k))

    def discard(self, k: int) -> None:
        self.eng.discard("S", k)
        self.ws.pop(k, None)


class _BcastPipeline:
    """The lookahead walk (module doc). Depth 0 is the step-synchronous
    schedule. The driver supplies ``payload_shape(k)`` -> (shape, dtype)
    of panel k's frame, ``make_payload(k, S)`` (the owner's factor),
    ``complete(k, frame)`` -> the step's update record (the host
    bookkeeping and the mirror write run here, once a panel, ascending),
    ``replay(k)`` (the record from the durable mirror, below the resume
    epoch) and ``apply(S, rec, j)`` (panel j absorbs the record).

    Step k: ``obtain(k)`` (the completed record of panel k),
    ``advance(k, rec)`` (the prologue: each owned panel in (k, k+depth]
    is promoted through its pending frames, factored, and its broadcast
    issued without completing it) and ``updates(k, rec)`` (the trailing
    sweep the in-flight frames hide under). The ``step`` fault check
    fires once a panel, at the slot that processes it."""

    def __init__(self, op: str, sched: CyclicSchedule,
                 bc: PanelBroadcaster, st: _ShardState, depth: int,
                 epoch: int, factor_panels: List[int],
                 payload_shape: Callable, make_payload: Callable,
                 complete: Callable, replay: Callable,
                 apply: Callable) -> None:
        self.op = op
        self.sched = sched
        self.bc = bc
        self.st = st
        self.depth = max(int(depth), 0)
        self.epoch = int(epoch)
        self.last = factor_panels[-1] if factor_panels else -1
        self._payload_shape = payload_shape
        self._make_payload = make_payload
        self._complete = complete
        self._replay = replay
        self._apply = apply
        self.pending: Dict[int, _InflightFrame] = {}
        self.done: Dict[int, Any] = {}
        self.issued = -1
        self._checked: set = set()

    def _check(self, k: int) -> None:
        if k not in self._checked:
            self._checked.add(k)
            _faults.check("step", op=self.op, step=k,
                          mine=bool(self.sched.is_mine(k)))

    def _issue(self, k: int, ahead: bool) -> _InflightFrame:
        """Factor (on the owner) and issue panel k's broadcast; the
        owner's state already holds updates 0..k-1."""
        if self.sched.is_mine(k):
            with _ledger.frame("stage"):
                S = self.st.take(k)
            with obs_events.span("shard::factor", cat="shard",
                                 panel=k, ahead=ahead), \
                    _ledger.frame("factor"):
                payload = self._make_payload(k, S)
            self.st.discard(k)
        else:
            payload = None
        shape, dtype = self._payload_shape(k)
        return self.bc.broadcast_async(payload, self.sched.owner_flat(k),
                                       shape, dtype, panel=k,
                                       ahead=ahead)

    def _finish(self, fr: _InflightFrame):
        return self._complete(fr.panel, self.bc.complete(fr))

    def obtain(self, k: int):
        """Phase 1: the completed record of panel k."""
        self._check(k)
        if k in self.done:
            return self.done.pop(k)
        if k < self.epoch:
            return self._replay(k)
        fr = self.pending.pop(k, None)
        if fr is None:              # synchronous (depth 0, first panel)
            fr = self._issue(k, ahead=False)
        return self._finish(fr)

    def _promote(self, i: int, k: int, rec) -> None:
        """Apply every frame panel i has not absorbed, ascending."""
        for s in range(self.st.applied_through(i), i):
            r = rec if s == k else self.done[s]
            with _ledger.frame("stage"):
                S = self.st.take(i)
            with obs_events.span("shard::update", cat="shard",
                                 panel=i, step=s, ahead=True), \
                    _ledger.frame("update"):
                S = self._apply(S, r, i)
            self.st.mark_applied(i, s)
            self.st.stash(i, S)

    def advance(self, k: int, rec) -> None:
        """Phase 2: issue up to ``min(k + depth, last)``."""
        if self.issued < k:
            self.issued = k
        limit = min(k + self.depth, self.last)
        while self.issued < limit:
            i = self.issued + 1
            prev = i - 1
            if prev > k and prev not in self.done:
                # panel i's factor needs frame i-1 realized first
                self._check(prev)
                if prev < self.epoch:
                    self.done[prev] = self._replay(prev)
                else:
                    self.done[prev] = self._finish(self.pending.pop(prev))
            if i < self.epoch:
                self.issued = i
                continue
            self._check(i)
            if self.sched.is_mine(i):
                self._promote(i, k, rec)
            self.pending[i] = self._issue(i, ahead=True)
            self.issued = i

    def updates(self, k: int, rec) -> None:
        """Phase 3: the trailing sweep on this rank's remaining owned
        panels."""
        todo = [j for j in self.sched.update_order(k, self.depth,
                                                   self.epoch)
                if self.st.applied_through(j) <= k]
        t0 = time.perf_counter()
        for i, j in enumerate(todo):
            with _ledger.frame("stage"):
                S_j = self.st.take(j)
            self.st.prefetch_next(todo, i)
            with obs_events.span("shard::update", cat="shard",
                                 panel=j, step=k), \
                    _ledger.frame("update"):
                S_j = self._apply(S_j, rec, j)
            self.st.mark_applied(j, k)
            self.st.stash(j, S_j)
        obs_metrics.inc("ooc.shard.update_seconds",
                        time.perf_counter() - t0)


def _publish_overlap(op: str, bc: PanelBroadcaster, depth: int) -> None:
    """The driver-exit overlap record: wait and in-flight walls and the
    overlap fraction (``ooc.shard.bcast_overlap_fraction``)."""
    if not obs_events.enabled():
        return
    obs_metrics.observe("ooc.shard.bcast_overlap_fraction",
                        bc.overlap_fraction())
    obs_events.instant("shard::overlap", cat="shard", op=op,
                       depth=depth, ahead=bc.ahead,
                       wait_s=round(bc.wait_seconds, 6),
                       inflight_s=round(bc.inflight_seconds, 6),
                       overlap=round(bc.overlap_fraction(), 4))


def _fused(apply: Callable, fuse_meta: Dict[int, dict], w: int
           ) -> Callable:
    """The fused trailing sweep of one record: one graph node over the
    owned panels consuming it, each member through the per-panel visit
    body at its true size (bitwise the per-panel route)."""
    def fused_apply(Ss, rec, ps, s):
        fuse_meta[s] = {"fused_members": list(ps),
                        "fused_width": len(ps) * w}
        return [apply(S, rec, p) for S, p in zip(Ss, ps)]
    return fused_apply


def _run_stream(op: str, use_graph: bool, *, sched, bc, st, depth,
                epoch, factor_panels, tail_panels, payload_shape,
                make_payload, complete, replay, apply, tail_step,
                led, ck, eng, step_obs, nt, elastic=None,
                fused_apply=None, fuse_meta=None) -> None:
    """The issue loop of the three drivers: the ``_BcastPipeline`` walk
    (``scheduler="walk"``, FROZEN), the task graph of
    ``sched.policies.sharded_stream`` run by ``sched.runtime.execute``
    (``"graph"``, bitwise the walk), or, with an
    :class:`~.elastic.ElasticController`, the segmented re-ownership
    loop of ``dist.elastic.run_elastic`` (always graphs: ownership is an
    input of their construction). ``tail_step(k)`` is the body of the
    m < n tail panels (None for potrf). Fused sweeps imply the graph
    route."""
    if elastic is not None:
        from . import elastic as _elastic
        _elastic.run_elastic(
            elastic, op=op, bc=bc, st=st, depth=depth, epoch=epoch,
            factor_panels=factor_panels, tail_panels=tail_panels,
            payload_shape=payload_shape, make_payload=make_payload,
            complete=complete, replay=replay, apply=apply,
            tail_step=tail_step, led=led, ck=ck, eng=eng,
            step_obs=step_obs, nt=nt, fused_apply=fused_apply,
            fuse_meta=fuse_meta)
        return
    last = factor_panels[-1] if len(factor_panels) else -1
    if use_graph:
        from ..sched import policies as _policies
        from ..sched.runtime import execute as _execute
        g = _policies.sharded_stream(
            op, sched=sched, bc=bc, st=st, depth=depth, epoch=epoch,
            factor_panels=factor_panels, tail_panels=tail_panels,
            payload_shape=payload_shape, make_payload=make_payload,
            complete=complete, replay=replay, apply=apply,
            tail=tail_step, fused_apply=fused_apply)

        def _begin(k):
            if led is not None:
                led.begin(k, owner=sched.owner_process(k), epoch=epoch)

        def _end(k):
            if k <= last:
                step_obs(k)
            if ck is not None and k >= epoch and ck.due(k):
                eng.wait_writes()   # every panel <= k is durable;
                ck.commit(k + 1)    # the in-flight panel is not
            if led is not None:
                led.commit(**(fuse_meta.pop(k, {}) if fuse_meta
                              else {}))

        _execute(g, op=op, nt=nt, begin_step=_begin, end_step=_end)
        # deep lookahead keys every node below slot nt-1, so the last
        # slots never open: land the final checkpoint here
        if ck is not None and ck.epoch < nt:
            eng.wait_writes()
            ck.commit(nt)
        return
    pipe = _BcastPipeline(op, sched, bc, st, depth, epoch,
                          list(factor_panels), payload_shape,
                          make_payload, complete, replay, apply)
    for k in factor_panels:
        if led is not None:
            led.begin(k, owner=sched.owner_process(k), epoch=epoch)
        _health.heartbeat(op, k, nt)
        rec = pipe.obtain(k)
        # the prologue before the sweep: the next frame travels while
        # this rank applies its remaining k-updates
        pipe.advance(k, rec)
        pipe.updates(k, rec)
        step_obs(k)
        if ck is not None and k >= epoch and ck.due(k):
            eng.wait_writes()
            ck.commit(k + 1)
        if led is not None:
            led.commit()
    for k in tail_panels:
        # columns past kmax (m < n): all updates applied, the state is
        # the final U block, one broadcast gives it to every rank
        if led is not None:
            led.begin(k, owner=sched.owner_process(k), epoch=epoch)
        _health.heartbeat(op, k, nt)
        _faults.check("step", op=op, step=k,
                      mine=bool(sched.is_mine(k)))
        if k < epoch:
            continue
        tail_step(k)
        if ck is not None and ck.due(k):
            eng.wait_writes()
            ck.commit(k + 1)
        if led is not None:
            led.commit()


class _Setup:
    """What the three drivers resolve alike: the agreed panel width and
    knobs, the schedule (or the elastic controller), the broadcaster,
    the checkpointer and the engine."""

    def __init__(self, op: str, a: np.ndarray, grid: ProcessGrid,
                 n: int, eng_n: int, panel_cols, cache_budget_bytes,
                 fanin, lookahead, precision, scheduler, ownership,
                 visit_fuse, ckpt_path, ckpt_every, extra_arrays=None,
                 extra_meta=None) -> None:
        from ..linalg import stream
        from ..linalg.ooc import (_panel_cols, _precision_meta,
                                  _resolve_precision, _resolve_scheduler,
                                  _resolve_visit_fuse)
        from .elastic import ElasticController, _resolve_ownership
        dt = a.dtype
        w = min(_panel_cols(panel_cols, n, dt), n)
        lo = _resolve_precision(precision, n, dt)
        fuse = _resolve_visit_fuse(visit_fuse, n, dt)
        graph = _resolve_scheduler(scheduler, n, dt) or fuse
        depth = _shard_lookahead(lookahead, n, dt)
        fan = _shard_fanin(fanin, n, dt)
        elastic = _resolve_ownership(ownership, n, dt)
        # grid index 0's choices (collectives.agree): ranks whose tune
        # caches differ must not run different loops
        from ..parallel.collectives import agree
        w, fan, depth, mixed, elastic, fuse, graph = agree(
            grid, w, fan, depth, lo is not None, elastic, fuse, graph)
        if not mixed:
            lo = None
        elif lo is None:
            lo = _resolve_precision("bf16", n, dt)
        self.w, self.depth, self.lo = w, depth, lo
        self.use_fuse, self.use_graph = bool(fuse), bool(graph)
        self.nt = ceil_div(n, w)
        self.ctrl = ElasticController(op, grid, self.nt, n=n, dtype=dt) \
            if elastic else None
        self.sched = self.ctrl.sched if self.ctrl is not None \
            else CyclicSchedule(self.nt, grid)
        self.bc = PanelBroadcaster(grid, fan)
        self.ckdir = _host_ckpt_path(ckpt_path, grid)
        meta = {"precision": _precision_meta(lo)}
        meta.update(extra_meta or {})
        if callable(extra_arrays):
            extra_arrays = extra_arrays(w)
        self.ck = _ckpt.maybe_checkpointer(
            self.ckdir, op, a, w, self.nt, every=ckpt_every,
            extra_arrays=extra_arrays, extra_meta=meta)
        epoch = self.ck.epoch if self.ck is not None else 0
        # a collective: every rank takes part, checkpointing or not
        self.epoch = _agree_epoch(grid, epoch) \
            if ckpt_path is not None else 0
        self.eng = stream.engine_for(
            eng_n, w, dt, budget_bytes=cache_budget_bytes,
            device=grid.device, extra_pins=depth, resident_dtype=lo)
        self.fuse_meta: Dict[int, dict] = {}
        self.led = _ledger.recorder(op, nt=self.nt, spill_dir=self.ckdir)

    def schedule_instant(self, op: str, **extra) -> None:
        if obs_events.enabled():
            from ..linalg.ooc import _precision_meta
            obs_events.instant(
                "shard::schedule", cat="shard", op=op, nt=self.nt,
                ranks=self.sched.nranks,
                mine=len(self.sched.my_panels()), lookahead=self.depth,
                resume_epoch=self.epoch,
                precision=_precision_meta(self.lo), **extra)

    def run(self, op: str, st: _ShardState, *, factor_panels,
            tail_panels, payload_shape, make_payload, complete, replay,
            apply, tail_step) -> None:
        """The stream, then the completion beat, the drain record and
        the writebacks; the frame thread, the engine and the recorder
        are released whatever happens."""
        fused = _fused(apply, self.fuse_meta, self.w) \
            if self.use_fuse else None
        kind = op.split("_")[1]
        step_obs = _step_obs_fn(kind)
        try:
            _run_stream(op, self.use_graph, sched=self.sched, bc=self.bc,
                        st=st, depth=self.depth,
                        epoch=self.epoch, factor_panels=factor_panels,
                        tail_panels=tail_panels,
                        payload_shape=payload_shape,
                        make_payload=make_payload, complete=complete,
                        replay=replay, apply=apply, tail_step=tail_step,
                        led=self.led, ck=self.ck, eng=self.eng,
                        step_obs=step_obs, nt=self.nt, elastic=self.ctrl,
                        fused_apply=fused,
                        fuse_meta=self.fuse_meta if fused else None)
            _health.heartbeat(op, self.nt, self.nt)   # completion beat
            if self.led is not None:
                self.led.begin(self.nt, epoch=self.epoch, drain=True)
            self.eng.wait_writes()
        finally:
            self.bc.close()
            self.eng.finish()
            if self.led is not None:
                self.led.close()
        _publish_overlap(kind, self.bc, self.depth)


def _h2d_mirror(cols: np.ndarray, lo, dev) -> torch.Tensor:
    """A replayed frame from the host mirror: the column as it was
    broadcast (demoting a promoted lo frame gives it back exactly)."""
    from ..linalg import stream
    if lo is None:
        return stream._h2d(cols, dev)
    return stream._h2d(stream.demote_host(cols, lo), dev)


def _grid_arg(grid, what: str) -> ProcessGrid:
    """`grid` as a ProcessGrid this rank belongs to; anything else (None
    too) raises TypeError naming the driver."""
    from ..core.options import Option
    from ..parallel.mesh import option_grid
    if grid is None:
        raise TypeError("%s: grid must be a ProcessGrid "
                        "(parallel.make_grid), got None" % what)
    return option_grid({Option.Grid: grid}, what)


@instrument_driver("shard_potrf_ooc")
def shard_potrf_ooc(a: np.ndarray, grid: ProcessGrid,
                    panel_cols: Optional[int] = None,
                    cache_budget_bytes=None,
                    fanin: Optional[int] = None,
                    lookahead: Optional[int] = None,
                    ckpt_path: Optional[str] = None,
                    ckpt_every: Optional[int] = None,
                    precision=None, scheduler=None, ownership=None,
                    visit_fuse=None) -> np.ndarray:
    """Sharded out-of-core lower Cholesky (module doc). Every rank of
    `grid` calls it with the same host matrix and returns the whole host
    lower factor, bitwise ``potrf_ooc``'s, on the grid's device.

    ``lookahead``: the broadcast depth (explicit > ``ooc/shard_lookahead``,
    FROZEN 0), bitwise at every depth. ``ckpt_path`` / ``ckpt_every``:
    each rank keeps a durable mirror under ``ckpt_path/host<index>``; a
    resume starts at the ranks' minimum committed epoch, replaying the
    panels below it from the local mirror, bitwise the uninterrupted
    factor. ``precision`` "bf16": lo frames (half the bytes), the mirror
    holds the promoted frames. ``scheduler`` "walk" (FROZEN) or "graph";
    ``ownership`` "static" (FROZEN) or "elastic" (dist/elastic.py);
    ``visit_fuse`` "per_panel" (FROZEN) or "fused" (graph route). All
    bitwise the static walk, except the precision."""
    from ..linalg import stream
    from ..linalg.ooc import _panel_apply, _panel_factor
    grid = _grid_arg(grid, "shard_potrf_ooc")
    a = np.asarray(a)
    n = a.shape[0]
    su = _Setup("shard_potrf_ooc", a, grid, n, n, panel_cols,
                cache_budget_bytes, fanin, lookahead, precision,
                scheduler, ownership, visit_fuse, ckpt_path, ckpt_every)
    w, lo, eng = su.w, su.lo, su.eng
    hi = stream._torch_dtype(a.dtype)
    out = su.ck.factor if su.ck is not None else np.zeros_like(a)
    su.schedule_instant("potrf")

    def loader(k):
        k0, k1 = k * w, min(k * w + w, n)
        return lambda: a[k0:, k0:k1]

    st = _ShardState(eng, loader,
                     lambda k: (n - k * w, min(w, n - k * w)), a.dtype)

    def payload_shape(k):
        return (n, min(w, n - k * w)), (hi if lo is None else lo)

    def make_payload(k, S):
        k0 = k * w
        Lk = _panel_factor(S, min(w, n - k0))
        _guard.check_panel("shard_potrf_ooc", k, Lk, ref=S)
        if lo is not None:
            # demoted before the tree: half the bytes, and every rank
            # (the owner too) takes its updates and mirror from it
            Lk = stream.demote_dev(Lk, lo)
        return stream._embed_rows(Lk, k0, n=n)

    def complete(k, frame):
        k0, k1 = k * w, min(k * w + w, n)
        col = frame if lo is None else stream.promote_dev(frame, hi)
        eng.write("L", k, stream._suffix_rows(col, k0, rows=n - k0),
                  out[k0:, k0:k1])
        return frame

    def replay(k):
        # below the resume epoch (or a panel caught up after a remap)
        # the factor is durable in the mirror
        k0, k1 = k * w, min(k * w + w, n)
        eng.wait_writes()
        return _h2d_mirror(out[:, k0:k1], lo, grid.device)

    def apply(S_j, frame, j):
        j0 = j * w
        Lr = stream._suffix_rows(frame, j0, rows=n - j0)
        return _panel_apply(S_j, Lr, min(w, n - j0))

    su.run("shard_potrf_ooc", st, factor_panels=list(range(su.nt)),
           tail_panels=[], payload_shape=payload_shape,
           make_payload=make_payload, complete=complete, replay=replay,
           apply=apply, tail_step=None)
    return out


@instrument_driver("shard_geqrf_ooc")
def shard_geqrf_ooc(a: np.ndarray, grid: ProcessGrid,
                    panel_cols: Optional[int] = None,
                    incore_ib: int = 128,
                    cache_budget_bytes=None,
                    fanin: Optional[int] = None,
                    lookahead: Optional[int] = None,
                    ckpt_path: Optional[str] = None,
                    ckpt_every: Optional[int] = None,
                    precision=None, scheduler=None, ownership=None,
                    visit_fuse=None):
    """Sharded out-of-core Householder QR: shard_potrf_ooc's walk with
    full-height panel states; the frame is the factored column plus one
    row of the panel's taus. Returns (QR_packed, taus) on every rank,
    bitwise ``geqrf_ooc``'s. Options as shard_potrf_ooc (bf16 demotes
    the column and its tau row together)."""
    from ..linalg import stream
    from ..linalg.ooc import _qr_apply_fresh, _qr_panel_factor, _qr_visit
    grid = _grid_arg(grid, "shard_geqrf_ooc")
    a = np.asarray(a)
    m, n = a.shape
    kmax = min(m, n)
    su = _Setup("shard_geqrf_ooc", a, grid, n, max(m, n), panel_cols,
                cache_budget_bytes, fanin, lookahead, precision,
                scheduler, ownership, visit_fuse, ckpt_path, ckpt_every,
                extra_arrays={"taus": ((kmax,), a.dtype)})
    w, lo, eng, ctrl = su.w, su.lo, su.eng, su.ctrl
    hi = stream._torch_dtype(a.dtype)
    dev = grid.device
    if su.ck is not None:
        out, taus = su.ck.factor, su.ck.array("taus")
    else:
        out = np.empty_like(a)
        taus = np.zeros((kmax,), a.dtype)
    su.schedule_instant("geqrf")
    nt = su.nt

    def loader(k):
        k0, k1 = k * w, min(k * w + w, n)
        return lambda: a[:, k0:k1]

    st = _ShardState(eng, loader, lambda k: (m, min(w, n - k * w)),
                     a.dtype)
    factor_panels = [k for k in range(nt) if k * w < kmax]
    tail_panels = [k for k in range(nt) if k * w >= kmax]

    def bounds(k):
        return _panel_bounds(k, w, n, kmax)

    def payload_shape(k):
        wk = bounds(k)[2]
        return (m + 1, wk), (hi if lo is None else lo)

    def make_payload(k, S):
        k0, _k1, wk, wf = bounds(k)
        packed, ptau = _qr_panel_factor(S[:, :wf], k0, incore_ib)
        _guard.check_panel("shard_geqrf_ooc", k, packed, ref=S)
        low = packed
        if wf < wk:
            # kmax inside this panel (m < n): the tail columns are R
            # rows of the fresh apply, as geqrf_ooc writes them
            low = torch.cat([low, _qr_apply_fresh(S[k0:, wf:], packed,
                                                  ptau)], dim=1)
        col = torch.cat([S[:k0], low], dim=0) if k0 > 0 else low
        tau_row = torch.zeros((1, wk), dtype=hi, device=S.device)
        tau_row[0, :wf] = ptau[:wf]
        payload = torch.cat([col, tau_row], dim=0)
        if lo is not None:
            payload = stream.demote_dev(payload, lo)
        return payload

    def complete(k, payload):
        k0, k1, _wk, wf = bounds(k)
        if lo is None:
            col = payload[:m]
            taus[k0:k0 + wf] = payload[m, :wf].cpu().numpy()
            eng.write("QR", k, col, out[:, k0:k1])
            return col[:, :wf], payload[m, :wf], k0
        colf = stream.promote_dev(payload, hi)
        taus[k0:k0 + wf] = colf[m, :wf].cpu().numpy()
        eng.write("QR", k, colf[:m], out[:, k0:k1])
        # the record keeps the LO column (the mixed visit's operand) and
        # the taus widened for the f32 T algebra
        return payload[:m, :wf], colf[m, :wf], k0

    def replay(k):
        k0, k1, _wk, wf = bounds(k)
        eng.wait_writes()
        col = _h2d_mirror(out[:, k0:k1], lo, dev)
        return col[:, :wf], stream._h2d(taus[k0:k0 + wf], dev), k0

    def apply(S_j, rec, j):
        Pk, tk, k0 = rec
        return _qr_visit(S_j, Pk, tk, k0, lo=lo)

    def tail_step(k):
        # the state is the final U block; ownership read live (a remap
        # may have moved the tail panel)
        s = ctrl.sched if ctrl is not None else su.sched
        k0, k1 = k * w, min(k * w + w, n)
        frame = st.take(k) if s.is_mine(k) else None
        if frame is not None:
            st.discard(k)
        frame = su.bc.broadcast(frame, s.owner_flat(k), (m, k1 - k0),
                                hi, panel=k)
        eng.write("QR", k, frame, out[:, k0:k1])

    su.run("shard_geqrf_ooc", st, factor_panels=factor_panels,
           tail_panels=tail_panels, payload_shape=payload_shape,
           make_payload=make_payload, complete=complete, replay=replay,
           apply=apply, tail_step=tail_step)
    return out, taus


@instrument_driver("shard_getrf_ooc")
def shard_getrf_ooc(a: np.ndarray, grid: ProcessGrid,
                    panel_cols: Optional[int] = None,
                    incore_nb: int = 1024,
                    cache_budget_bytes=None,
                    fanin: Optional[int] = None,
                    lookahead: Optional[int] = None,
                    chunk: Optional[int] = None,
                    ckpt_path: Optional[str] = None,
                    ckpt_every: Optional[int] = None,
                    precision=None, scheduler=None, ownership=None,
                    visit_fuse=None):
    """Sharded out-of-core tournament-pivot LU (module doc): full-height
    states in original row order; the owner of panel k selects its
    pivots (CALU tournament) before its column is written, and the frame
    is the column plus one row of the live-relative selection (two
    byte-split rows under bf16), from which every rank derives the same
    (ipiv, permutation) by ``lu.tnt_swaps_host``. Returns (LU_packed,
    ipiv) on every rank, bitwise ``getrf_tntpiv_ooc``'s. The selection
    must fit the frame dtype's exact-integer window (m <= 2^24 in f32,
    2^16 in the bf16 pair)."""
    from ..core.exceptions import slate_assert
    from ..linalg import stream
    from ..linalg.ca import fix_degenerate_selection
    from ..linalg.lu import tnt_swaps_host
    from ..linalg.ooc import (_finalize_lapack_order, _lu_visit_orig,
                              _tnt_factor, _tnt_select, _tnt_tail_cols,
                              _to_dev)
    grid = _grid_arg(grid, "shard_getrf_ooc")
    a = np.asarray(a)
    m, n = a.shape
    kmax = min(m, n)
    su = _Setup("shard_getrf_ooc", a, grid, n, max(m, n), panel_cols,
                cache_budget_bytes, fanin, lookahead, precision,
                scheduler, ownership, visit_fuse, ckpt_path, ckpt_every,
                extra_arrays=lambda w: {
                    "ipiv": ((kmax,), np.int64),
                    "perms": ((ceil_div(kmax, w), m), np.int64)},
                extra_meta={"lu_pivot": "tournament"})
    w, lo, eng, ctrl = su.w, su.lo, su.eng, su.ctrl
    hi = stream._torch_dtype(a.dtype)
    dev = grid.device
    window = (1 << 16) if lo is not None \
        else (1 << (np.finfo(a.dtype).nmant + 1))
    slate_assert(
        m <= window,
        "shard_getrf_ooc encodes pivot rows in the frame; m=%d exceeds "
        "the exact-integer window %d: use a wider dtype or the "
        "single-engine getrf_tntpiv_ooc" % (m, window))
    nt, epoch = su.nt, su.epoch
    nf = ceil_div(kmax, w)
    if su.ck is not None:
        stored, ipiv = su.ck.factor, su.ck.array("ipiv")
        perms = su.ck.array("perms")
    else:
        stored = np.empty_like(a)
        ipiv = np.empty((kmax,), np.int64)
        perms = np.empty((nf, m), np.int64)
    perm = perms[min(epoch, nf) - 1].copy() if min(epoch, nf) > 0 \
        else np.arange(m)
    # the panel whose permutation `perm` holds: completes advance it,
    # replays only move it forward (an elastic segment replays old steps
    # for catch-up panels after later completes advanced it)
    perm_step = [min(epoch, nf) - 1]
    su.schedule_instant("getrf")

    def loader(k):
        k0, k1 = k * w, min(k * w + w, n)
        return lambda: a[:, k0:k1]

    st = _ShardState(eng, loader, lambda k: (m, min(w, n - k * w)),
                     a.dtype)
    factor_panels = [k for k in range(nt) if k * w < kmax]
    tail_panels = [k for k in range(nt) if k * w >= kmax]

    def bounds(k):
        return _panel_bounds(k, w, n, kmax)

    def payload_shape(k):
        wk = bounds(k)[2]
        return ((m + 1, wk), hi) if lo is None else ((m + 2, wk), lo)

    def make_payload(k, S):
        # the tournament runs against the current `perm`, advanced
        # through frame k-1 by the ascending completions
        k0, _k1, wk, wf = bounds(k)
        live = m - k0
        sel = _tnt_select(S, _to_dev(perm[k0:], dev), wf, chunk=chunk)
        sel = fix_degenerate_selection(sel, live, wf)
        _piv, lperm = tnt_swaps_host(sel, live)
        new_live = _to_dev(perm[k0:][lperm], dev)
        col, packed = _tnt_factor(S, new_live, wf,
                                  min(int(incore_nb), max(wf, 1)))
        _guard.check_panel("shard_getrf_ooc", k, col, ref=S)
        if wf < wk:
            # kmax inside this panel (m < n): the U12 tail columns
            col = torch.cat([col, _tnt_tail_cols(S, packed, new_live,
                                                 wf)], dim=1)
        sel = torch.as_tensor(np.asarray(sel, np.int64))
        if lo is None:
            rows = torch.zeros((1, wk), dtype=hi)
            rows[0, :wf] = sel.to(hi)
            return torch.cat([col, rows.to(dev)], dim=0)
        # the byte-split pair: bf16 holds 0 ... 255 exactly
        rows = torch.zeros((2, wk), dtype=lo)
        rows[0, :wf] = (sel // 256).to(lo)
        rows[1, :wf] = (sel % 256).to(lo)
        return torch.cat([stream.demote_dev(col, lo), rows.to(dev)],
                         dim=0)

    def complete(k, payload):
        k0, k1, _wk, wf = bounds(k)
        live = m - k0
        if lo is None:
            colfull = payload[:m]
            sel = np.rint(torch.real(payload[m, :wf]).cpu().double()
                          .numpy())
        else:
            colfull = stream.promote_dev(payload[:m], hi)
            srows = np.rint(payload[m:m + 2, :wf].cpu().double().numpy())
            sel = srows[0] * 256 + srows[1]
        # every rank (the owner too) derives the pivot bookkeeping from
        # the one broadcast selection
        piv_rel, lperm = tnt_swaps_host(sel.astype(np.int64), live)
        perm[k0:] = perm[k0:][lperm]
        ipiv[k0:k0 + wf] = k0 + piv_rel
        perms[k] = perm
        perm_step[0] = k
        eng.write("LU", k, colfull, stored[:, k0:k1])
        # the visit's operand: the lo column under the mixed mode
        Pk = colfull[:, :wf] if lo is None else payload[:m, :wf]
        return {"Pk": Pk, "k": k, "k0": k0, "g": None}

    def replay(k):
        k0, k1, _wk, wf = bounds(k)
        eng.wait_writes()
        colfull = _h2d_mirror(stored[:, k0:k1], lo, dev)
        if k > perm_step[0]:
            perm[:] = perms[k]
            perm_step[0] = k
        return {"Pk": colfull[:, :wf], "k": k, "k0": k0, "g": None}

    def apply(S_j, rec, j):
        if rec["g"] is None:
            # uploaded once a record, on first use
            rec["g"] = _to_dev(perms[rec["k"]], dev)
        return _lu_visit_orig(S_j, rec["Pk"], rec["g"], rec["k0"], lo)

    def tail_step(k):
        s = ctrl.sched if ctrl is not None else su.sched
        k0, k1 = k * w, min(k * w + w, n)
        frame = st.take(k) if s.is_mine(k) else None
        if frame is not None:
            st.discard(k)
        frame = su.bc.broadcast(frame, s.owner_flat(k), (m, k1 - k0),
                                hi, panel=k)
        eng.write("LU", k, frame, stored[:, k0:k1])

    su.run("shard_getrf_ooc", st, factor_panels=factor_panels,
           tail_panels=tail_panels, payload_shape=payload_shape,
           make_payload=make_payload, complete=complete, replay=replay,
           apply=apply, tail_step=tail_step)
    if su.ck is not None:
        out = _finalize_lapack_order(stored, perm, w,
                                     out=np.empty_like(stored))
        return out, np.array(ipiv)
    return _finalize_lapack_order(stored, perm, w), ipiv

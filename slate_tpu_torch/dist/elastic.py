"""Elastic mesh: throughput-driven panel re-ownership for the sharded
out-of-core stream (counterpart of ``slate_tpu/dist/elastic.py``).

``CyclicSchedule``'s ownership is fixed before the stream starts, so one
slow rank holds back every step: the others finish their updates and
wait for its frames. The pieces here re-own not-yet-factored panels:

* :class:`ElasticSchedule`: a CyclicSchedule with an explicit ``owners``
  table (grid positions). The default table is the cyclic walk, and
  ``remap(boundary, owners)`` never relabels a panel below
  ``boundary``.
* :class:`ThroughputTracker`: a per-position EWMA of step walls less
  their ``bcast_wait`` phase (obs/ledger.py), so waiting on another
  rank's frame never counts as this rank's slowness; with the ledger
  off, the segment wall less the broadcaster's wait.
* :func:`agree_speeds`: one ``all_reduce`` SUM of a per-position
  vector, each position carrying its own rank's wall (exact: one
  contributor a position), so every rank derives the same speeds and
  the same plan.
* :func:`plan_remap`: the deterministic planner (threshold gate,
  speed-proportional quotas, keep-current-owner and lowest-position
  ties).
* :class:`ElasticController` + :func:`run_elastic`: the segmented loop
  behind ``shard_ooc._run_stream``: ``mesh/remap_every`` panels a
  segment, each a ``sharded_stream`` graph under the current map, and
  at each boundary measure, agree, maybe remap.

A remap changes only who computes: each trailing panel still absorbs
updates 0..k-1 in order through the same kernels on bitwise-equal
operands (fresh frames, or replays from the host mirror), so the
result is bitwise the static one. Uniform speeds never remap.

:func:`shrink_to_fit`: after a :class:`~..resil.guard.WorkerLost`, the
``shard_shrink`` rung and the caller's relaunch of the survivors from
the per-rank checkpoints (every rank mirrors every frame, so any
survivor can replay any committed panel).

The process-wide remap / shrink mirror (:func:`remap_records`) is read
with the obs bus off; the serving daemon's admission ladder attaches it
to its escalations.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import events as obs_events
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from ..resil import guard as _guard
from ..tune.select import resolve as _resolve
from .shard_ooc import CyclicSchedule

#: the installed per-position speed vector (install_speeds), which
#: replaces measurement and agreement
_SPEEDS: Optional[List[float]] = None


def install_speeds(speeds: Optional[Sequence[float]]) -> None:
    """Install a per-position speed vector (None clears): every rank
    planning against the same vector derives the same plan, with no
    measurement."""
    global _SPEEDS
    _SPEEDS = None if speeds is None else [float(s) for s in speeds]


def installed_speeds() -> Optional[List[float]]:
    return None if _SPEEDS is None else list(_SPEEDS)


_remap_lock = threading.Lock()
_REMAP_STATS: Dict[str, Any] = {"remaps": 0, "panels_moved": 0,
                                "shrinks": 0, "last": None}


def remap_records() -> Dict[str, Any]:
    """Copy of the mirror: ``remaps`` / ``panels_moved`` / ``shrinks``
    totals and ``last``, the most recent remap's ``{op, boundary,
    moved}`` (or None)."""
    with _remap_lock:
        out = dict(_REMAP_STATS)
        if out["last"] is not None:
            out["last"] = dict(out["last"])
        return out


def reset_remap_records() -> None:
    with _remap_lock:
        _REMAP_STATS.update(remaps=0, panels_moved=0, shrinks=0,
                            last=None)


class ElasticSchedule(CyclicSchedule):
    """CyclicSchedule over an explicit panel -> position table, which
    both primitive queries read (so ``is_mine``, ``my_panels``,
    ``update_order`` and ``staged_bytes`` follow it). The default table
    is the cyclic walk."""

    def __init__(self, nt: int, grid,
                 owners: Optional[Sequence[int]] = None) -> None:
        super().__init__(nt, grid)
        if owners is None:
            owners = [(k % self.p) * self.q + (k // self.p) % self.q
                      for k in range(self.nt)]
        self.owners: List[int] = [int(o) for o in owners]
        if len(self.owners) != self.nt:
            raise ValueError("owner table has %d entries for %d panels"
                             % (len(self.owners), self.nt))
        for k, o in enumerate(self.owners):
            if not 0 <= o < self.nranks:
                raise ValueError("panel %d owner %d outside the %d-"
                                 "position mesh" % (k, o, self.nranks))

    def owner_flat(self, k: int) -> int:
        return self.owners[k]

    def owner_coords(self, k: int):
        f = self.owners[k]
        return f // self.q, f % self.q

    def remap(self, boundary: int,
              owners: Sequence[int]) -> "ElasticSchedule":
        """A schedule under `owners` that keeps every position below
        `boundary` (factored panels are broadcast and mirrored)."""
        owners = [int(o) for o in owners]
        if owners[:boundary] != self.owners[:boundary]:
            raise ValueError(
                "remap at boundary %d would relabel an already-"
                "factored panel" % boundary)
        return ElasticSchedule(self.nt, self.grid, owners)


class ThroughputTracker:
    """Per-position EWMA of effective step walls (seconds of own work);
    ``walls()`` holds None where no sample landed yet."""

    def __init__(self, nranks: int, alpha: float) -> None:
        self.nranks = int(nranks)
        self.alpha = min(max(float(alpha), 1e-6), 1.0)
        self._ewma: List[Optional[float]] = [None] * self.nranks

    def observe(self, pos: int, wall: float) -> None:
        wall = max(float(wall), 0.0)
        prev = self._ewma[pos]
        self._ewma[pos] = wall if prev is None \
            else self.alpha * wall + (1.0 - self.alpha) * prev

    def walls(self) -> List[Optional[float]]:
        return list(self._ewma)


def agree_speeds(grid, my_wall: float) -> List[float]:
    """The grid-agreed per-position speeds (module doc): each rank puts
    its wall at its own position of a zero vector, one all_reduce sums
    them (exact), speed = 1 / wall normalized to a fastest of 1.0. A
    grid without a process group is this rank alone."""
    nranks = grid.nprocs
    wall = max(float(my_wall), 1e-9)
    if grid.group() is None:
        walls = np.full(nranks, wall)
    else:
        from ..parallel.collectives import all_reduce
        v = torch.zeros(nranks, dtype=torch.float64, device=grid.device)
        v[grid.index] = wall
        walls = np.maximum(all_reduce(grid, v).cpu().numpy(), 1e-9)
    speeds = 1.0 / walls
    return list(speeds / speeds.max())


def plan_remap(owners: Sequence[int], boundary: int,
               speeds: Sequence[float], threshold: float,
               positions: Optional[Sequence[int]] = None
               ) -> Optional[List[int]]:
    """A deterministic re-ownership plan, or None to keep the map.

    Only panels at or past `boundary` move; `positions` restricts the
    candidate owners. Below a max / min speed ratio of `threshold` the
    map stands, unless a remaining panel's owner is not a candidate,
    which forces a plan. Past the gate each candidate gets a quota
    proportional to its speed, and panels, ascending, keep their owner
    while it is under quota, else go to the candidate furthest under
    quota (lowest position on ties)."""
    nt = len(owners)
    rem = list(range(max(int(boundary), 0), nt))
    if positions is None:
        positions = list(range(len(speeds)))
    positions = sorted(set(int(p) for p in positions))
    if not rem or not positions:
        return None
    posset = set(positions)
    sp = {i: max(float(speeds[i]), 1e-12) for i in positions}
    forced = any(owners[k] not in posset for k in rem)
    if not forced and max(sp.values()) / min(sp.values()) < threshold:
        return None
    wsum = sum(sp.values())
    quota = {i: len(rem) * sp[i] / wsum for i in positions}
    assigned = {i: 0 for i in positions}
    new = list(owners)
    moved = 0
    for k in rem:
        cur = owners[k]
        if cur in posset and assigned[cur] + 1 <= quota[cur] + 1e-9:
            assigned[cur] += 1
            continue
        tgt = max(positions, key=lambda i: (quota[i] - assigned[i], -i))
        assigned[tgt] += 1
        if tgt != cur:
            new[k] = tgt
            moved += 1
    return new if moved else None


def _resolve_ownership(ownership, n: int, dtype) -> bool:
    """explicit ``ownership`` > measured ``mesh/ownership`` > FROZEN
    "static" (MethodOwnership). True for the elastic route."""
    from ..core.methods import MethodOwnership, str2method
    m = ownership if ownership is not None else MethodOwnership.Auto
    if isinstance(m, str):
        m = str2method("ownership", m)
    if m is MethodOwnership.Auto:
        m = MethodOwnership.resolve(n, dtype)
    return m is MethodOwnership.Elastic


class ElasticController:
    """One driver call's remap state: the live :class:`ElasticSchedule`,
    the tracker, and the FROZEN knobs ``mesh/remap_every`` (segment
    length), ``mesh/remap_threshold`` (speed-ratio gate) and
    ``mesh/throughput_alpha`` (EWMA weight), agreed across the grid."""

    def __init__(self, op: str, grid, nt: int, *, n: int,
                 dtype=None) -> None:
        self.op = op
        self.grid = grid
        self.sched = ElasticSchedule(nt, grid)
        every = max(int(_resolve("mesh", "remap_every", n=n,
                                 dtype=dtype)), 1)
        threshold = float(_resolve("mesh", "remap_threshold", n=n,
                                   dtype=dtype))
        alpha = float(_resolve("mesh", "throughput_alpha", n=n,
                               dtype=dtype))
        from ..parallel.collectives import agree
        # the two floats travel as millionths
        every, t6, a6 = agree(grid, every, round(threshold * 1e6),
                              round(alpha * 1e6))
        self.every, self.threshold = every, t6 / 1e6
        self.tracker = ThroughputTracker(self.sched.nranks, a6 / 1e6)
        self.remaps = 0
        self.panels_moved = 0
        self._tail_name = "elastic.%s.%d" % (op, id(self))
        if _ledger.enabled():
            _ledger.tail(self._tail_name)   # earlier runs' records
            # must not seed this run's EWMA

    def observe_segment(self, steps: int, seg_wall: float,
                        wait_delta: float, first_step: int = 0) -> None:
        """Fold one segment's effective step wall into this rank's
        position: the ledger's step walls less their ``bcast_wait``
        phase when it is on, else the segment wall less the
        broadcaster's wait, over its steps."""
        samples: List[float] = []
        if _ledger.enabled():
            for rec in _ledger.tail(self._tail_name):
                if rec.op != self.op or rec.step < first_step:
                    continue   # catch-up replay slots are not work
                samples.append(max(
                    rec.wall - rec.phases.get("bcast_wait", 0.0), 0.0))
        if not samples and steps > 0:
            samples = [max(seg_wall - wait_delta, 0.0) / float(steps)]
        if not samples:
            return
        self.tracker.observe(self.grid.index, sum(samples) / len(samples))

    def speeds(self) -> List[float]:
        """The agreed (or installed) per-position speeds."""
        if _SPEEDS is not None:
            if len(_SPEEDS) != self.sched.nranks:
                raise ValueError(
                    "installed speed vector has %d entries for a %d-"
                    "position mesh" % (len(_SPEEDS), self.sched.nranks))
            return list(_SPEEDS)
        walls = [w for w in self.tracker.walls() if w is not None]
        my_wall = sum(walls) / len(walls) if walls else 0.0
        return agree_speeds(self.grid, my_wall)

    def maybe_remap(self, boundary: int) -> int:
        """Plan and apply a re-ownership at `boundary`; the number of
        panels moved (0: the map stands). Published as a
        ``shard::remap`` instant and ``ooc.shard.remaps`` /
        ``ooc.shard.remap_panels_moved``."""
        speeds = self.speeds()
        plan = plan_remap(self.sched.owners, boundary, speeds,
                          self.threshold)
        if plan is None:
            return 0
        moved = sum(1 for a, b in zip(self.sched.owners, plan) if a != b)
        self.sched = self.sched.remap(boundary, plan)
        self.remaps += 1
        self.panels_moved += moved
        with _remap_lock:
            _REMAP_STATS["remaps"] += 1
            _REMAP_STATS["panels_moved"] += moved
            _REMAP_STATS["last"] = {"op": self.op,
                                    "boundary": int(boundary),
                                    "moved": moved}
        if obs_events.enabled():
            obs_events.instant(
                "shard::remap", cat="shard", op=self.op,
                boundary=boundary, moved=moved,
                speeds=[round(s, 4) for s in speeds])
            obs_metrics.inc("ooc.shard.remaps")
            obs_metrics.inc("ooc.shard.remap_panels_moved", moved)
        return moved


def run_elastic(ctrl: ElasticController, *, op: str, bc, st,
                depth: int, epoch: int, factor_panels: Sequence[int],
                tail_panels: Sequence[int], payload_shape: Callable,
                make_payload: Callable, complete: Callable,
                replay: Callable, apply: Callable,
                tail_step: Optional[Callable], led, ck, eng,
                step_obs: Callable, nt: int,
                fused_apply: Optional[Callable] = None,
                fuse_meta: Optional[dict] = None) -> None:
    """The segmented elastic loop (module doc). Each segment is a
    ``sharded_stream`` graph over the panels up to its boundary under
    the current map, ``applied_through`` pruning the updates earlier
    segments applied and ``trailing_to`` carrying the sweep over the
    whole stream. At a boundary the controller measures, agrees and
    maybe remaps; panels moved away leave this rank's working set (their
    new owner stages them and catches up through mirror replays)."""
    from ..sched import policies as _policies
    from ..sched.runtime import execute as _execute
    panels = list(factor_panels)
    last = panels[-1] if panels else -1
    b0 = int(epoch)
    while True:
        b1 = min(b0 + ctrl.every, last + 1)
        final = b1 >= last + 1
        sched = ctrl.sched
        g = _policies.sharded_stream(
            op, sched=sched, bc=bc, st=st, depth=depth, epoch=b0,
            factor_panels=[p for p in panels if p < b1],
            tail_panels=(list(tail_panels) if final else []),
            payload_shape=payload_shape, make_payload=make_payload,
            complete=complete, replay=replay, apply=apply,
            tail=tail_step, applied_through=st.applied_through,
            trailing_to=nt, fused_apply=fused_apply)

        def _begin(k, _b0=b0, _sched=sched):
            if led is not None:
                led.begin(k, owner=_sched.owner_process(k), epoch=_b0)

        def _end(k, _b0=b0, _b1=b1):
            if _b0 <= k < _b1:
                step_obs(k)
            if ck is not None and k >= _b0 and ck.due(k):
                eng.wait_writes()   # every panel <= k is durable;
                ck.commit(k + 1)    # the in-flight panel is not
            if led is not None:
                led.commit(**(fuse_meta.pop(k, {}) if fuse_meta
                              else {}))

        t_seg = time.perf_counter()
        wait0 = bc.wait_seconds
        _execute(g, op=op, nt=nt, begin_step=_begin, end_step=_end)
        if final:
            break
        # trailing panels have absorbed steps < b1; factored panels
        # leave the in-flight bookkeeping
        for j in ctrl.sched.my_panels():
            if j >= b1:
                st.upto[j] = b1
        for p in range(b0, b1):
            st.upto.pop(p, None)
        ctrl.observe_segment(b1 - b0, time.perf_counter() - t_seg,
                             bc.wait_seconds - wait0, first_step=b0)
        if ctrl.maybe_remap(b1):
            for j in sorted(st.staged):
                if j >= b1 and not ctrl.sched.is_mine(j):
                    st.discard(j)
                    st.staged.discard(j)
                    st.upto.pop(j, None)
        b0 = b1
    if ck is not None and ck.epoch < nt:
        eng.wait_writes()
        ck.commit(nt)


def shrink_to_fit(primary: Callable[[], Any],
                  survivors: Callable[[Any], Any], *,
                  op: str = "", **ctx) -> Any:
    """Run `primary` (the whole grid's launch); on
    :class:`~..resil.guard.WorkerLost` record the ``shard_shrink`` rung
    (``ooc.shard.shrinks``, the mirror's ``shrinks``) and return
    `survivors(exc)`: the caller's relaunch of the surviving ranks from
    the same checkpoint root, whose schedule re-owns the lost rank's
    panels by construction."""
    try:
        return primary()
    except _guard.WorkerLost as e:
        _guard.record_escalation(
            "shard_shrink", op=op, lost_process=e.process_id,
            returncode=e.returncode, **ctx)
        with _remap_lock:
            _REMAP_STATS["shrinks"] += 1
        if obs_events.enabled():
            obs_events.instant("shard::shrink", cat="shard", op=op,
                               lost=e.process_id,
                               returncode=e.returncode)
            obs_metrics.inc("ooc.shard.shrinks")
        return survivors(e)

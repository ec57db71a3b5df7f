"""Per-run flight recorder (counterpart of ``slate_tpu/obs/ledger.py``):
a bounded ring of per-step structured records.

The event bus answers "what spans ran" and the metrics registry "how
much, in aggregate"; the ledger answers "which step, on which host, in
which phase, took the wall". Each step of a long-running path (each
coalesced batch dispatch, each panel step of an out-of-core stream,
linalg/ooc.py) appends one :class:`StepRecord` carrying the step
index, the owning host, the resume epoch and a per-phase wall
breakdown over the closed phase set :data:`PHASES`::

    stage       host -> device staging the step waited on
    factor      the factor kernel (the critical path)
    update      trailing-update sweeps
    bcast_wait  blocked completion of a broadcast collective
    cache       cache stalls: writeback fences, checkpoint drains
    other       everything the step did that no phase claims
                (sum(phases) == the step's wall, exactly)

Phase accounting is self-time over a frame stack: :func:`frame` nests
(a child pauses its parent) and :func:`credit` charges a wait measured
elsewhere. obs/xprof.py folds the records into the critical-path
attribution obs/report.py renders; obs/export.py emits each phase as a
Perfetto counter track. Phases are host wall time: a step that queues
device work and returns is charged for the queueing, not the kernels.

The gate rides the FROZEN ``obs/ledger`` tunable, shipped ``"off"``:
a cold cache records nothing. :func:`enable` / :func:`disable`
override it; the tune row is resolved once per process. A recorder
created with ``spill_dir`` also appends every committed record to
``<spill_dir>/ledger.host<i>.jsonl``. The ring is bounded
(:data:`LEDGER_CAP`); evictions are counted. The host is the
``torch.distributed`` rank when a process group is initialized,
else 0.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: the CLOSED set of step phases (a typo'd phase name would be a
#: silently empty attribution column)
PHASES = ("stage", "factor", "update", "bcast_wait", "cache", "other")

#: bounded ring capacity; oldest records drop first (counted)
LEDGER_CAP = 65_536

_lock = threading.Lock()
_records: "collections.deque[StepRecord]" = collections.deque(
    maxlen=LEDGER_CAP)
_dropped = 0
_seq = 0                     # monotonically increasing record id
#: per-consumer tail cursors (tail())
_tail_prev: Dict[str, int] = {}

#: explicit override > memoized tune-row resolution (module doc)
_explicit: Optional[bool] = None
_resolved: Optional[bool] = None
#: count of live recorders — the one-boolean gate frame()/credit()
#: check before touching thread-local state
_active = 0

_tls = threading.local()


@dataclasses.dataclass
class StepRecord:
    """One committed step: identity + the exhaustive phase split."""
    op: str
    step: int
    host: int
    owner: int               # owning host (== host off-mesh)
    epoch: int               # resume epoch the run started from
    t0: float                # perf_counter seconds (bus clock)
    t1: float
    phases: Dict[str, float]
    meta: Dict[str, Any]
    seq: int = 0

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"op": self.op, "step": self.step, "host": self.host,
                "owner": self.owner, "epoch": self.epoch,
                "wall_s": round(self.wall, 6),
                "phases": {k: round(v, 6)
                           for k, v in sorted(self.phases.items())},
                **({"meta": self.meta} if self.meta else {})}


def _host() -> int:
    """This process's host index: the torch.distributed rank when a
    process group is initialized, else 0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def enable() -> None:
    """Turn the recorder on explicitly (wins over the tune row)."""
    global _explicit
    _explicit = True


def disable() -> None:
    global _explicit
    _explicit = False


def enabled() -> bool:
    """The gate: explicit override, else the FROZEN ``obs/ledger``
    tunable resolved once per process ("on" turns the recorder on —
    an earned or explicit decision; the shipped default is "off")."""
    if _explicit is not None:
        return _explicit
    global _resolved
    if _resolved is None:
        try:
            from ..tune.select import resolve
            _resolved = str(resolve("obs", "ledger")) == "on"
        except Exception:
            _resolved = False
    return _resolved


def reset() -> None:
    """Forget records, cursors, AND the memoized tune resolution
    (tests repoint the cache between cases)."""
    global _dropped, _explicit, _resolved, _seq
    with _lock:
        _records.clear()
        _tail_prev.clear()
        _dropped = 0
        _seq = 0
    _explicit = None
    _resolved = None


def _append(rec: StepRecord) -> None:
    global _dropped, _seq
    with _lock:
        _seq += 1
        rec.seq = _seq
        if len(_records) == LEDGER_CAP:
            _dropped += 1            # deque maxlen evicts oldest
        _records.append(rec)


def records(op: Optional[str] = None) -> List[StepRecord]:
    """Snapshot (copy) of the ring, optionally filtered by op."""
    with _lock:
        recs = list(_records)
    if op is not None:
        recs = [r for r in recs if r.op == op]
    return recs


def count() -> int:
    with _lock:
        return len(_records)


def dropped() -> int:
    with _lock:
        return _dropped


def tail(name: str) -> List[StepRecord]:
    """Records committed since the previous ``tail(name)`` call:
    per-consumer incremental reads, the counters_delta shape carried
    to step records (the watchdog's ETA reads it)."""
    with _lock:
        prev = _tail_prev.get(name, 0)
        out = [r for r in _records if r.seq > prev]
        _tail_prev[name] = _seq
    return out


# -- phase accounting ------------------------------------------------------

@contextlib.contextmanager
def frame(phase: str):
    """Charge the enclosed region's SELF time to `phase` on the
    current open record (no-op without one — one integer check when
    the recorder is off). Nested frames pause the parent: a stage
    fetch inside an update frame charges ``stage``, and the update
    frame keeps only its own time, so committed phases always sum to
    the step wall."""
    if not _active:
        yield
        return
    rec = getattr(_tls, "rec", None)
    if rec is None:
        yield
        return
    stack = _tls.stack
    stack.append(0.0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        child = stack.pop()
        rec.phases[phase] = rec.phases.get(phase, 0.0) \
            + max(dur - child, 0.0)
        if stack:
            stack[-1] += dur


def credit(phase: str, seconds: float) -> None:
    """Charge an externally-measured leaf wait (a writeback fence) to
    `phase` on the current open record,
    deducting it from the enclosing frame like a nested frame would.
    No-op without an open record on this thread — worker-thread waits
    never misattribute to whatever step the main thread has open."""
    if not _active:
        return
    rec = getattr(_tls, "rec", None)
    if rec is None:
        return
    rec.phases[phase] = rec.phases.get(phase, 0.0) + seconds
    stack = _tls.stack
    if stack:
        stack[-1] += seconds


class RunRecorder:
    """One driver invocation's recorder: ``begin(step)`` opens a
    record on the calling thread, :func:`frame`/:func:`credit` charge
    phases into it, ``commit()`` closes it (the unclaimed remainder
    lands in ``other``) and appends it to the ring + the spill file.
    ``close()`` in the driver's ``finally`` releases the active
    gate."""

    def __init__(self, op: str, nt: Optional[int] = None,
                 spill_dir: Optional[str] = None) -> None:
        self.op = op
        self.nt = nt
        self.host = _host()
        self._spill = None
        if spill_dir:
            try:
                os.makedirs(spill_dir, exist_ok=True)
                self._spill = open(
                    os.path.join(spill_dir,
                                 "ledger.host%d.jsonl" % self.host),
                    "a")
            except OSError:
                self._spill = None       # post-mortem is best-effort
        self._closed = False

    def begin(self, step: int, owner: Optional[int] = None,
              epoch: int = 0, drain: bool = False) -> "RunRecorder":
        """Open step `step`'s record (commits a still-open one first
        — a driver that raises mid-step still leaves that step's
        partial phases on the ring). ``drain=True`` marks the final
        post-loop record (writeback drain, engine shutdown): its
        step index is NOT a panel, and the critical-path analyzer
        keeps it out of the slowest-panels ranking."""
        if getattr(_tls, "rec", None) is not None:
            self.commit()
        _tls.rec = StepRecord(
            op=self.op, step=int(step), host=self.host,
            owner=self.host if owner is None else int(owner),
            epoch=int(epoch), t0=time.perf_counter(), t1=0.0,
            phases={}, meta={"drain": True} if drain else {})
        _tls.stack = []
        return self

    def commit(self, **meta) -> Optional[StepRecord]:
        """Close and append the open record; the wall not claimed by
        any frame/credit goes to ``other`` so the split is exhaustive."""
        rec = getattr(_tls, "rec", None)
        if rec is None:
            return None
        _tls.rec = None
        _tls.stack = []
        rec.t1 = time.perf_counter()
        claimed = sum(rec.phases.values())
        rest = rec.wall - claimed
        if rest > 0:
            rec.phases["other"] = rec.phases.get("other", 0.0) + rest
        if meta:
            rec.meta.update(meta)
        _append(rec)
        if self._spill is not None:
            try:
                self._spill.write(json.dumps(rec.to_dict(),
                                             sort_keys=True) + "\n")
                self._spill.flush()
            except OSError:
                pass
        return rec

    def close(self) -> None:
        """Commit any open record, close the spill file, release the
        active gate. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.commit()
        if self._spill is not None:
            try:
                self._spill.close()
            except OSError:
                pass
        global _active
        with _lock:
            _active = max(_active - 1, 0)

    def __enter__(self) -> "RunRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def recorder(op: str, nt: Optional[int] = None,
             spill_dir: Optional[str] = None
             ) -> Optional[RunRecorder]:
    """A driver's recorder when the ledger is on, else None — the
    step loops gate every ledger touch on this one reference, so the
    off path costs nothing per step."""
    if not enabled():
        return None
    global _active
    with _lock:
        _active += 1
    return RunRecorder(op, nt=nt, spill_dir=spill_dir)


def append(op: str, step: int, phases: Dict[str, float],
           meta: Optional[Dict[str, Any]] = None) -> None:
    """One-shot record (the batch/queue.py dispatch path: no step loop
    holds a recorder open). Gated like :func:`recorder`."""
    if not enabled():
        return
    t1 = time.perf_counter()
    wall = sum(phases.values())
    rec = StepRecord(op=op, step=int(step), host=_host(),
                     owner=_host(), epoch=0, t0=t1 - wall, t1=t1,
                     phases=dict(phases), meta=dict(meta or {}))
    _append(rec)

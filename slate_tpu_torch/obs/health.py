"""Stall watchdog and progress health (counterpart of
``slate_tpu/obs/health.py``).

A long stream that wedges (a hung transfer, a lost flush) otherwise
presents as silence. The watchdog turns silence into a signal:

* step loops publish :func:`heartbeat` once a step, plus one
  completion beat at ``step == total`` after the loop (one boolean
  check when the watchdog is off). An op with no completed step
  interval yet is never flagged: the first step includes the cold
  start (kernel builds, library handles), which is not a stall;
* a daemon monitor thread (``obs-watchdog``, started by
  :func:`enable` or by the first heartbeat while on) watches every
  op's last beat against a median-step budget,
  ``max(stall_factor * median step interval, min_budget_s)``: a run
  is its own baseline;
* a stall publishes one ``health::stall`` instant (op, last step,
  host), bumps ``health.stalls`` and, with ``escalate=True``, hands
  the stall to the resil escalation funnel (rung ``watchdog_stall``).
  One stall an episode: the next heartbeat clears it;
* each heartbeat updates the ``health.eta_seconds`` gauge (remaining
  steps x the median step). With the ledger on, the step estimate is
  the median over live hosts' own per-host medians.

The gate is the FROZEN ``obs/watchdog`` tunable, shipped ``"off"``: a
cold cache starts no thread. :func:`disable` stops the monitor and
joins it. The step loops that beat are the out-of-core streams
(linalg/ooc.py) and the task-graph runtime (sched/runtime.py).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional

from . import events as _events
from . import metrics as _metrics

#: a step slower than this multiple of the op's own median step
#: interval is a stall (a run is its own baseline)
STALL_FACTOR = 8.0

#: floor on the stall budget — median math on the first steps of a
#: fast stream must not declare microsecond "stalls"
MIN_BUDGET_S = 1.0

#: monitor poll interval
INTERVAL_S = 0.05

#: per-op step-interval history window (median over the last N)
_HISTORY = 64

_lock = threading.Lock()
_explicit: Optional[bool] = None
_resolved: Optional[bool] = None
_escalate = False
_stall_factor = STALL_FACTOR
_min_budget_s = MIN_BUDGET_S
_interval_s = INTERVAL_S

_monitor: Optional[threading.Thread] = None
#: the CURRENT monitor's private stop event — per-thread, so a
#: disable/enable cycle can never resurrect an old monitor by
#: clearing a shared event it is still polling (an orphaned thread
#: that outlived its join timeout holds a set event and exits on its
#: next wake, whatever newer monitors are doing)
_monitor_stop: Optional[threading.Event] = None

#: local mirrors readable with the obs bus off (the guard.counts
#: shape): stalls + heartbeats observed
_stats: Dict[str, int] = {"heartbeats": 0, "stalls": 0}


class _Track:
    __slots__ = ("step", "total", "last", "durs", "stalled", "host")

    def __init__(self) -> None:
        self.step = -1
        self.total: Optional[int] = None
        self.last = 0.0
        self.durs: "collections.deque[float]" = collections.deque(
            maxlen=_HISTORY)
        self.stalled = False
        self.host = 0


_tracks: Dict[str, _Track] = {}

#: per-(op, host) step-wall history consumed from the ledger tail:
#: medians per HOST, never a global mean (one straggler must move the
#: forecast, not dissolve into it). _eta_last holds each key's newest committed t1 (ledger
#: bus clock) for the stale-host guard.
_eta_durs: Dict[tuple, "collections.deque[float]"] = {}
_eta_last: Dict[tuple, float] = {}

# one host-resolution helper for the whole flight-recorder layer —
# the ledger's records and the stall instants must never disagree on
# which host they attribute to
from .ledger import _host  # noqa: E402


def enable(stall_factor: Optional[float] = None,
           min_budget_s: Optional[float] = None,
           interval_s: Optional[float] = None,
           escalate: bool = False) -> None:
    """Turn the watchdog on explicitly (wins over the tune row) and
    start the monitor. ``escalate=True`` routes every detected stall
    through the resil guard funnel (rung ``watchdog_stall``)."""
    global _explicit, _escalate, _stall_factor, _min_budget_s, \
        _interval_s
    if stall_factor is not None:
        _stall_factor = float(stall_factor)
    if min_budget_s is not None:
        _min_budget_s = float(min_budget_s)
    if interval_s is not None:
        _interval_s = float(interval_s)
    _escalate = bool(escalate)
    _explicit = True
    _ensure_monitor()


def disable() -> None:
    """Stop the monitor and reject heartbeats (explicit off)."""
    global _explicit, _monitor, _monitor_stop
    _explicit = False
    with _lock:
        mon, stop = _monitor, _monitor_stop
        _monitor = None
        _monitor_stop = None
    if stop is not None:
        stop.set()
    # join OUTSIDE the lock — the monitor loop takes it per tick
    if mon is not None and mon.is_alive():
        mon.join(timeout=1.0)


def enabled() -> bool:
    if _explicit is not None:
        return _explicit
    global _resolved
    if _resolved is None:
        try:
            from ..tune.select import resolve
            _resolved = str(resolve("obs", "watchdog")) == "on"
        except Exception:
            _resolved = False
    return _resolved


def thread_alive() -> bool:
    """Whether the monitor thread is running (the off-state contract
    tests assert False on a cold cache)."""
    mon = _monitor
    return mon is not None and mon.is_alive()


def reset() -> None:
    """Stop everything and forget all state (tests)."""
    global _explicit, _resolved, _escalate, _stall_factor, \
        _min_budget_s, _interval_s
    disable()
    with _lock:
        _tracks.clear()
        _eta_durs.clear()
        _eta_last.clear()
        _stats["heartbeats"] = 0
        _stats["stalls"] = 0
    _explicit = None
    _resolved = None
    _escalate = False
    _stall_factor = STALL_FACTOR
    _min_budget_s = MIN_BUDGET_S
    _interval_s = INTERVAL_S


def stats() -> Dict[str, Any]:
    with _lock:
        out: Dict[str, Any] = dict(_stats)
        out["ops"] = {op: {"step": t.step, "total": t.total,
                           "stalled": t.stalled,
                           "median_step_s": _median(t.durs)}
                      for op, t in _tracks.items()}
    return out


def _median(durs) -> float:
    if not durs:
        return 0.0
    s = sorted(durs)
    return s[len(s) // 2]


def _eta_step_s(op: str, own_med: float) -> float:
    """Per-step seconds for the ETA gauge. Ledger on: drain the
    ``health.eta`` tail cursor into per-(op, host) wall histories and
    return the median over LIVE hosts' per-host medians — a host
    whose newest record trails the mesh's newest by more than its own
    stall budget (``max(stall_factor * its median, min_budget_s)``,
    measured on the ledger's bus clock) is stale and excluded, so a
    peer that stopped reporting can never freeze the forecast.
    Ledger off, or no records for `op` yet: `own_med` (the local
    track's own-op median)."""
    from . import ledger as _ledger
    if not _ledger.enabled():
        return own_med
    fresh = _ledger.tail("health.eta")
    with _lock:
        for rec in fresh:
            key = (rec.op, rec.host)
            d = _eta_durs.get(key)
            if d is None:
                d = _eta_durs[key] = collections.deque(
                    maxlen=_HISTORY)
            d.append(rec.wall)
            if rec.t1 > _eta_last.get(key, 0.0):
                _eta_last[key] = rec.t1
        keys = [k for k in _eta_durs if k[0] == op and _eta_durs[k]]
        if not keys:
            return own_med
        newest = max(_eta_last[k] for k in keys)
        meds = []
        for k in keys:
            med = _median(_eta_durs[k])
            budget = max(_stall_factor * med, _min_budget_s)
            if newest - _eta_last[k] <= budget:
                meds.append(med)
    if not meds:
        return own_med
    return _median(meds)


def heartbeat(op: str, step: int, total: Optional[int] = None
              ) -> None:
    """Progress pulse from a step loop: one boolean check when the
    watchdog is off; on, it updates the op's track, refreshes the
    median-step estimate, publishes the ETA gauge, and clears any
    standing stall flag (the episode ended — progress resumed)."""
    if not enabled():
        return
    _ensure_monitor()
    now = time.monotonic()
    remaining = None
    with _lock:
        t = _tracks.get(op)
        if t is None:
            t = _tracks[op] = _Track()
            t.host = _host()
        if t.step >= 0 and step > t.step:
            t.durs.append((now - t.last) / max(step - t.step, 1))
        t.step = int(step)
        if total is not None:
            t.total = int(total)
        t.last = now
        t.stalled = False
        _stats["heartbeats"] += 1
        med = _median(t.durs)
        if t.total is not None:
            # a beat fires at the START of step `step`, so steps
            # step..total-1 all remain — total - step of them (the
            # completion beat at step == total reads 0)
            remaining = max(t.total - t.step, 0)
    if remaining is not None and _events.enabled():
        step_s = _eta_step_s(op, med)
        if step_s > 0:
            _metrics.set_gauge("health.eta_seconds",
                               round(remaining * step_s, 6))


def _ensure_monitor() -> None:
    global _monitor, _monitor_stop
    if _monitor is not None and _monitor.is_alive():
        return
    with _lock:
        if _monitor is not None and _monitor.is_alive():
            return
        stop = threading.Event()
        mon = threading.Thread(target=_monitor_loop, args=(stop,),
                               name="obs-watchdog", daemon=True)
        _monitor = mon
        _monitor_stop = stop
        # start() INSIDE the lock: a not-yet-started thread reads
        # is_alive() False, so a concurrent first heartbeat in the
        # window between assign and start would spawn a SECOND
        # monitor (double-counted stalls, an orphaned thread)
        mon.start()


def _monitor_loop(stop: threading.Event) -> None:
    while not stop.wait(_interval_s):
        if not enabled():
            return            # disable() raced our last wake
        now = time.monotonic()
        fired = []
        with _lock:
            for op, t in _tracks.items():
                if t.stalled or t.step < 0:
                    continue
                if t.total is not None and t.step >= t.total:
                    # the COMPLETION beat (step == total, published
                    # after each step loop): the run is done. The
                    # last REAL step (total-1) stays monitored — its
                    # trailing sweep is the largest of the stream
                    continue
                if not t.durs:
                    # no completed step interval yet: the first
                    # step's wall includes the cold start (kernel
                    # builds); a run is its own baseline only after
                    # one measured step
                    continue
                budget = max(_stall_factor * _median(t.durs),
                             _min_budget_s)
                silent = now - t.last
                if silent > budget:
                    t.stalled = True
                    _stats["stalls"] += 1
                    fired.append((op, t.step, t.host, silent, budget))
        for op, step, host, silent, budget in fired:
            _publish_stall(op, step, host, silent, budget)


def _publish_stall(op: str, step: int, host: int, silent: float,
                   budget: float) -> None:
    """One stall episode: the obs instant + counter (bus on), and the
    guard-funnel handoff when escalation is armed. The local _stats
    mirror was already bumped under the lock, so obs-off callers
    still see the count."""
    if _events.enabled():
        _metrics.inc("health.stalls")
        _events.instant("health::stall", cat="health", op=op,
                        step=step, host=host,
                        stalled_s=round(silent, 4),
                        budget_s=round(budget, 4))
    if _escalate:
        from ..resil import guard as _guard
        _guard.record_escalation("watchdog_stall", op=op, step=step,
                                 host=host)

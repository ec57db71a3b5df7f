"""Process-wide structured event bus (counterpart of
``slate_tpu/obs/events.py``): one store for every observability record
in the process (the trace blocks of utils/trace.py, the tuner's marks,
the driver hooks below, the batch queue, resil), which
obs/export.py writes as one Perfetto timeline and obs/report.py
attributes.

Events carry thread identity and a category (trace, phase, driver,
tune, metric, batch, resil, serve, refine, kernel). Off by default, as
in the reference: every hook is then one boolean check. The store is a
bounded ring (EVENT_CAP); drops are counted, never silent.

The reference's compile-side records (the ``jit`` category, the
recompile detector and the jax.monitoring compile listener) have no
counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: span kinds, Chrome-trace phase letters ("X" complete span,
#: "i" instant, "C" counter sample)
PH_SPAN = "X"
PH_INSTANT = "i"
PH_COUNTER = "C"
#: Perfetto flow-event phase letters: export.py emits these to link a
#: traced request's serve::request span to the batch::flush slice it
#: rode; they are never published onto the bus itself
PH_FLOW_START = "s"
PH_FLOW_END = "f"

#: bounded ring capacity; oldest events drop first (counted)
EVENT_CAP = 100_000

_enabled = False
_lock = threading.Lock()
_events: "collections.deque[Event]" = collections.deque(maxlen=EVENT_CAP)
_dropped = 0


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    ph: str                    # PH_SPAN / PH_INSTANT / PH_COUNTER
    t0: float                  # perf_counter seconds
    t1: float                  # == t0 for instants and counters
    tid: int
    thread: str = ""
    cat: str = ""
    args: Optional[Dict[str, Any]] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def publish(name: str, ph: str = PH_INSTANT, t0: Optional[float] = None,
            t1: Optional[float] = None, cat: str = "",
            args: Optional[Dict[str, Any]] = None) -> None:
    """Append one event (no-op when disabled)."""
    if not _enabled:
        return
    global _dropped
    t = time.perf_counter() if t0 is None else t0
    ev = Event(name=name, ph=ph, t0=t, t1=(t if t1 is None else t1),
               tid=threading.get_ident(),
               thread=threading.current_thread().name, cat=cat, args=args)
    with _lock:
        if len(_events) == EVENT_CAP:
            _dropped += 1               # deque maxlen evicts the oldest
        _events.append(ev)


@contextlib.contextmanager
def span(name: str, cat: str = "", **args):
    """RAII span published on exit."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        publish(name, PH_SPAN, t0, time.perf_counter(), cat=cat,
                args=args or None)


def instant(name: str, cat: str = "", **args) -> None:
    publish(name, PH_INSTANT, cat=cat, args=args or None)


def counter(name: str, value, cat: str = "metric") -> None:
    """One counter sample (Perfetto renders these as tracks)."""
    publish(name, PH_COUNTER, cat=cat, args={"value": value})


@contextlib.contextmanager
def driver(op: str, shape: Optional[Tuple[int, ...]] = None,
           dtype=None, **args):
    """Driver-entry hook: one span (cat 'driver') around a public
    driver's body, the ``driver.<op>.calls`` counter and the
    ``<op>.wall_seconds`` histogram. Host wall time: it ends when the
    driver returns, before queued device work has finished."""
    if not _enabled:
        yield
        return
    from . import metrics
    a = dict(args)
    if shape is not None:
        a["shape"] = "x".join(str(s) for s in shape)
    if dtype is not None:
        a["dtype"] = str(dtype)
    metrics.inc("driver.%s.calls" % op)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        publish(op, PH_SPAN, t0, t1, cat="driver", args=a or None)
        metrics.observe("%s.wall_seconds" % op, t1 - t0)


def instrument_driver(op: str):
    """Decorator form of `driver`: (shape, dtype) come from the first
    TiledMatrix-like argument. Disabled cost: one boolean check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            shape = dtype = None
            for a in args:
                if hasattr(a, "mtype") and hasattr(a, "data"):
                    shape, dtype = tuple(a.data.shape), a.data.dtype
                    break
            with driver(op, shape=shape, dtype=dtype):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def events(cat: Optional[str] = None) -> List[Event]:
    """Snapshot (copy) of the ring, optionally filtered by category."""
    with _lock:
        evs = list(_events)
    return evs if cat is None else [e for e in evs if e.cat == cat]


def count() -> int:
    """Ring occupancy without copying it."""
    with _lock:
        return len(_events)


def dropped() -> int:
    """Lifetime ring evictions (read under the lock, as count())."""
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def drain(cats: Optional[Tuple[str, ...]] = None) -> List[Event]:
    """Atomically snapshot and clear. With `cats`, only events in those
    categories are removed and returned; the drop counter resets only
    on a full drain."""
    global _dropped
    with _lock:
        if cats is None:
            evs = list(_events)
            _events.clear()
            _dropped = 0
            return evs
        evs = [e for e in _events if e.cat in cats]
        kept = [e for e in _events if e.cat not in cats]
        _events.clear()
        _events.extend(kept)
    return evs

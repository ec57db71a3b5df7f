"""Process-wide structured event bus (counterpart of
``slate_tpu/obs/events.py``), reduced to what the dense LU slice calls:
``enable``/``enabled``, ``publish``, ``span``, ``instant`` and the
``driver`` / ``instrument_driver`` hooks.

Off by default, as in the reference: every hook is then one boolean
check. The store is a bounded ring (EVENT_CAP). The reference's
recompile detector has no counterpart, since PyTorch runs eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: span kinds, Chrome-trace phase letters
PH_SPAN = "X"
PH_INSTANT = "i"

#: bounded ring capacity; oldest events drop first
EVENT_CAP = 100_000

_enabled = False
_lock = threading.Lock()
_events: "collections.deque[Event]" = collections.deque(maxlen=EVENT_CAP)


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    ph: str                    # PH_SPAN / PH_INSTANT
    t0: float                  # perf_counter seconds
    t1: float                  # == t0 for instants
    tid: int
    cat: str = ""
    args: Optional[Dict[str, Any]] = None


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
    t = time.perf_counter() if t0 is None else t0
    ev = Event(name=name, ph=ph, t0=t, t1=(t if t1 is None else t1),
               tid=threading.get_ident(), cat=cat, args=args)
    with _lock:
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


@contextlib.contextmanager
def driver(op: str, shape: Optional[Tuple[int, ...]] = None,
           dtype=None, **args):
    """Driver-entry hook: one span (cat 'driver') around a public
    driver's body. Host wall time: it ends when the driver returns,
    before queued device work has finished."""
    if not _enabled:
        yield
        return
    a = dict(args)
    if shape is not None:
        a["shape"] = "x".join(str(s) for s in shape)
    if dtype is not None:
        a["dtype"] = str(dtype)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        publish(op, PH_SPAN, t0, time.perf_counter(), cat="driver",
                args=a or None)


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


def clear() -> None:
    with _lock:
        _events.clear()

"""Process-wide structured event bus (counterpart of
``slate_tpu/obs/events.py``): one store for every observability record
in the process (the trace blocks of utils/trace.py, the tuner's marks,
the driver hooks below, the layer spans of the LU solve and the
refinement, the batch queue, resil), which obs/export.py writes as one
Perfetto timeline and obs/report.py attributes.

Events carry thread identity and a category (trace, phase, driver,
layer, tune, metric, batch, resil, serve, refine, kernel). ``layer``
spans mark the boundaries inside a driver: ``lu::panel``,
``lu::swaps``, ``lu::update``, ``lu::reorder``, ``getrs``,
``refine::precond`` and ``refine::cycle`` (linalg/lu.py,
linalg/refine.py). Off by default, as in the reference: every hook is
then one boolean check. The store is a bounded ring (EVENT_CAP); drops
are counted, never silent.

Spans (``span``, ``driver``, ``span_begin`` / ``span_end``) carry their
identity: an id, the innermost span open on the thread when they began
(``parent``) and the id of the outermost driver span (``call``), which
every span of one driver call shares. While a profiler runs, each span
is also a ``torch.profiler.record_function`` range, so a profiler trace
shows the program's layers on the device trace's clock, tied to the
kernels launched inside them. A span on a CUDA device (given, or its
parent's) is device-timed as well: a pair of timing CUDA events on the
current stream, from a pool that reuses them, with no host
synchronisation. Pairs are resolved (``Event.query()``) when a thread's
outermost span ends, and by ``device_seconds()``, the read function,
which waits for what is still pending; each span name's device seconds
and count are summed in a store outside the ring, so ring eviction
loses none of them. The event itself gets its device time once
resolved (``Event.device``). On the CPU, spans stay host-timed and the
device fields are absent.

Hot paths open spans as ``sp = events.on and events.span_begin(...)``
and close them with ``if sp: events.span_end(sp)``, so that with obs
off a span site costs one check of the module-level flag ``on``: no
generator, no context manager, no profiler range, no event.

The reference's compile-side records (the ``jit`` category, the
recompile detector and the jax.monitoring compile listener) have no
counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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
#: unresolved device-timed spans kept at most; past it the oldest pair
#: is dropped unread (counted in device_dropped())
PENDING_CAP = 1 << 16

#: obs on: the one flag every hook checks
on = False
_lock = threading.Lock()
_events: "collections.deque[Event]" = collections.deque(maxlen=EVENT_CAP)
_dropped = 0

_tls = threading.local()
_ids = itertools.count(1)
#: device timing: pending (name, start, end, DeviceTime) pairs, the
#: per-name [count, seconds] store, idle events by device index
_dev_lock = threading.Lock()
_pending: "collections.deque[tuple]" = collections.deque()
_device: Dict[str, list] = {}
_pools: Dict[int, list] = {}
_dev_dropped = 0


class DeviceTime:
    """The device seconds of one span: None until its CUDA events have
    completed and been read."""
    __slots__ = ("seconds",)

    def __init__(self) -> None:
        self.seconds: Optional[float] = None


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
    #: span identity (0: not a span of span()/driver()/span_begin())
    sid: int = 0
    parent: int = 0
    call: int = 0
    #: a device-timed span's device time (None off the card)
    device: Optional[DeviceTime] = dataclasses.field(default=None,
                                                     compare=False)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def enabled() -> bool:
    return on


def _append(ev: Event) -> None:
    global _dropped
    with _lock:
        if len(_events) == EVENT_CAP:
            _dropped += 1               # deque maxlen evicts the oldest
        _events.append(ev)


def publish(name: str, ph: str = PH_INSTANT, t0: Optional[float] = None,
            t1: Optional[float] = None, cat: str = "",
            args: Optional[Dict[str, Any]] = None) -> None:
    """Append one event (no-op when disabled)."""
    if not on:
        return
    t = time.perf_counter() if t0 is None else t0
    _append(Event(name=name, ph=ph, t0=t, t1=(t if t1 is None else t1),
                  tid=threading.get_ident(),
                  thread=threading.current_thread().name, cat=cat,
                  args=args))


# -- spans -----------------------------------------------------------------

class OpenSpan:
    """A span between span_begin() and span_end()."""
    __slots__ = ("name", "cat", "args", "t0", "t1", "sid", "parent",
                 "call", "dev", "ev0", "rf")


def _stack() -> List[OpenSpan]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _profiling() -> bool:
    flag = getattr(_autograd_profiler, "_is_profiler_enabled", None)
    if flag is None:
        return torch._C._autograd._profiler_enabled()
    return bool(flag)


def _take_event(dev: torch.device) -> "torch.cuda.Event":
    with _dev_lock:
        pool = _pools.get(dev.index)
        if pool:
            return pool.pop()
    return torch.cuda.Event(enable_timing=True)


def _record(dev: torch.device) -> "torch.cuda.Event":
    ev = _take_event(dev)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def span_begin(name: str, cat: str = "", device=None,
               **args) -> OpenSpan:
    """Open a span on this thread (callers check ``on`` first). It is
    device-timed when `device`, or the enclosing span's device, is a
    CUDA device."""
    st = _stack()
    up = st[-1] if st else None
    rec = OpenSpan()
    rec.name, rec.cat, rec.args = name, cat, args or None
    rec.sid = next(_ids)
    rec.parent = up.sid if up is not None else 0
    rec.call = up.call if up is not None and up.call \
        else (rec.sid if cat == "driver" else 0)
    if device is None and up is not None:
        device = up.dev
    if device is not None:
        device = torch.device(device)
    rec.dev = device if device is not None and device.type == "cuda" \
        else None
    rec.rf = None
    if _profiling():
        rec.rf = _autograd_profiler.record_function(name)
        rec.rf.__enter__()
    rec.ev0 = _record(rec.dev) if rec.dev is not None else None
    st.append(rec)
    rec.t0 = time.perf_counter()
    return rec


def span_end(rec: OpenSpan) -> None:
    """Close `rec` (and any span opened inside it that an exception left
    open) and publish it; the thread's outermost span resolves the
    device-timed spans whose events have completed."""
    global _dev_dropped
    rec.t1 = time.perf_counter()
    dev_time = None
    if rec.ev0 is not None:
        dev_time = DeviceTime()
        pair = (rec.name, rec.ev0, _record(rec.dev), dev_time)
        with _dev_lock:
            if len(_pending) >= PENDING_CAP:
                _pending.popleft()
                _dev_dropped += 1
            _pending.append(pair)
    st = _stack()
    if rec in st:
        while st:
            top = st.pop()
            if top is rec:
                break
            if top.rf is not None:
                top.rf.__exit__(None, None, None)
    if rec.rf is not None:
        rec.rf.__exit__(None, None, None)
    if on:
        _append(Event(name=rec.name, ph=PH_SPAN, t0=rec.t0, t1=rec.t1,
                      tid=threading.get_ident(),
                      thread=threading.current_thread().name,
                      cat=rec.cat, args=rec.args, sid=rec.sid,
                      parent=rec.parent, call=rec.call, device=dev_time))
    if not st:
        _resolve(wait=False)


def _resolve(wait: bool) -> None:
    """Read the pending pairs in order into the store; without `wait`,
    stop at the first whose events have not completed."""
    with _dev_lock:
        while _pending:
            name, ev0, ev1, dev_time = _pending[0]
            if wait:
                ev0.synchronize()
                ev1.synchronize()
            elif not (ev1.query() and ev0.query()):
                return
            s = ev0.elapsed_time(ev1) / 1e3
            _pending.popleft()
            dev_time.seconds = s
            tot = _device.get(name)
            if tot is None:
                _device[name] = [1, s]
            else:
                tot[0] += 1
                tot[1] += s
            _pools.setdefault(ev0.device.index, []).extend((ev0, ev1))


def device_seconds() -> Dict[str, Tuple[int, float]]:
    """{span name: (count, device seconds)} of every device-timed span
    since clear(). Call it after synchronizing the device: it resolves
    what is still pending, waiting on the events where it must."""
    _resolve(wait=True)
    with _dev_lock:
        return {k: (int(c), s) for k, (c, s) in sorted(_device.items())}


def device_dropped() -> int:
    """Device-timed spans dropped unread past PENDING_CAP."""
    with _dev_lock:
        return _dev_dropped


class _Span:
    """span()'s context manager while obs is on."""
    __slots__ = ("_name", "_cat", "_args", "_rec")

    def __init__(self, name: str, cat: str, args) -> None:
        self._name, self._cat, self._args = name, cat, args

    def __enter__(self):
        self._rec = span_begin(self._name, self._cat, **self._args)

    def __exit__(self, *exc) -> bool:
        span_end(self._rec)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, cat: str = "", **args):
    """RAII span published on exit (a shared no-op with obs off)."""
    if not on:
        return _NO_SPAN
    return _Span(name, cat, args)


def instant(name: str, cat: str = "", **args) -> None:
    publish(name, PH_INSTANT, cat=cat, args=args or None)


def counter(name: str, value, cat: str = "metric") -> None:
    """One counter sample (Perfetto renders these as tracks)."""
    publish(name, PH_COUNTER, cat=cat, args={"value": value})


@contextlib.contextmanager
def driver(op: str, shape: Optional[Tuple[int, ...]] = None,
           dtype=None, device=None, **args):
    """Driver-entry hook: one span (cat 'driver') around a public
    driver's body, the ``driver.<op>.calls`` counter and the
    ``<op>.wall_seconds`` histogram of its host wall, which ends when
    the driver returns, before queued device work has finished. On a
    CUDA `device` the span is device-timed too (module doc)."""
    if not on:
        yield
        return
    from . import metrics
    a = dict(args)
    if shape is not None:
        a["shape"] = "x".join(str(s) for s in shape)
    if dtype is not None:
        a["dtype"] = str(dtype)
    metrics.inc("driver.%s.calls" % op)
    rec = span_begin(op, "driver", device, **a)
    try:
        yield
    finally:
        span_end(rec)
        metrics.observe("%s.wall_seconds" % op, rec.t1 - rec.t0)


def instrument_driver(op: str):
    """Decorator form of `driver`: (shape, dtype, device) come from the
    first TiledMatrix-like argument. Disabled cost: one boolean
    check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            shape = dtype = device = None
            for a in args:
                if hasattr(a, "mtype") and hasattr(a, "data"):
                    shape, dtype = tuple(a.data.shape), a.data.dtype
                    device = a.data.device
                    break
            with driver(op, shape=shape, dtype=dtype, device=device):
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
    """Empty the ring, the device-time store and its pending spans, and
    this thread's stack of open spans."""
    global _dropped, _dev_dropped
    with _lock:
        _events.clear()
        _dropped = 0
    with _dev_lock:
        while _pending:
            _, ev0, ev1, _ = _pending.popleft()
            _pools.setdefault(ev0.device.index, []).extend((ev0, ev1))
        _device.clear()
        _dev_dropped = 0
    _stack().clear()


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

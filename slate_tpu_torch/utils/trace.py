"""Phase timers (counterpart of ``slate_tpu/utils/trace.py``), reduced
to what the slice calls: ``mark`` (tune decisions), ``Timers`` and
``phases`` (the drivers' named phases). The reference's SVG timeline
is not ported.

Phase times are host wall times. A phase that launches CUDA work ends
when the work is queued, not when the device finishes it; callers
that need device time synchronise or use CUDA events.
"""

from __future__ import annotations

import contextlib
import time

from ..obs import events as _bus


def mark(name: str) -> None:
    """Zero-length event on the bus (tune/stats.py logs every tuned
    decision through this)."""
    _bus.publish(name, _bus.PH_INSTANT, cat="tune")


class Timers:
    """Named-phase timer map (reference opts timers, heev.cc:108)."""

    def __init__(self) -> None:
        self.values = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.values[name] = self.values.get(name, 0.0) + t1 - t0
            _bus.publish(name, _bus.PH_SPAN, t0, t1, cat="phase")

    def __getitem__(self, k: str) -> float:
        return self.values[k]


def phases(opts):
    """Driver hook: `Timers.phase` when the caller passed an
    Option.Timers instance, else a bus span (a no-op with the bus
    off)."""
    from ..core.options import Option, get_option
    tm = get_option(opts, Option.Timers, None)
    if tm is not None:
        return tm.phase

    def bus_phase(name):
        return _bus.span(name, cat="phase")
    return bus_phase

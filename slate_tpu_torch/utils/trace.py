"""Tracing and phase timers (counterpart of
``slate_tpu/utils/trace.py``): a thin view over the event bus
(``obs/events.py``). ``on`` / ``off`` toggle the bus, ``block`` and
``mark`` publish spans and instants to it, ``Timers`` and ``phases``
time the drivers' named phases, and ``finish`` renders the SVG
timeline from the bus's merged stream (every thread's events) and
clears only this module's categories.

Phase times are host wall times. A phase that launches CUDA work ends
when the work is queued, not when the device finishes it; callers
that need device time synchronise or use CUDA events.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional
from xml.sax.saxutils import escape

from ..obs import events as _bus


def on() -> None:
    """Reference trace::Trace::on(): enables the shared bus."""
    _bus.enable()


def off() -> None:
    """Disables the SHARED bus (one process-wide flag): an obs session
    enabled elsewhere stops collecting too. Inside such a session,
    call finish() alone: it renders and clears only this module's
    categories and leaves collection running."""
    _bus.disable()


def block(name: str):
    """RAII-style trace event (reference trace::Block), published to
    the bus under cat 'trace'."""
    return _bus.span(name, cat="trace")


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


#: the bus categories this module owns; finish() drains only these, so
#: a concurrent obs session's driver / metric records survive it
_TRACE_CATS = ("trace", "phase", "tune")


def finish(path: Optional[str] = None) -> Optional[str]:
    """Emit the SVG timeline (reference Trace::finish, Trace.cc:359-594)
    from the bus's merged stream and clear those events (only
    _TRACE_CATS). Returns the SVG text (also written to `path`), or
    None when there is nothing to draw. Event names are XML-escaped:
    tuner marks contain <>&."""
    evs = _bus.drain(cats=_TRACE_CATS)
    if not evs:
        return None
    t_min = min(e.t0 for e in evs)
    t_max = max(e.t1 for e in evs)
    span = max(t_max - t_min, 1e-9)
    width, row_h, pad = 1000.0, 22.0, 4.0
    names = sorted({e.name for e in evs})
    colors = ["#4e79a7", "#f28e2b", "#59a14f", "#e15759", "#76b7b2",
              "#edc948", "#b07aa1", "#9c755f"]
    color = {n: colors[i % len(colors)] for i, n in enumerate(names)}
    rows = {n: i for i, n in enumerate(names)}
    h = row_h * len(names) + 2 * pad
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" '
             f'width="{width + 220}" height="{h}">']
    for n in names:
        y = pad + rows[n] * row_h
        parts.append(f'<text x="4" y="{y + row_h * 0.7:.1f}" '
                     f'font-size="12">{escape(n)}</text>')
    for e in evs:
        x = 200 + (e.t0 - t_min) / span * width
        w = max((e.t1 - e.t0) / span * width, 0.5)
        y = pad + rows[e.name] * row_h
        parts.append(f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
                     f'height="{row_h - 4:.1f}" fill="{color[e.name]}">'
                     f'<title>{escape(e.name)}: '
                     f'{(e.t1 - e.t0) * 1e3:.2f} ms</title>'
                     f'</rect>')
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg

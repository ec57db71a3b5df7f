"""Counter / gauge / histogram registry (counterpart of
``slate_tpu/obs/metrics.py``; obs/report.py renders it).

Who publishes here: the driver-entry hook (``driver.<op>.calls`` and
the ``<op>.wall_seconds`` histogram of host wall), the batch queue
(``batch.*``), the refinement loops (``refine.<kind>.calls`` /
``.iters`` / ``.fallback``, and FGMRES's ``refine.fgmres.steps``, the
inner steps a call needed), resil (``resil.*``), the watchdog
(``health.*``) and ``spectral_dc.check_polar`` (``polar.unconverged``).
Device seconds of spans (the driver spans and the ``layer`` spans) are
not here: the bus sums them per span name (``events.device_seconds()``).

All mutation is gated on ``events.enabled()``, the same single flag as
the bus, so the disabled path stays one boolean check. "Concrete" in
``observe_concrete`` / ``flag_concrete`` means one host read of a
device value (``float`` / ``bool`` of a tensor), made only while obs is
on: the reference's deliberate observer effect, which trades the
solve's overlap with the host for the value the registry exists to
capture.

Left out on purpose: ``record_trace`` / ``recompiles`` and
``install_jax_monitoring``, which count XLA traces and compiles; eager
PyTorch has neither.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

from . import events

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_gauges: Dict[str, Any] = {}
#: name -> [count, total, min, max]
_hists: Dict[str, list] = {}


def inc(name: str, value: float = 1) -> None:
    if not events.enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


def set_gauge(name: str, value) -> None:
    if not events.enabled():
        return
    with _lock:
        _gauges[name] = value


def get_gauge(name: str, default=None):
    """Point read of one gauge (no snapshot copy)."""
    with _lock:
        return _gauges.get(name, default)


def observe(name: str, value: float) -> None:
    """Histogram sample (count / total / min / max)."""
    if not events.enabled():
        return
    v = float(value)
    with _lock:
        h = _hists.get(name)
        if h is None:
            _hists[name] = [1, v, v, v]
        else:
            h[0] += 1
            h[1] += v
            h[2] = min(h[2], v)
            h[3] = max(h[3], v)


def observe_concrete(name: str, value) -> bool:
    """observe() of a value that may live on the device: one host read,
    made only with obs on. Returns whether the sample landed."""
    if not events.enabled():
        return False
    try:
        v = float(value)
    except Exception:
        return False
    observe(name, v)
    return True


def flag_concrete(name: str, flag_value) -> bool:
    """Count how often a boolean runtime flag is SET (a refine fallback
    taken, a polar iteration unconverged); one host read with obs on.
    Returns whether the flag was read."""
    if not events.enabled():
        return False
    try:
        f = bool(flag_value)
    except Exception:
        return False
    if f:
        inc(name)
    return True


def snapshot() -> Dict[str, Any]:
    """Point-in-time copy of every registry."""
    with _lock:
        return {
            "counters": dict(sorted(_counters.items())),
            "gauges": dict(sorted(_gauges.items())),
            "histograms": {
                k: {"count": int(h[0]), "total": h[1],
                    "min": h[2], "max": h[3],
                    "mean": h[1] / h[0] if h[0] else 0.0}
                for k, h in sorted(_hists.items())},
        }


#: named counter baselines for incremental snapshots (counters_delta)
_delta_prev: Dict[str, Dict[str, float]] = {}


def counters_delta(name: str = "default") -> Dict[str, float]:
    """Counters CHANGED since the previous call with this `name`, as
    deltas. Each name keeps its own baseline, so independent consumers
    never steal each other's deltas; successive deltas for one name
    sum exactly to the counter values."""
    with _lock:
        cur = dict(_counters)
        prev = _delta_prev.get(name, {})
        delta = {k: v - prev.get(k, 0.0) for k, v in cur.items()
                 if v != prev.get(k, 0.0)}
        _delta_prev[name] = cur
    return delta


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _delta_prev.clear()

"""SLO time-series telemetry (counterpart of
``slate_tpu/obs/series.py``).

Bounded ring time-series with streaming quantile sketches, fed per
tenant and per op from obs/reqtrace.py span closure:

  * every series is a ``(name, tenant, op)`` key holding a bounded ring
    of ``(t, value)`` samples plus a :class:`QuantileSketch`: a
    fixed-bin log histogram (geometric bins, ratio :data:`GAMMA`)
    whose p50/p95/p99 estimates land within one bin of
    ``np.percentile`` on the raw sample;
  * per-tenant SLO burn: :func:`note_slo` records each request's
    latency against the tuned ``serve/slo_ms`` objective in a rolling
    window, and :func:`slo_burn` exposes the violating fraction;
  * :func:`render_prometheus` is the text exposition (Prometheus
    summary syntax, quantile labels).

The gate is the FROZEN ``("serve", "metrics") = "off"`` row (or
:func:`enable`): off, every publisher is one boolean check.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: log-histogram geometry: bin i covers [V0*GAMMA^i, V0*GAMMA^(i+1)).
#: 512 bins at 5% ratio span 1 microsecond .. ~7e4 seconds, at a
#: resolution finer than any SLO anyone writes.
V0 = 1e-6
GAMMA = 1.05
NBINS = 512

#: per-series sample ring capacity
RING_CAP = 1024

#: SLO burn window: the last N closed requests per tenant
SLO_WINDOW = 256

_lock = threading.Lock()
_series: Dict[Tuple[str, str, str], "Series"] = {}
_slo: Dict[str, "collections.deque"] = {}

_explicit: Optional[bool] = None
_resolved: Optional[bool] = None
_slo_target: Optional[float] = None

_LOG_GAMMA = math.log(GAMMA)


# -- the gate -------------------------------------------------------------

def enable() -> None:
    global _explicit
    _explicit = True


def disable() -> None:
    global _explicit
    _explicit = False


def enabled() -> bool:
    """Explicit override > memoized FROZEN ``serve/metrics`` row."""
    if _explicit is not None:
        return _explicit
    global _resolved
    if _resolved is None:
        try:
            from ..tune.select import resolve
            _resolved = str(resolve("serve", "metrics")) == "on"
        except Exception:
            _resolved = False
    return _resolved


def reset() -> None:
    global _explicit, _resolved, _slo_target
    with _lock:
        _series.clear()
        _slo.clear()
    _explicit = None
    _resolved = None
    _slo_target = None


# -- the sketch -----------------------------------------------------------

def bin_index(v: float) -> int:
    """The log-histogram bin holding `v` (clamped to the range)."""
    if v <= V0:
        return 0
    return min(int(math.log(v / V0) / _LOG_GAMMA), NBINS - 1)


class QuantileSketch:
    """Streaming quantiles over a fixed-bin log histogram: O(1)
    insert, O(bins) query, and a pinned accuracy contract — the
    estimate's bin is within one bin of ``np.percentile``'s on the
    same sample (a <=~10% relative envelope at GAMMA=1.05)."""

    __slots__ = ("bins", "count", "sum", "min", "max")

    def __init__(self) -> None:
        self.bins = np.zeros(NBINS, dtype=np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, v: float) -> None:
        v = float(v)
        self.bins[bin_index(v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> Optional[float]:
        """Geometric midpoint of the bin holding the q-quantile rank,
        or None on an empty sketch."""
        if not self.count:
            return None
        rank = min(max(int(math.ceil(q * self.count)), 1), self.count)
        cum = np.cumsum(self.bins)
        i = int(np.searchsorted(cum, rank))
        return V0 * GAMMA ** (i + 0.5)


class Series:
    """One (name, tenant, op) time-series: sample ring + sketch.
    Mutated only under the module lock (sample())."""

    __slots__ = ("name", "tenant", "op", "ring", "sketch")

    def __init__(self, name: str, tenant: str, op: str) -> None:
        self.name = name
        self.tenant = tenant
        self.op = op
        self.ring: "collections.deque" = \
            collections.deque(maxlen=RING_CAP)
        self.sketch = QuantileSketch()


# -- publishers -----------------------------------------------------------

def sample(name: str, value: float, tenant: str = "",
           op: str = "") -> None:
    """The series publisher (a literal name at every call site)."""
    if not enabled():
        return
    key = (name, str(tenant), str(op))
    with _lock:
        s = _series.get(key)
        if s is None:
            s = _series[key] = Series(*key)
        s.ring.append((time.perf_counter(), float(value)))
        s.sketch.add(value)


def slo_target_s() -> float:
    """The latency objective in seconds (tuned ``serve/slo_ms``)."""
    global _slo_target
    if _slo_target is None:
        try:
            from ..tune.select import tuned_int
            _slo_target = tuned_int("serve", "slo_ms", 500) / 1e3
        except Exception:
            _slo_target = 0.5
    return _slo_target


def note_slo(tenant: str, latency_s: float) -> None:
    """Record one closed request against the tenant's latency
    objective (rolling SLO_WINDOW of violation flags)."""
    if not enabled():
        return
    bad = 1 if latency_s > slo_target_s() else 0
    with _lock:
        d = _slo.get(tenant)
        if d is None:
            d = _slo[tenant] = collections.deque(maxlen=SLO_WINDOW)
        d.append(bad)


def slo_burn(tenant: str) -> Optional[Dict[str, Any]]:
    """The tenant's current burn — the fraction of its rolling window
    violating the objective — or None (metrics off / no traffic).
    The dict names the objective so an admission decision made on it
    can record exactly what was violated."""
    if not enabled():
        return None
    with _lock:
        d = _slo.get(tenant)
        if not d:
            return None
        burn = sum(d) / len(d)
        window = len(d)
    target = slo_target_s()
    return {"objective": "latency_ms<=%d" % round(target * 1e3),
            "target_ms": round(target * 1e3, 3),
            "burn": round(burn, 4), "window": window}


# -- readers --------------------------------------------------------------

def get(name: str, tenant: str = "", op: str = ""
        ) -> Optional[Series]:
    with _lock:
        return _series.get((name, str(tenant), str(op)))


def quantiles(name: str, tenant: str = "", op: str = "",
              qs: Tuple[float, ...] = (0.5, 0.95, 0.99)
              ) -> Optional[Dict[str, float]]:
    """{"p50": ..., "p95": ..., "p99": ...} for one series, or None."""
    s = get(name, tenant, op)
    if s is None or not s.sketch.count:
        return None
    return {"p%g" % (q * 100): s.sketch.quantile(q) for q in qs}


def summary(name: str, tenant: str = "", op: str = ""
            ) -> Optional[Dict[str, Any]]:
    s = get(name, tenant, op)
    if s is None or not s.sketch.count:
        return None
    sk = s.sketch
    out: Dict[str, Any] = {"count": sk.count, "sum": sk.sum,
                           "mean": sk.sum / sk.count,
                           "min": sk.min, "max": sk.max}
    out.update(quantiles(name, tenant, op) or {})
    return out


def snapshot() -> Dict[str, Any]:
    """Every series' summary plus every tenant's SLO burn (keys are
    "name|tenant|op" strings — JSON/stats-friendly)."""
    with _lock:
        keys = list(_series)
        tenants = list(_slo)
    return {"series": {"|".join(k): summary(*k) for k in keys},
            "slo": {t: slo_burn(t) for t in tenants}}


def render_prometheus() -> str:
    """Prometheus text exposition (summary syntax): one metric per
    series name, tenant/op as labels, quantile sub-samples plus
    _count/_sum; per-tenant SLO burn as a gauge. Empty string when
    metrics are off."""
    if not enabled():
        return ""
    with _lock:
        entries = [(k, _series[k]) for k in sorted(_series)]
        tenants = sorted(_slo)
    lines: List[str] = []
    seen = set()
    for (name, tenant, op), s in entries:
        metric = "slate_" + name.replace(".", "_").replace("::", "_")
        if metric not in seen:
            seen.add(metric)
            lines.append("# TYPE %s summary" % metric)
        labels = 'tenant="%s",op="%s"' % (tenant, op)
        for q in (0.5, 0.95, 0.99):
            v = s.sketch.quantile(q)
            if v is not None:
                lines.append('%s{%s,quantile="%g"} %.9g'
                             % (metric, labels, q, v))
        lines.append("%s_count{%s} %d" % (metric, labels,
                                          s.sketch.count))
        lines.append("%s_sum{%s} %.9g" % (metric, labels,
                                          s.sketch.sum))
    if tenants:
        lines.append("# TYPE slate_serve_slo_burn gauge")
        for t in tenants:
            b = slo_burn(t)
            if b is not None:
                lines.append('slate_serve_slo_burn{tenant="%s",'
                             'objective="%s"} %.4f'
                             % (t, b["objective"], b["burn"]))
    return "\n".join(lines) + ("\n" if lines else "")

"""Structured counters for the tuning layer (counterpart of
``slate_tpu/tune/stats.py``): how many decisions were explicit /
cached / frozen, how often the persistent cache hit, and how much wall
time probing cost (tune/probe.py)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

_lock = threading.Lock()

#: decision counts keyed by (op, param, source); source is one of
#: "explicit" (user option), "cached" (measured entry), "frozen"
#: (shipped default)
_decisions: Dict[Tuple[str, str, str], int] = {}

#: persistent-cache accesses
_cache_hits = 0
_cache_misses = 0

#: total probe wall seconds (tune/probe.py)
_probe_seconds = 0.0


def record_decision(op: str, param: str, source: str, value) -> None:
    """One tuned decision taken; also marked on the event bus when it
    is on."""
    with _lock:
        k = (op, param, source)
        _decisions[k] = _decisions.get(k, 0) + 1
    from ..utils import trace
    trace.mark("tune::%s.%s=%r [%s]" % (op, param, value, source))


def record_cache(hit: bool) -> None:
    global _cache_hits, _cache_misses
    with _lock:
        if hit:
            _cache_hits += 1
        else:
            _cache_misses += 1


def add_probe_time(seconds: float) -> None:
    global _probe_seconds
    with _lock:
        _probe_seconds += seconds


def snapshot() -> Dict[str, Any]:
    """Point-in-time copy of every counter."""
    with _lock:
        by_source: Dict[str, int] = {}
        for (op, param, source), c in _decisions.items():
            by_source[source] = by_source.get(source, 0) + c
        return {
            "decisions": {"%s.%s[%s]" % k: c
                          for k, c in sorted(_decisions.items())},
            "decisions_by_source": by_source,
            "decisions_total": sum(_decisions.values()),
            "cache_hits": _cache_hits,
            "cache_misses": _cache_misses,
            "probe_seconds": round(_probe_seconds, 3),
        }


def reset() -> None:
    global _cache_hits, _cache_misses, _probe_seconds
    with _lock:
        _decisions.clear()
        _cache_hits = 0
        _cache_misses = 0
        _probe_seconds = 0.0

"""Per-call cost attribution (counterpart of ``slate_tpu/obs/xprof.py``)
and the flight recorder's critical-path analysis.

The reference reads a compiled XLA program's cost model, memory
analysis and HLO text. Eager PyTorch has no compiled program, so
:func:`analyze` runs the call and measures what it can:

  * the FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` counts:
    the aten products (matmul, addmm, bmm, convolutions) only. The
    hand kernels (ctypes launches), cuSOLVER's factorizations and the
    triangular solves are not counted, so the figure is a lower bound
    of the call's work;
  * peak device memory over a second run (``reset_peak_memory_stats``
    then ``max_memory_allocated``; None on the CPU);
  * that second run's wall time, after a synchronize on either side.

:func:`collective_counts` keeps the reference's keys. Given a
program's text it parses it, as the reference does its HLO; without,
it reads the collectives this process has issued on a grid
(``parallel.collectives.counts``: each call counted under the
reference's HLO kind), and :func:`analyze` records the ones of the
timed run. Left out on purpose: the compile wall, which has no eager
counterpart.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from . import events, metrics

#: collective kinds, in reporting order (the reference's HLO names)
COLLECTIVE_KINDS = ("collective-permute", "all-reduce", "all-gather",
                    "reduce-scatter", "all-to-all")

_COLL_RE = re.compile(
    r"\b(%s)(?:-start)?\(" % "|".join(COLLECTIVE_KINDS))

_lock = threading.Lock()
_analyses: Dict[str, Dict[str, Any]] = {}


def collective_counts(text: str = "") -> Dict[str, int]:
    """Collectives by kind (every kind present, 0 when absent, plus
    "total"): counted in a program's `text`, or without one the
    collectives this process has issued on a grid since the last
    ``parallel.collectives.reset_counts``."""
    if text:
        counts = {k: 0 for k in COLLECTIVE_KINDS}
        for m in _COLL_RE.finditer(text):
            counts[m.group(1)] += 1
    else:
        from ..parallel.collectives import counts as issued
        counts = issued()
    return _with_total(counts)


def _with_total(counts: Dict[str, int]) -> Dict[str, int]:
    counts["total"] = sum(counts[k] for k in COLLECTIVE_KINDS)
    return counts


def _device_of(args, kwargs) -> Optional[torch.device]:
    """The CUDA device of the first tensor (or TiledMatrix-like
    ``.data``) among the arguments, else None."""
    for a in list(args) + list(kwargs.values()):
        t = a if isinstance(a, torch.Tensor) else getattr(a, "data", None)
        if isinstance(t, torch.Tensor):
            return t.device if t.device.type == "cuda" else None
    return None


def _sync(dev: Optional[torch.device]) -> None:
    if dev is not None:
        torch.cuda.synchronize(dev)


def analyze(label: str, fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Attribution record for one call of `fn(*args, **kwargs)`: a first
    run under the FLOP counter (also the warm-up), then a second run
    timed on the host clock, with the device's peak memory (module doc).
    The record lands in the analyses registry (obs.report merges it)
    and, with obs on, as gauges and an instant on the bus."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = _device_of(args, kwargs)
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    _sync(dev)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    from ..parallel.collectives import counts, counts_delta
    issued = counts()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync(dev)
    rec: Dict[str, Any] = {
        "label": label,
        "flops": float(fc.get_total_flops()),
        "execute_seconds": round(time.perf_counter() - t0, 6),
        "peak_bytes": None if dev is None
        else int(torch.cuda.max_memory_allocated(dev)),
        "temp_bytes": None if dev is None
        else int(torch.cuda.max_memory_allocated(dev)) - int(base),
        "collectives": _with_total(counts_delta(issued)),
    }
    with _lock:
        _analyses[label] = rec
    if events.enabled():
        events.instant("xprof:%s" % label, cat="xprof",
                       flops=rec["flops"], peak_bytes=rec["peak_bytes"])
        metrics.set_gauge("xprof.%s.flops" % label, rec["flops"])
        metrics.set_gauge("xprof.%s.peak_bytes" % label,
                          rec["peak_bytes"])
    return rec


#: ledger phase -> critical-path bucket
PHASE_BUCKETS = {
    "factor": "kernel",
    "update": "kernel",
    "bcast_wait": "collective_wait",
    "stage": "staging",
    "cache": "cache_stall",
    "other": "idle",
}


def attribute_run(records=None) -> Dict[str, Any]:
    """The critical-path analyzer: fold flight-recorder step records
    (obs/ledger.py) into per-run attribution: total wall per phase and
    per bucket (kernel / collective-wait / cache-stall / staging /
    idle), split per host and per op, and the slowest steps."""
    from . import ledger as _ledger
    if records is None:
        records = _ledger.records()
    phases: Dict[str, float] = {}
    by_host: Dict[int, Dict[str, Any]] = {}
    by_op: Dict[str, Dict[str, Any]] = {}
    total = 0.0
    panels = []
    for r in records:
        total += r.wall
        for ph, s in r.phases.items():
            phases[ph] = phases.get(ph, 0.0) + s
        for key, agg2 in ((r.host, by_host), (r.op, by_op)):
            d = agg2.setdefault(key, {"wall_s": 0.0, "phases": {}})
            d["wall_s"] += r.wall
            for ph, s in r.phases.items():
                d["phases"][ph] = d["phases"].get(ph, 0.0) + s
        if r.step >= 0 and not r.meta.get("drain"):
            panels.append(r)      # drain records are not steps
    panels.sort(key=lambda r: -r.wall)
    buckets: Dict[str, float] = {}
    for ph, s in phases.items():
        b = PHASE_BUCKETS.get(ph, "idle")
        buckets[b] = buckets.get(b, 0.0) + s

    def _round(d):
        return {k: round(v, 6) for k, v in sorted(d.items())}

    return {
        "records": len(records),
        "dropped": _ledger.dropped(),
        "total_wall_s": round(total, 6),
        "phases": _round(phases),
        "buckets": _round(buckets),
        "by_host": {h: {"wall_s": round(d["wall_s"], 6),
                        "phases": _round(d["phases"])}
                    for h, d in sorted(by_host.items())},
        "by_op": {op: {"wall_s": round(d["wall_s"], 6),
                       "phases": _round(d["phases"])}
                  for op, d in sorted(by_op.items())},
        "top_panels": [
            {"op": r.op, "step": r.step, "host": r.host,
             "owner": r.owner, "wall_s": round(r.wall, 6),
             "phases": _round(r.phases)}
            for r in panels[:8]],
    }


def analyses() -> Dict[str, Dict[str, Any]]:
    with _lock:
        return {k: dict(v) for k, v in _analyses.items()}


def clear_analyses() -> None:
    with _lock:
        _analyses.clear()

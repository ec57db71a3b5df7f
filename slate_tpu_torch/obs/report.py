"""Merged observability snapshot and the human-readable per-run report
(counterpart of ``slate_tpu/obs/report.py``).

snapshot() is the machine surface: the metrics registries, the xprof
analyses, per-driver span aggregates from the bus, the tuner's decision
counters, and (when they hold anything) the flight recorder's
critical-path attribution, the watchdog's stats and the serving
series, as one JSON-serializable dict.

report() is the human surface: per driver, invocation counts and host
wall, and for each xprof analysis its counted FLOPs, peak memory and
execute wall.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Optional

from . import events, health, ledger, metrics, series, xprof


def _driver_aggregate(evs) -> Dict[str, Dict[str, Any]]:
    """Fold the bus's driver spans into per-op totals: `calls` and
    host wall seconds."""
    agg: Dict[str, Dict[str, Any]] = {}
    for e in evs:
        if e.ph != events.PH_SPAN or e.cat != "driver":
            continue
        d = agg.setdefault(e.name, {"calls": 0, "wall_seconds": 0.0})
        d["calls"] += 1
        d["wall_seconds"] += e.dur
    for d in agg.values():
        d["wall_seconds"] = round(d["wall_seconds"], 6)
    return dict(sorted(agg.items()))


def snapshot() -> Dict[str, Any]:
    """One JSON-serializable dict of everything observed so far."""
    try:
        from ..tune import stats as tune_stats
        tune_snap = tune_stats.snapshot()
    except Exception:
        tune_snap = {}
    evs = events.events()          # ONE ring copy serves everything
    snap = {
        "enabled": events.enabled(),
        "events": len(evs),
        "events_dropped": events.dropped(),
        "metrics": metrics.snapshot(),
        "drivers": _driver_aggregate(evs),
        "analyses": xprof.analyses(),
        "tune": tune_snap,
    }
    # flight recorder + watchdog: the critical-path attribution of
    # every ledger step record, and the stall stats; both absent when
    # the FROZEN off-state kept them silent
    if ledger.count():
        snap["ledger"] = xprof.attribute_run()
    hs = health.stats()
    if hs["heartbeats"] or hs["stalls"]:
        snap["health"] = hs
    # serving SLO time-series: quantile summaries and per-tenant burn,
    # present only when serve/metrics is on and a sample landed
    if series.enabled():
        ss = series.snapshot()
        if ss["series"] or ss["slo"]:
            snap["serve_series"] = ss
    return snap


def _fmt_bytes(b) -> str:
    if b is None:
        return "-"
    b = float(b)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if b < 1024 or unit == "GiB":
            return "%.1f %s" % (b, unit)
        b /= 1024
    return "%.1f GiB" % b


def _fmt_flops(f) -> str:
    if not f:
        return "-"
    f = float(f)
    for unit in ("", "K", "M", "G", "T"):
        if f < 1000 or unit == "T":
            return "%.2f %sFLOP" % (f, unit)
        f /= 1000
    return "%.2f TFLOP" % f


def report(path: Optional[str] = None) -> str:
    """Render the per-run report; also written to `path` when given."""
    snap = snapshot()
    out = io.StringIO()
    w = out.write
    w("== slate_tpu_torch observability report ==\n")
    w("events: %d recorded (%d dropped)\n"
      % (snap["events"], snap["events_dropped"]))
    if snap["events_dropped"]:
        # an evicted ring invalidates every span-derived number below
        w("WARNING: %d events were dropped from the bounded ring — "
          "span-derived attribution undercounts; raise "
          "events.EVENT_CAP or drain more often\n"
          % snap["events_dropped"])
    cnt = snap["metrics"]["counters"]
    if cnt:
        w("\n-- counters --\n")
        for k, v in cnt.items():
            w("  %-42s %s\n" % (k, round(v, 6)))
    hists = snap["metrics"]["histograms"]
    if hists:
        w("\n-- timings/samples (count, mean, min..max) --\n")
        for k, h in hists.items():
            w("  %-42s n=%-5d mean=%.4g  [%.4g .. %.4g]\n"
              % (k, h["count"], h["mean"], h["min"], h["max"]))
    drv = snap["drivers"]
    if drv:
        w("\n-- drivers (bus spans, host wall) --\n")
        w("  %-18s %6s %12s\n" % ("op", "calls", "wall(s)"))
        for op, d in drv.items():
            w("  %-18s %6d %12.4f\n"
              % (op, d["calls"], d["wall_seconds"]))
    ana = snap["analyses"]
    if ana:
        w("\n-- per-call attribution (xprof) --\n")
        for label, r in sorted(ana.items()):
            w("  %s:\n" % label)
            w("    flops (products) %s\n" % _fmt_flops(r.get("flops")))
            w("    peak memory    %s\n"
              % _fmt_bytes(r.get("peak_bytes")))
            if "execute_seconds" in r:
                w("    execute        %.6f s\n" % r["execute_seconds"])
            coll = r.get("collectives") or {}
            shown = {k: v for k, v in coll.items()
                     if k != "total" and v}
            w("    collectives    %s\n"
              % (", ".join("%s=%d" % kv for kv in sorted(shown.items()))
                 if shown else "none"))
    led = snap.get("ledger")
    if led and led.get("records"):
        w("\n-- critical path (flight recorder, %d step records"
          % led["records"])
        if led.get("dropped"):
            w("; WARNING %d dropped — attribution undercounts"
              % led["dropped"])
        w(") --\n")
        total = led["total_wall_s"] or 1e-12
        w("  total step wall %.4f s\n" % led["total_wall_s"])
        for b, s in sorted(led["buckets"].items(),
                           key=lambda kv: -kv[1]):
            w("  %-16s %10.4f s  %5.1f%%\n" % (b, s, 100 * s / total))
        for h, d in led.get("by_host", {}).items():
            w("  host %-4s wall %.4f s  %s\n"
              % (h, d["wall_s"],
                 " ".join("%s=%.4f" % kv
                          for kv in sorted(d["phases"].items()))))
        top = led.get("top_panels") or []
        if top:
            w("  slowest panels:\n")
            for p in top[:4]:
                w("    %-18s step %-4d host %d  %.4f s  (%s)\n"
                  % (p["op"], p["step"], p["host"], p["wall_s"],
                     ", ".join("%s=%.4f" % kv
                               for kv in sorted(p["phases"].items()))))
    hs = snap.get("health")
    if hs:
        w("\n-- watchdog --\n")
        w("  heartbeats=%d stalls=%d\n"
          % (hs.get("heartbeats", 0), hs.get("stalls", 0)))
        for op, t in sorted((hs.get("ops") or {}).items()):
            w("  %-20s step=%s/%s median_step=%.4gs%s\n"
              % (op, t["step"], t["total"], t["median_step_s"],
                 "  STALLED" if t["stalled"] else ""))
    sv = snap.get("serve_series")
    if sv:
        w("\n-- serving latency (obs/series sketches) --\n")
        for key, sm in sorted(sv.get("series", {}).items()):
            if not sm:
                continue
            name, tenant, op = (key.split("|") + ["", ""])[:3]
            w("  %-22s %-10s %-8s n=%-5d p50=%.4gs p95=%.4gs "
              "p99=%.4gs\n"
              % (name, tenant or "-", op or "-", sm["count"],
                 sm.get("p50", 0.0), sm.get("p95", 0.0),
                 sm.get("p99", 0.0)))
        slo = {t: b for t, b in (sv.get("slo") or {}).items() if b}
        if slo:
            w("  SLO burn:\n")
            for t, b in sorted(slo.items()):
                w("    %-20s %s burn=%.2f%% (window %d)\n"
                  % (t, b["objective"], 100 * b["burn"],
                     b["window"]))
    tune = snap.get("tune") or {}
    if tune.get("decisions_total"):
        w("\n-- tuned decisions --\n")
        w("  total=%d by_source=%r cache_hits=%d cache_misses=%d\n"
          % (tune.get("decisions_total", 0),
             tune.get("decisions_by_source", {}),
             tune.get("cache_hits", 0), tune.get("cache_misses", 0)))
    text = out.getvalue()
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text

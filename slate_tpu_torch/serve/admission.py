"""Tenant-aware admission control (counterpart of
``slate_tpu/serve/admission.py``).

Every request entering the daemon passes ONE decision point, driven by
the obs layer rather than by guesswork:

  * **queue composition**: per-key pending count, queued true-extent
    flops and oldest-request age from ``CoalescingQueue.stats()``'s
    ``pending_by_key`` breakdown, plus the flops-weighted mean
    occupancy;
  * **dispatch history**: strategy / ceiling and padding-waste flops
    from the flight recorder's ``batch.dispatch`` ledger records
    (obs/ledger.py, when the recorder is on);
  * **load forecast**: the stall watchdog's ``health.eta_seconds``
    gauge (obs/health.py heartbeats).

The decision ladder (strictest first):

  ``reject``   the tenant's pending-request quota is full: a hard
               per-tenant bound, every priority class;
  ``shed``     the watchdog forecasts more than ``serve/shed_eta_s``
               seconds of backlog (or the tenant burns its SLO past
               ``serve/slo_burn_pct``) and the tenant rides the lowest
               priority class;
  ``degrade``  the oldest pending request is older than
               ``serve/max_queue_age_ms`` (or the SLO burns) and the
               request is a degradable f64: serve it in f32
               (``.to(torch.float32)``, half the bytes) instead of
               shedding it;
  ``admit``    everything else.

Every non-admit decision funnels through the resil guard
(:func:`~slate_tpu_torch.resil.guard.record_escalation` rungs
``serve_shed`` / ``serve_degrade`` / ``serve_reject``) with the elastic
mesh's remap-record mirror attached (``dist/elastic.py``; zeros on one
device), is counted as its ``serve.*`` obs counter, and appends a
``serve.admit`` ledger record carrying the pressure inputs it was made
from. Thresholds ride the tune subsystem (explicit argument > measured
entry > FROZEN ``serve/*`` rows). A request's dtype is a torch dtype or
anything numpy reads as one.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..obs import ledger as _ledger
from ..obs import reqtrace as _reqtrace
from ..obs import series as _series
from ..resil import guard as _guard

#: priority classes, lowest first: "batch" work sheds first under
#: load, "interactive" work is never shed or degraded
PRIORITIES = ("batch", "standard", "interactive")

ADMIT = "admit"
SHED = "shed"
DEGRADE = "degrade"
REJECT = "reject"

#: decision -> the serve.* obs counter it bumps (server publishes)
DECISION_COUNTERS = {ADMIT: "serve.admitted", SHED: "serve.shed",
                     DEGRADE: "serve.degraded",
                     REJECT: "serve.rejected"}


class TenantConfig:
    """One tenant's admission contract: quota (pending-request cap,
    None = the tuned ``serve/max_pending`` default), priority class,
    and whether its f64 requests may be served degraded in f32."""

    __slots__ = ("name", "priority", "max_pending", "degradable")

    def __init__(self, name: str, priority: str = "standard",
                 max_pending: Optional[int] = None,
                 degradable: bool = True) -> None:
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}; have "
                             f"{PRIORITIES}")
        self.name = str(name)
        self.priority = priority
        self.max_pending = None if max_pending is None \
            else int(max_pending)
        self.degradable = bool(degradable)


class AdmissionController:
    """The daemon's single admission decision point (module doc).
    Thread-safe; keeps local decision counters readable with the obs
    bus off (the queue.stats() pattern)."""

    def __init__(self, queue, tenants=None, opts=None,
                 max_pending: Optional[int] = None,
                 shed_eta_s: Optional[float] = None,
                 max_queue_age_ms: Optional[float] = None) -> None:
        from ..tune.select import tuned_int
        self._queue = queue
        self.default_max_pending = int(max_pending) \
            if max_pending is not None \
            else tuned_int("serve", "max_pending", 4096, opts=opts)
        self.shed_eta_s = float(shed_eta_s) \
            if shed_eta_s is not None \
            else float(tuned_int("serve", "shed_eta_s", 30,
                                 opts=opts))
        self.max_queue_age_s = (float(max_queue_age_ms)
                                if max_queue_age_ms is not None
                                else float(tuned_int(
                                    "serve", "max_queue_age_ms", 500,
                                    opts=opts))) / 1e3
        #: SLO burn percentage above which the ladder sheds lowest-
        #: priority work / degrades degradable f64 (the series SLO
        #: windows feed admission, not just dashboards)
        self.slo_burn_pct = float(tuned_int(
            "serve", "slo_burn_pct", 50, opts=opts))
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantConfig] = {}
        for t in (tenants or []):
            self._tenants[t.name] = t
        self._counts = {d: 0 for d in DECISION_COUNTERS}
        self._led_seq = 0

    def tenant(self, name: str) -> TenantConfig:
        """The named tenant's config (auto-registered at defaults on
        first sight — an open daemon; pass ``tenants=`` for closed
        quota sets)."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = TenantConfig(name)
            return t

    def quota(self, t: TenantConfig) -> int:
        return t.max_pending if t.max_pending is not None \
            else self.default_max_pending

    # -- pressure inputs --------------------------------------------------

    def pressure(self) -> Dict[str, Any]:
        """One snapshot of every admission input (module doc): queue
        composition from stats()'s per-key breakdown, the watchdog ETA
        gauge, and strategy/ceiling/padding-waste from the most recent
        ledger dispatch records (empty/None when those substrates are
        off — decisions then fall through to the quota bound alone)."""
        s = self._queue.stats()
        pend = s.get("pending_by_key", {})
        p: Dict[str, Any] = {
            "pending": sum(v["count"] for v in pend.values()),
            "pending_keys": len(pend),
            "queued_flops": float(sum(v["queued_flops"]
                                      for v in pend.values())),
            "oldest_age_s": max((v["age_s"] for v in pend.values()),
                                default=0.0),
            "occupancy_weighted": s.get("mean_occupancy_weighted",
                                        0.0),
            "eta_s": None, "recent_waste_flops": None,
            "recent_strategy": None, "recent_ceiling": None,
        }
        from ..obs import events as obs_events
        if obs_events.enabled():
            from ..obs import metrics as om
            p["eta_s"] = om.get_gauge("health.eta_seconds")
        if _ledger.enabled():
            recs = _ledger.records("batch.dispatch")[-16:]
            wastes = [r.meta["waste_flops"] for r in recs
                      if "waste_flops" in r.meta]
            if wastes:
                p["recent_waste_flops"] = round(
                    sum(wastes) / len(wastes), 4)
            if recs:
                p["recent_strategy"] = recs[-1].meta.get("strategy")
                p["recent_ceiling"] = recs[-1].meta.get("ceiling")
        return p

    # -- the decision -----------------------------------------------------

    def decide(self, t: TenantConfig, op: str, dtype,
               inflight: int,
               pressure: Optional[Dict[str, Any]] = None) -> str:
        """Pure decision (module-doc ladder) — no counters, no
        publication; unit-testable on a fabricated pressure dict.
        ``pressure["slo_burn"]`` (obs/series.py :func:`slo_burn`
        shape, attached by :meth:`admit` when metrics are on) adds
        the SLO rungs: a tenant burning past ``serve/slo_burn_pct``
        sheds at the lowest priority and degrades where the age rung
        would — latency debt is pressure even when the queue is
        momentarily calm."""
        if pressure is None:
            pressure = self.pressure()
        return self._decide_why(t, op, dtype, inflight, pressure)[0]

    def _decide_why(self, t: TenantConfig, op: str, dtype,
                    inflight: int, pressure: Dict[str, Any]):
        """(decision, why): the ladder plus WHICH objective drove a
        non-admit — admit() records it in the escalation payload."""
        if inflight >= self.quota(t):
            return REJECT, {"inflight": inflight,
                            "quota": self.quota(t)}
        eta = pressure.get("eta_s")
        if eta is not None and eta > self.shed_eta_s \
                and t.priority == PRIORITIES[0]:
            return SHED, {"eta_s": eta}
        burn = pressure.get("slo_burn")
        burning = burn is not None \
            and burn["burn"] * 100.0 > self.slo_burn_pct
        if burning and t.priority == PRIORITIES[0]:
            return SHED, {"objective": burn["objective"],
                          "burn": burn["burn"]}
        degradable = t.degradable and t.priority != PRIORITIES[-1] \
            and _is_f64(dtype)
        if pressure.get("oldest_age_s", 0.0) > self.max_queue_age_s \
                and degradable:
            return DEGRADE, {"oldest_age_s":
                             round(pressure["oldest_age_s"], 4)}
        if burning and degradable:
            return DEGRADE, {"objective": burn["objective"],
                             "burn": burn["burn"]}
        return ADMIT, {}

    def admit(self, t: TenantConfig, op: str, dtype,
              inflight: int) -> str:
        """decide() plus the bookkeeping contract: count the decision
        (local + ``serve.*`` obs counter), funnel every non-admit
        through the resil escalation ladder, and append the
        ``serve.admit`` ledger record carrying the pressure inputs."""
        t0 = time.perf_counter()
        pressure = self.pressure()
        burn = _series.slo_burn(t.name)
        if burn is not None:
            pressure["slo_burn"] = burn
        decision, why = self._decide_why(t, op, dtype, inflight,
                                         pressure)
        with self._lock:
            self._counts[decision] += 1
            seq = self._led_seq
            self._led_seq += 1
        # every escalation stamps the active trace id (reqtrace's
        # thread-local — None with tracing off, which the funnel's
        # ctx filter drops) and the objective the ladder shed/
        # degraded on (the `why` dict)
        tid = _reqtrace.current_trace_id()
        mesh = None
        if decision != ADMIT:
            # elastic-mesh churn context: a shed/degrade fired while
            # the mesh is re-owning panels or shrinking around a lost
            # host must say so — the escalation payload carries the
            # remap-record mirror (dist/elastic.py, readable with the
            # obs bus off; zeros on one device)
            from ..dist.elastic import remap_records
            mesh = remap_records()
            why = dict(why, mesh_remaps=mesh["remaps"],
                       mesh_panels_moved=mesh["panels_moved"],
                       mesh_shrinks=mesh["shrinks"])
            if mesh["last"] is not None:
                why["mesh_last_remap"] = "%s@%d+%d" % (
                    mesh["last"]["op"], mesh["last"]["boundary"],
                    mesh["last"]["moved"])
        if decision == SHED:
            _guard.record_escalation(
                "serve_shed", tenant=t.name, op=op, trace=tid,
                **why)
        elif decision == DEGRADE:
            _guard.record_escalation(
                "serve_degrade", tenant=t.name, op=op, trace=tid,
                **why)
        elif decision == REJECT:
            _guard.record_escalation(
                "serve_reject", tenant=t.name, op=op, trace=tid,
                **why)
        from ..obs import events as obs_events
        if obs_events.enabled():
            # literal per-decision publishes (not a DECISION_COUNTERS
            # lookup), so each name is greppable where it is published
            from ..obs import metrics as om
            if decision == SHED:
                om.inc("serve.shed")
            elif decision == DEGRADE:
                om.inc("serve.degraded")
            elif decision == REJECT:
                om.inc("serve.rejected")
            else:
                om.inc("serve.admitted")
        if _ledger.enabled():
            meta = {"tenant": t.name, "op": op,
                    "decision": decision, "inflight": inflight}
            meta.update({k: v for k, v in pressure.items()
                         if v is not None})
            if mesh is not None:
                meta["mesh_remap"] = mesh
            _ledger.append("serve.admit", step=seq,
                           phases={"other":
                                   time.perf_counter() - t0},
                           meta=meta)
        return decision

    def counts(self) -> Dict[str, int]:
        """Local decision counters (obs-bus-off mirror)."""
        with self._lock:
            return dict(self._counts)


def _is_f64(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float64
    return np.dtype(dtype) == np.float64

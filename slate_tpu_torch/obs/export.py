"""Chrome-trace / Perfetto JSON export of the merged event stream
(counterpart of ``slate_tpu/obs/export.py``). The object follows the
Trace Event Format that ``chrome://tracing`` and ui.perfetto.dev load:
one ``traceEvents`` array of {ph, ts, name, ...} records, timestamps
in microseconds.

Multihost: each host writes its own trace file, and ``host=``
namespaces it: pid becomes the host id, thread ids move into a
per-host block (host * _HOST_TID_STRIDE + a compact local index), and
the thread / process name metadata carry the host label, so the
per-host ``traceEvents`` arrays concatenate into one timeline. host=None
keeps the single-host layout unless a ``torch.distributed`` process
group of more than one rank is initialized, whose rank is then used.

A device-timed span (obs/events.py) exports its identity (``span``,
``parent``, ``call``) and, once read, its ``device_s`` in ``args``;
every other event exports as the reference's does.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from . import events as _events_mod
from .events import (PH_COUNTER, PH_FLOW_END, PH_FLOW_START,
                     PH_SPAN, Event)

#: per-host thread-id block size: local thread ids are compacted into
#: [host*stride, host*stride + #threads), so traces from up to
#: `stride` threads/host merge collision-free
_HOST_TID_STRIDE = 100_000


def _resolve_host(host) -> Optional[int]:
    """Explicit host wins; otherwise namespace only when
    torch.distributed runs more than one rank (a single host keeps the
    plain layout)."""
    if host is not None:
        return int(host)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return int(dist.get_rank())
    return None


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


def chrome_trace(evs: Optional[List[Event]] = None,
                 clear: bool = False,
                 host: Optional[int] = None,
                 include_ledger: bool = True) -> Dict[str, Any]:
    """Build the Trace Event Format object from `evs` (default: a
    snapshot of the bus; clear=True drains it instead). Timestamps
    are rebased to the earliest event so the viewer opens at t=0.
    `host` namespaces pid/tid per mesh host (module doc).

    ``include_ledger``: flight-recorder step records
    (obs/ledger.py — same perf_counter clock as the bus) are appended
    as per-phase **counter tracks** (``ledger:stage`` /
    ``ledger:factor`` / ...), one sample at each step's end, so the
    Perfetto view shows the phase breakdown as stacked counters right
    under the span timeline. With the recorder off (the FROZEN
    default) there are zero records and the output is byte-identical
    to the pre-ledger export."""
    if evs is None:
        evs = _events_mod.drain() if clear else _events_mod.events()
    led_recs = []
    if include_ledger:
        from . import ledger as _ledger
        led_recs = _ledger.records()
    t_min_led = min((r.t0 for r in led_recs), default=None)
    h = _resolve_host(host)
    pid = os.getpid() if h is None else h
    t_min = min((e.t0 for e in evs), default=t_min_led or 0.0)
    if t_min_led is not None:
        t_min = min(t_min, t_min_led)
    out: List[Dict[str, Any]] = []
    threads: Dict[int, str] = {}
    tid_map: Dict[int, int] = {}

    def map_tid(tid: int) -> int:
        if h is None:
            return tid
        if tid not in tid_map:
            tid_map[tid] = h * _HOST_TID_STRIDE + len(tid_map)
        return tid_map[tid]

    for e in evs:
        threads.setdefault(e.tid, e.thread)
        rec: Dict[str, Any] = {
            "name": e.name,
            "ph": e.ph,
            "ts": round((e.t0 - t_min) * 1e6, 3),
            "pid": pid,
            "tid": map_tid(e.tid),
        }
        if e.cat:
            rec["cat"] = e.cat
        if e.ph == PH_SPAN:
            rec["dur"] = round((e.t1 - e.t0) * 1e6, 3)
        elif e.ph != PH_COUNTER:
            rec["s"] = "t"               # instant scope: thread
        if e.args:
            rec["args"] = {k: _jsonable(v) for k, v in e.args.items()}
        if e.device is not None:
            # a device-timed span: its identity, and its device seconds
            # once its CUDA events were read (events.device_seconds())
            a = rec.setdefault("args", {})
            a.update(span=e.sid, parent=e.parent, call=e.call)
            if e.device.seconds is not None:
                a["device_s"] = e.device.seconds
        out.append(rec)
    # Perfetto flow events: each traced
    # request's serve::request span starts a flow (trace_id as the
    # flow id) that the batch::flush slice carrying it terminates —
    # the viewer draws the arrow from request to the co-batched
    # dispatch it rode. Only trace-stamped serve-cat span events
    # produce these, so with obs/reqtrace off there are none and the
    # export output is byte-identical.
    for e in evs:
        if e.cat != "serve" or e.ph != PH_SPAN or not e.args:
            continue
        if e.name == "serve::request" and e.args.get("trace_id"):
            flow_ph, flow_ids = PH_FLOW_START, [e.args["trace_id"]]
        elif e.name == "batch::flush" and e.args.get("trace_ids"):
            flow_ph, flow_ids = PH_FLOW_END, e.args["trace_ids"]
        else:
            continue
        for fid in flow_ids:
            # ts nudged inside the slice so the flow binds to it
            frec: Dict[str, Any] = {
                "name": "serve.flow", "cat": "serve", "ph": flow_ph,
                "id": str(fid),
                "ts": round((e.t0 - t_min) * 1e6 + 0.001, 3),
                "pid": pid, "tid": map_tid(e.tid)}
            if flow_ph == PH_FLOW_END:
                frec["bp"] = "e"
            out.append(frec)
    # flight-recorder phase counter tracks (module doc): one "C"
    # sample per committed step per phase, valued in milliseconds,
    # named per op so concurrent drivers get separate tracks
    for r in led_recs:
        ts = round((r.t1 - t_min) * 1e6, 3)
        for ph, secs in sorted(r.phases.items()):
            out.append({"name": "ledger:%s:%s" % (r.op, ph),
                        "ph": PH_COUNTER, "ts": ts, "pid": pid,
                        "tid": 0 if h is None
                        else h * _HOST_TID_STRIDE,
                        "args": {"value": round(secs * 1e3, 4)}})
    # thread-name metadata rows so Perfetto labels worker threads
    # (and, namespaced, which HOST each thread row belongs to)
    for tid, name in sorted(threads.items()):
        label = name if h is None else "host%d:%s" % (h, name)
        out.append({"name": "thread_name", "ph": "M", "ts": 0,
                    "pid": pid, "tid": map_tid(tid),
                    "args": {"name": label}})
    if h is not None:
        out.append({"name": "process_name", "ph": "M", "ts": 0,
                    "pid": pid, "tid": h * _HOST_TID_STRIDE,
                    "args": {"name": "host %d" % h}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_trace(path: str, evs: Optional[List[Event]] = None,
                clear: bool = False,
                host: Optional[int] = None,
                include_ledger: bool = True) -> str:
    """Serialize chrome_trace() to `path`; returns the path."""
    obj = chrome_trace(evs, clear=clear, host=host,
                       include_ledger=include_ledger)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path

"""Request-scoped trace / span context (counterpart of
``slate_tpu/obs/reqtrace.py``).

A request crossing the coalescing queue and its dispatch gets a causal
identity here:

  * :func:`begin` mints a :class:`Span` (trace_id, span_id, parent,
    tenant, op);
  * a thread-local activation stack (:func:`activate` /
    :func:`active` / :func:`current`) lets synchronous callees stamp
    the active id without an argument through every signature;
  * across threads the context rides data: the span is handed to
    ``CoalescingQueue.submit(..., trace=)`` and stored on the ticket,
    the queue's dispatch stamps the flush timestamps and a flush id on
    traced tickets, and ``Ticket._resolve`` calls
    :meth:`Span.on_resolved` from whichever thread resolves, closing
    the span with its queue-wait / dispatch / solve split;
  * span closure fans out to the obs bus (a ``serve::request`` span
    that obs/export.py flow-links to its ``batch::flush`` slice), to
    obs/series.py's quantile sketches and SLO windows, and to a
    ``serve.request`` ledger record.

The gate is the FROZEN ``("obs", "reqtrace") = "off"`` row (or
:func:`enable`): off, :func:`begin` returns None and every
propagation site is one ``is not None`` check.
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

#: bounded ring capacity for finished spans (oldest dropped, counted)
SPAN_CAP = 65_536

#: the root span name every admitted request closes under; series,
#: ledger, and the export flow pass key on it
REQUEST_SPAN = "serve::request"
#: client-side RPC round-trip span (same trace_id as the server root)
CLIENT_SPAN = "serve::rpc"
#: the co-batched flush linkage record (args carry flush_id + the
#: trace ids that rode it; export.py turns these into flow ends)
FLUSH_SPAN = "batch::flush"

_lock = threading.Lock()
_spans: "collections.deque" = collections.deque(maxlen=SPAN_CAP)
_dropped = 0
_flush_seq = 0
_req_seq = 0

_explicit: Optional[bool] = None
_resolved: Optional[bool] = None

_tls = threading.local()


# -- the gate (obs/ledger.py discipline) ----------------------------------

def enable() -> None:
    """Force tracing on for this process (tests/bench)."""
    global _explicit
    _explicit = True


def disable() -> None:
    global _explicit
    _explicit = False


def enabled() -> bool:
    """Explicit override > memoized FROZEN ``obs/reqtrace`` row."""
    if _explicit is not None:
        return _explicit
    global _resolved
    if _resolved is None:
        try:
            from ..tune.select import resolve
            _resolved = str(resolve("obs", "reqtrace")) == "on"
        except Exception:
            _resolved = False
    return _resolved


def reset() -> None:
    """Drop every span and forget both the explicit override and the
    memoized tune row (test isolation)."""
    global _explicit, _resolved, _dropped, _flush_seq, _req_seq
    with _lock:
        _spans.clear()
        _dropped = 0
        _flush_seq = 0
        _req_seq = 0
    _explicit = None
    _resolved = None


# -- spans ----------------------------------------------------------------

def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One traced unit of work. Mutation is single-writer by
    construction: phases/args are written by whichever thread holds
    the request at that stage (submit thread, then the resolving
    thread), never concurrently — the queue hands the span off with
    the ticket."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "tenant",
                 "op", "t0", "t1", "phases", "args")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], tenant: str, op: str,
                 t0: Optional[float] = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tenant = tenant
        self.op = op
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.phases: Dict[str, float] = {}
        self.args: Dict[str, Any] = {}

    def child(self, name: str, op: Optional[str] = None) -> "Span":
        """A child span in the same trace (the chainer's shared
        factor dispatch)."""
        return Span(name, self.trace_id, _new_id(), self.span_id,
                    self.tenant, self.op if op is None else op)

    def on_resolved(self, ticket) -> None:
        """Queue-ticket closure hook, called by ``Ticket._resolve``
        from the resolving thread: derive the queue-wait / dispatch /
        solve split from the flush timestamps the dispatcher stamped,
        record the flush linkage, and finish. Must never raise into
        the resolve path (the caller guards, this stays total)."""
        t1 = time.perf_counter()
        t_flush = getattr(ticket, "t_flush", None)
        if t_flush is not None:
            t_disp = getattr(ticket, "t_dispatch", None) or t_flush
            self.phases["queue_wait_s"] = t_flush - ticket._t_submit
            self.phases["dispatch_s"] = t_disp - t_flush
            self.phases["solve_s"] = t1 - t_disp
        fid = getattr(ticket, "flush_id", None)
        if fid is not None:
            self.args["flush_id"] = fid
        self.finish(error=ticket._error, t1=t1)

    def finish(self, error: Optional[BaseException] = None,
               t1: Optional[float] = None, **args) -> "Span":
        """Close the span (idempotent) and commit it to the ring,
        the bus, and — for the request root — series + ledger."""
        if self.t1 is not None:
            return self
        self.t1 = time.perf_counter() if t1 is None else t1
        if args:
            self.args.update(args)
        if error is not None:
            self.args["error"] = str(error)[:120]
        _commit(self)
        return self


def begin(name: str = REQUEST_SPAN, tenant: str = "", op: str = "",
          parent: Any = None) -> Optional[Span]:
    """Mint a span, or None when tracing is off (the whole off-state
    cost at every call site is this one boolean). ``parent`` may be
    another :class:`Span` or a ``{"trace", "span"}`` dict (the
    reference's RPC header); either continues the existing trace."""
    if not enabled():
        return None
    if isinstance(parent, Span):
        tid, pid = parent.trace_id, parent.span_id
    elif isinstance(parent, dict) and parent.get("trace"):
        tid, pid = str(parent["trace"]), parent.get("span")
    else:
        tid, pid = _new_id(), None
    return Span(name, tid, _new_id(), pid, str(tenant), str(op))


def record_flush(op: str, t0: float, t1: float, flush_id: int,
                 trace_ids: List[str], occupancy: int,
                 strategy: str) -> None:
    """One co-batched flush's linkage record: which traces rode it.
    Only called by the queue when at least one ticket is traced."""
    sp = Span(FLUSH_SPAN, "", _new_id(), None, "", op, t0=t0)
    sp.args.update({"flush_id": flush_id, "trace_ids": trace_ids,
                    "occupancy": occupancy, "strategy": strategy})
    sp.finish(t1=t1)


def next_flush_id() -> int:
    global _flush_seq
    with _lock:
        _flush_seq += 1
        return _flush_seq


def _commit(sp: Span) -> None:
    global _dropped, _req_seq
    with _lock:
        if len(_spans) == SPAN_CAP:
            _dropped += 1
        _spans.append(sp)
    from . import events as _ev
    if _ev.enabled():
        args: Dict[str, Any] = {"span_id": sp.span_id}
        if sp.trace_id:
            args["trace_id"] = sp.trace_id
        if sp.parent_id:
            args["parent_id"] = sp.parent_id
        if sp.tenant:
            args["tenant"] = sp.tenant
        if sp.op:
            args["op"] = sp.op
        args.update(sp.args)
        args.update({k: round(v, 6) for k, v in sp.phases.items()})
        _ev.publish(sp.name, _ev.PH_SPAN, sp.t0, sp.t1, cat="serve",
                    args=args)
    if sp.name != REQUEST_SPAN:
        return
    total = sp.t1 - sp.t0
    from . import series as _series
    if _series.enabled():
        # literal publish sites, not a loop over names
        _series.sample("serve.latency_s", total, tenant=sp.tenant,
                       op=sp.op)
        ph = sp.phases
        if "admit_s" in ph:
            _series.sample("serve.admit_wait_s", ph["admit_s"],
                           tenant=sp.tenant, op=sp.op)
        if "queue_wait_s" in ph:
            _series.sample("serve.queue_wait_s", ph["queue_wait_s"],
                           tenant=sp.tenant, op=sp.op)
        if "dispatch_s" in ph:
            _series.sample("serve.dispatch_s", ph["dispatch_s"],
                           tenant=sp.tenant, op=sp.op)
        if "solve_s" in ph:
            _series.sample("serve.solve_s", ph["solve_s"],
                           tenant=sp.tenant, op=sp.op)
        _series.note_slo(sp.tenant, total)
    from . import ledger as _ledger
    if _ledger.enabled():
        with _lock:
            seq = _req_seq
            _req_seq += 1
        meta: Dict[str, Any] = {"trace": sp.trace_id,
                                "tenant": sp.tenant, "op": sp.op}
        meta.update({k: v for k, v in sp.args.items()
                     if isinstance(v, (str, int, float, bool))})
        meta.update({k: round(v, 6) for k, v in sp.phases.items()})
        _ledger.append("serve.request", step=seq,
                       phases={"other": total}, meta=meta)


# -- thread-local activation ---------------------------------------------

def activate(sp: Optional[Span]) -> None:
    if sp is None:
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(sp)


def deactivate(sp: Optional[Span]) -> None:
    if sp is None:
        return
    stack = getattr(_tls, "stack", None)
    if stack and stack[-1] is sp:
        stack.pop()
    elif stack and sp in stack:
        stack.remove(sp)


@contextmanager
def active(sp: Optional[Span]):
    """Make `sp` the thread's current span for the block; a None span
    is a no-op (the off state costs nothing here either)."""
    if sp is None:
        yield
        return
    activate(sp)
    try:
        yield
    finally:
        deactivate(sp)


def current() -> Optional[Span]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def current_trace_id() -> Optional[str]:
    """The active span's trace id, or None (off, or no span active) —
    escalation payloads pass this straight through; record_escalation
    drops None values."""
    sp = current()
    return None if sp is None else sp.trace_id


# -- accessors ------------------------------------------------------------

def spans(name: Optional[str] = None) -> List[Span]:
    """Snapshot of finished spans, optionally filtered by name."""
    with _lock:
        out = list(_spans)
    if name is not None:
        out = [s for s in out if s.name == name]
    return out


def trace(trace_id: str) -> List[Span]:
    """Every finished span of one trace, oldest first — the
    end-to-end reconstruction of a single request."""
    return [s for s in spans() if s.trace_id == trace_id]


def count() -> int:
    with _lock:
        return len(_spans)


def dropped() -> int:
    with _lock:
        return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0

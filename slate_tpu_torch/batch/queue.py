"""Request-coalescing micro-batch queue (counterpart of
``slate_tpu/batch/queue.py``).

Requests accumulate per (op, bucket shape, nrhs, dtype) and flush as
ONE batched dispatch when the bucket reaches ``max_batch`` or has
waited ``max_wait_us`` (both tuned, FROZEN 64 and 2000). A bucket with
one occupant flushes as a batch of 1 through the same batched core.

Under the RAGGED strategy (``strategy="ragged"`` or an earned
``batch/strategy`` tune row) the square factorizations and solves
(drivers.RAGGED_OPS) drop the bucket from the coalescing key: one
dispatch stacks to the flush's largest live size, rounded to
lcm(align, blk), with a per-element sizes vector, and runs the ragged
kernels. The FROZEN strategy is "bucket".

Host in, host out, as the reference: requests (numpy arrays or CPU
tensors) are padded and stacked on the host; each operand stack makes
one host-to-device copy per flush, each output stack one
device-to-host copy, and each ticket gets its cropped CPU tensor. The
device is the queue's (``device``; the CUDA card unless the caller
passes ``device="cpu"``), used explicitly by the background flusher
thread too.

Every flush updates ``stats()`` and, with the obs bus on, the
``batch.*`` metrics and one ``batch:<op>`` instant. Both strategies
dispatch through ``_dispatch_guarded``: without a fault plan the first
attempt runs bare and only a transient failure (resil/guard.py's
TRANSIENT_TYPES) enters the bounded retry; under a plan every attempt
passes the ``batch`` fault site. ``submit`` passes the
``batch_submit`` site and the background flusher the ``flusher`` site
each tick. With the flight recorder on (obs/ledger.py), each dispatch
appends one ``batch.dispatch`` record: ``stage`` is the host-side stack
build, ``factor`` the host-to-device copy, the dispatch and the copy
back. A ticket submitted with a request span (``submit(...,
trace=)``, obs/reqtrace.py) gets the flush's timestamps and id, and the
flush a linkage record. All of it is off by default: with no plan, the
recorder and tracing off, a flush adds no host read and its results
are bitwise those of the unguarded dispatch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from . import bucket as _bucket
from . import drivers as _drivers
from ..obs import ledger as _ledger
from ..resil import faults as _faults
from ..resil import guard as _guard
from ..utils.backend import DeviceLike, resolve_device


def _death_error(dead: BaseException) -> RuntimeError:
    err = RuntimeError("batch background flusher died: %r" % (dead,))
    err.__cause__ = dead
    return err


class Ticket:
    """One submitted request's handle. ``result()`` blocks until the
    request's bucket has been flushed (forcing the flush itself if the
    queue has no background flusher or the deadline has not fired),
    then returns the CROPPED per-request result (CPU tensors)."""

    def __init__(self, queue: "CoalescingQueue", key) -> None:
        self._queue = queue
        self._key = key
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        #: set at flush time: wall seconds from submit to result
        self.latency_s: Optional[float] = None
        self._t_submit = time.perf_counter()
        #: request span (obs/reqtrace.py) handed in through
        #: submit(trace=); the dispatch stamps the flush timestamps and
        #: id onto traced tickets only
        self.trace = None
        self.t_flush: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.flush_id: Optional[int] = None

    def _resolve(self, value=None, error=None) -> None:
        self._value = value
        self._error = error
        self.latency_s = time.perf_counter() - self._t_submit
        if self.trace is not None:
            # the span closes on the resolving thread, before the event
            # fires (a waiter must find it committed); it never fails a
            # resolution
            try:
                self.trace.on_resolved(self)
            except Exception:
                pass
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block (at most `timeout` seconds, None = forever) for this
        request's result. A timeout raises :class:`TimeoutError` naming
        the bucket; a dead background flusher raises its death error
        (also for a ticket it had already taken from the bucket when it
        died). The death check runs after the forced flush, so submits
        after a death still resolve through result()'s own flush."""
        if not self._done.is_set():
            # synchronous fallback: drain my bucket now instead of
            # waiting out the coalescing window
            self._queue.flush(self._key)
        dead = self._queue._flusher_error
        if dead is not None and not self._done.is_set():
            raise _death_error(dead)
        if not self._done.wait(timeout):
            dead = self._queue._flusher_error
            if dead is not None:
                raise _death_error(dead)
            raise TimeoutError(
                "batched %r request (bucket %r) still pending after "
                "%.4gs — flush lost or dispatch wedged"
                % (self._key[0], self._key[1:], timeout))
        if self._error is not None:
            raise self._error
        return self._value


#: sentinel in the (bm, bn) key slots of a ragged bucket: the key
#: drops the shape under the ragged strategy, and the stacking ceiling
#: is chosen per flush
RAGGED = "ragged"


class CoalescingQueue:
    """The micro-batch dispatcher. Thread-safe; optionally runs a
    daemon flusher thread that enforces the max-wait deadline
    (``background=True``). Use as a context manager or call
    ``close()``.

    ``strategy``: explicit ("bucket"/"ragged" or a
    core/methods.MethodBatchStrategy member) wins, else the tuned/frozen
    ``batch/strategy`` row (FROZEN "bucket"). Under "ragged", the
    square factorizations and solves with a dtype (and, on the card,
    an order) the ragged kernels take coalesce per (op, nrhs, dtype)
    and flush as ONE sizes-carrying dispatch; everything else keeps
    the bucket path. ``device``: where the dispatches run (module
    doc)."""

    def __init__(self, max_batch: Optional[int] = None,
                 max_wait_us: Optional[int] = None,
                 opts=None, background: bool = False,
                 strategy=None, device: DeviceLike = None) -> None:
        from ..core.methods import MethodBatchStrategy, str2method
        from ..tune.select import tuned_int
        self.max_batch = int(max_batch) if max_batch else tuned_int(
            "batch", "max_batch", 64, opts=opts)
        self.max_wait_us = int(max_wait_us) if max_wait_us is not None \
            else tuned_int("batch", "max_wait_us", 2000, opts=opts)
        if strategy is None:
            self._strategy = MethodBatchStrategy.resolve()
        else:
            self._strategy = str2method("batch", strategy) \
                if isinstance(strategy, str) else strategy
            if self._strategy is MethodBatchStrategy.Auto:
                self._strategy = MethodBatchStrategy.resolve()
        self._device = resolve_device(device)
        #: lane alignment resolved once per queue (submit is the hot
        #: path: no tune-cache read per request)
        self._align = _bucket.batch_align(opts=opts)
        #: kept for the per-flush ragged block-width resolution
        self._opts = opts
        self._lock = threading.Lock()
        #: key -> list of pending (ticket, operand, rhs, (m, n))
        self._pending: Dict[tuple, List[tuple]] = {}
        #: key -> perf_counter of the bucket's OLDEST pending request
        self._oldest: Dict[tuple, float] = {}
        self._stats = {"requests": 0, "dispatches": 0,
                       "dispatches_saved": 0, "occupancy_sum": 0,
                       "max_occupancy": 0, "waste_sum": 0.0,
                       "waste_flops_sum": 0.0,
                       "flops_sum": 0.0, "occ_flops_sum": 0.0,
                       "ragged_dispatches": 0,
                       "ragged_flops_saved": 0.0}
        #: ledger step ids of dispatch records (read and incremented
        #: under _lock)
        self._led_seq = 0
        self._closed = False
        #: set when the background flusher thread died
        self._flusher_error: Optional[BaseException] = None
        self._flusher: Optional[threading.Thread] = None
        self._wake = threading.Event()
        if background:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="batch-flusher",
                daemon=True)
            self._flusher.start()

    def _ragged_route(self, op: str, dtype, nrhs: int, n: int) -> bool:
        """True when this request coalesces under the ragged strategy:
        the queue resolved Ragged, the op has a ragged route, any rhs
        has at least one column, and the kernels take the dtype (and,
        on the card, the order) on the queue's device. Anything else
        keeps the bucket path."""
        from ..core.methods import MethodBatchStrategy
        from ..ops import kernels as _pk
        if self._strategy is not MethodBatchStrategy.Ragged \
                or op not in _drivers.RAGGED_OPS:
            return False
        if _drivers.OPS[op].has_rhs and nrhs < 1:
            return False
        return _pk.ragged_supported(dtype, self._device, n)

    def _device_ctx(self):
        """The queue's card made current (the flusher thread's work
        lands on it too); nothing on the CPU."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    # -- submission -------------------------------------------------------

    def submit(self, op: str, a, b=None, trace=None) -> Ticket:
        """Enqueue one problem. `a` is a single (n, n) (or (m, n) for
        geqrf/gels) matrix, `b` an optional (n,) / (n, k) right-hand
        side, numpy arrays or CPU tensors. The operands are copied here
        (padded to the bucket on the bucket path), so a caller may
        reuse its arrays after submit returns. `trace` (an
        obs/reqtrace.py span) rides the ticket, since submit may flush
        inline."""
        if self._closed:
            raise RuntimeError("queue is closed")
        _faults.check("batch_submit", op=op)
        spec = _drivers.OPS.get(op)
        if spec is None:
            raise ValueError(f"unknown batched op {op!r}; have "
                             f"{sorted(_drivers.OPS)}")
        a = _bucket._host(a)
        if a.dim() != 2:
            raise ValueError(f"{op} request must be a 2-D matrix, got "
                             f"shape {tuple(a.shape)}")
        m, n = a.shape
        if op == "gels":
            if m < n:
                raise ValueError("gels is overdetermined-only (m >= n) "
                                 "in the batch layer")
        elif op != "geqrf" and m != n:
            raise ValueError(f"{op} request must be square, got "
                             f"({m}, {n})")
        b2 = None
        nrhs = 0
        if spec.has_rhs:
            if b is None:
                raise ValueError(f"{op} needs a right-hand side")
            b = _bucket._host(b)
            b2 = b[:, None] if b.dim() == 1 else b
            if b2.shape[0] != m:
                raise ValueError(f"rhs rows {b2.shape[0]} != matrix "
                                 f"rows {m}")
            if b2.dtype != a.dtype:
                # one malformed request must not fail every co-batched
                # ticket at dispatch time
                raise ValueError(
                    f"{op} rhs dtype {b2.dtype} != matrix dtype "
                    f"{a.dtype}; cast explicitly before submit")
            nrhs = b2.shape[1]
        elif b is not None:
            raise ValueError(f"{op} takes no right-hand side")
        if self._ragged_route(op, a.dtype, nrhs, n):
            # no padding here: the ceiling is a property of the flush.
            # Snapshot the operands (the bucket path copies as it pads)
            key = (op, RAGGED, RAGGED, nrhs, str(a.dtype))
            pa = a.clone()
            pb = None if b2 is None else b2.clone()
        else:
            if op in ("geqrf", "gels") and m != n:
                bm, bn = _bucket.rect_buckets(m, n, align=self._align)
                pa = _bucket.pad_rect(a, bm, bn, spec.pad_mode)
            else:
                bm = bn = _bucket.bucket_for(m, align=self._align)
                pa = _bucket.pad_square(a, bm, spec.pad_mode)
            pb = None if b2 is None else _bucket.pad_rhs(b2, bm, nrhs)
            key = (op, bm, bn, nrhs, str(pa.dtype))
        ticket = Ticket(self, key)
        if trace is not None:
            ticket.trace = trace
        flush_now = False
        with self._lock:
            pend = self._pending.setdefault(key, [])
            pend.append((ticket, pa, pb, (m, n)))
            self._oldest.setdefault(key, time.perf_counter())
            if len(pend) >= self.max_batch:
                flush_now = True
        if flush_now:
            self.flush(key)
        elif self._flusher is not None:
            self._wake.set()
        return ticket

    # -- flushing ---------------------------------------------------------

    def flush(self, key=None) -> int:
        """Dispatch one bucket (or every bucket with key=None).
        Returns the number of dispatches issued."""
        with self._lock:
            keys = [key] if key is not None else list(self._pending)
            taken = []
            for k in keys:
                entries = self._pending.pop(k, None)
                self._oldest.pop(k, None)
                if entries:
                    taken.append((k, entries))
        for k, entries in taken:
            self._dispatch(k, entries)
        return len(taken)

    def _flush_loop(self) -> None:
        try:
            while not self._closed:
                self._wake.wait(
                    timeout=self.max_wait_us / 2e6 or 0.001)
                self._wake.clear()
                if self._closed:
                    return
                # `busy` lets a plan target a tick that holds pending
                # work (an idle loop ticks every max_wait_us / 2)
                _faults.check("flusher", busy=bool(self._oldest))
                now = time.perf_counter()
                with self._lock:
                    due = [k for k, t0 in self._oldest.items()
                           if now - t0 >= self.max_wait_us / 1e6]
                for k in due:
                    self.flush(k)
        except BaseException as e:
            self._on_flusher_death(e)

    def _on_flusher_death(self, e: BaseException) -> None:
        """The background flusher died: fail every pending ticket with
        the death error instead of leaving their waiters to hang. The
        queue stays usable in synchronous mode (result() forces its own
        bucket's flush); the death is counted
        (``resil.flusher_deaths``) and published as an obs instant."""
        self._flusher_error = e
        with self._lock:
            taken = list(self._pending.items())
            self._pending.clear()
            self._oldest.clear()
        err = _death_error(e)
        for _k, entries in taken:
            for t, *_rest in entries:
                t._resolve(error=err)
        _guard._count("resil.flusher_deaths")
        from ..obs import events as obs_events
        if obs_events.enabled():
            from ..obs import metrics as om
            om.inc("resil.flusher_deaths")
            obs_events.instant("resil::flusher_death", cat="resil",
                               error=str(e)[:120],
                               failed=sum(len(v) for _, v in taken))

    def _dispatch_guarded(self, op: str, fn):
        """The dispatch retry ladder both strategies share: under an
        active fault plan every attempt passes the "batch" site;
        without one the first attempt runs bare and only a transient
        failure enters the bounded retry. Exhaustion, or any other
        error (a CUDA error, a failed build or launch among them),
        propagates to the caller, which resolves every co-batched
        ticket with it."""
        def _once():
            _faults.check("batch", op=op)
            return fn()

        if _faults.active() is not None:
            return _guard.retry(_once, "batch", op=op)
        try:
            return fn()
        except Exception as e:
            if not _guard.is_transient(e):
                raise
            return _guard.retry_after_failure(_once, "batch", e, op=op)

    def _run(self, op: str, entries, build, call, strategy: str,
             ceiling: int, waste, record) -> None:
        """One flush: `build()` makes the host stacks (the ledger's
        ``stage``); each guarded attempt copies them to the device (one
        copy each, a fresh one an attempt, since the ragged kernels
        factor and solve in their operands), dispatches through
        `call(stack, rhs)` and copies each output stack back (the
        ledger's ``factor``); every ticket is resolved with its crop,
        or every ticket with the error. `waste()` gives the ledger's
        padding-waste fraction. `record()` counts the flush in stats()
        once, before any ticket resolves, so a count read after
        ``result()`` already holds it (the reference counts after
        resolving, which a reader can race while the background flusher
        finishes). (The reference rounds the batch up to a power of two
        to bound XLA's compiled shapes; eager launches take any batch,
        so the real one is dispatched.)"""
        tickets = [e[0] for e in entries]
        led_on = _ledger.enabled()
        traced = any(t.trace is not None for t in tickets)
        fid = None
        if traced:
            from ..obs import reqtrace as _rt
            fid = _rt.next_flush_id()
        clocked = led_on or traced
        t_led = time.perf_counter() if clocked else 0.0
        recorded = False
        try:
            stack, rhs = build()
            nrhs = rhs.shape[-1] if rhs is not None else 0
            t_stage = time.perf_counter() if clocked else 0.0

            def attempt():
                with self._device_ctx():
                    s = stack.to(self._device, copy=True)
                    r = None if rhs is None \
                        else rhs.to(self._device, copy=True)
                    out = call(s, r)
                    parts = out if isinstance(out, tuple) else (out,)
                    return [o.cpu() for o in parts]

            hosts = self._dispatch_guarded(op, attempt)
            if led_on:
                t_done = time.perf_counter()
                with self._lock:
                    seq = self._led_seq
                    self._led_seq += 1
                meta = {"op": op, "occupancy": len(entries),
                        "strategy": strategy, "ceiling": ceiling,
                        "waste_flops": round(waste(), 4)}
                if traced:
                    meta["traces"] = [t.trace.trace_id for t in tickets
                                      if t.trace is not None][:16]
                _ledger.append("batch.dispatch", step=seq,
                               phases={"stage": t_stage - t_led,
                                       "factor": t_done - t_stage},
                               meta=meta)
            recorded = True
            record()
            for i, (t, _pa, _pb, (m, n)) in enumerate(entries):
                if t.trace is not None:
                    t.t_flush = t_led
                    t.t_dispatch = t_stage
                    t.flush_id = fid
                t._resolve(value=_crop(op, [h[i] for h in hosts], m, n,
                                       nrhs))
            if traced:
                _rt.record_flush(
                    op, t_led, time.perf_counter(), fid,
                    [t.trace.trace_id for t in tickets
                     if t.trace is not None],
                    occupancy=len(entries), strategy=strategy)
        except BaseException as e:      # resolve-or-hang: every ticket
            if not recorded:            # must learn its fate
                record()
            for t in tickets:
                t._resolve(error=e)

    def _dispatch(self, key, entries) -> None:
        if key[1] == RAGGED:
            return self._dispatch_ragged(key, entries)
        op, bm, bn, nrhs, _dt = key
        spec = _drivers.OPS[op]

        def build():
            stack = torch.stack([e[1] for e in entries])
            rhs = torch.stack([e[2] for e in entries]) if spec.has_rhs \
                else None
            return stack, rhs

        self._run(op, entries, build,
                  lambda s, r: _drivers._dispatch(op, s, r), "bucket", bm,
                  lambda: _bucket.stack_report(
                      [e[3] for e in entries], bm, bn)
                  ["padding_waste_flops"],
                  lambda: self._record(key, entries))

    def _dispatch_ragged(self, key, entries) -> None:
        """One RAGGED flush: the ceiling from THIS flush's live sizes
        (the largest, rounded to lcm(align, blk)), each operand
        zero-padded to it (the kernels never read the pad), one
        dispatch with the sizes vector."""
        op, _bm, _bn, nrhs, _dt = key
        spec = _drivers.OPS[op]
        from ..ops import kernels as _pk
        blk = _pk.ragged_blk(opts=self._opts)
        sizes = [e[3][1] for e in entries]
        ceil = _bucket.ragged_ceiling(sizes, blk=blk, align=self._align)

        def build():
            k = len(entries)
            stack = torch.zeros((k, ceil, ceil),
                                dtype=entries[0][1].dtype)
            rhs = torch.zeros((k, ceil, nrhs), dtype=stack.dtype) \
                if spec.has_rhs else None
            for i, (_t, pa, pb, (_m, n)) in enumerate(entries):
                stack[i, :n, :n] = pa
                if rhs is not None:
                    rhs[i, :n] = pb
            return stack, rhs

        def call(s, r):
            return _drivers.ragged_dispatch(
                op, s, torch.tensor(sizes, dtype=torch.int32), r,
                blk=blk, donate=True, device=self._device)

        self._run(op, entries, build, call, "ragged", ceil,
                  lambda: _bucket.ragged_report(
                      sizes, blk, align=self._align)
                  ["padding_waste_flops"],
                  lambda: self._record(key, entries, ragged_blk=blk))

    def _record(self, key, entries,
                ragged_blk: Optional[int] = None) -> None:
        op, bm, bn, nrhs, _dt = key
        ns = [e[3] for e in entries]
        saved = None
        if ragged_blk is not None:
            rep = _bucket.ragged_report([n for (_m, n) in ns],
                                        ragged_blk, align=self._align)
            sched = rep.pop("scheduled_flops")
            saved = rep.pop("flops_saved")
            label = RAGGED
        else:
            rep = _bucket.stack_report(ns, bm, bn)
            sched = len(ns) * bm * float(bn) ** 2
            label = "%dx%d" % (bm, bn)
        k = rep["occupancy"]
        with self._lock:
            s = self._stats
            s["requests"] += k
            s["dispatches"] += 1
            s["dispatches_saved"] += k - 1
            s["occupancy_sum"] += k
            s["max_occupancy"] = max(s["max_occupancy"], k)
            s["waste_sum"] += rep["padding_waste"]
            s["waste_flops_sum"] += rep["padding_waste_flops"]
            s["flops_sum"] += sched
            s["occ_flops_sum"] += k * sched
            if saved is not None:
                s["ragged_dispatches"] += 1
                s["ragged_flops_saved"] += saved
        from ..obs import events as obs_events
        if obs_events.enabled():
            from ..obs import metrics as om
            om.inc("batch.requests", k)
            om.inc("batch.dispatches")
            om.inc("batch.dispatches_saved", k - 1)
            if saved is not None:
                om.inc("batch.ragged_dispatches")
                om.inc("batch.ragged_flops_saved", int(saved))
            om.observe("batch.occupancy", k)
            om.observe("batch.padding_waste", rep["padding_waste"])
            om.observe("batch.padding_waste_flops",
                       rep["padding_waste_flops"])
            obs_events.instant("batch:%s" % op, cat="driver",
                               occupancy=k, bucket=label,
                               padding_waste=round(
                                   rep["padding_waste"], 4))

    # -- bookkeeping ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Requests, dispatches, dispatches_saved, mean/max occupancy,
        mean padding-waste fractions, the FLOPS-WEIGHTED mean occupancy
        (each dispatch weighted by its scheduled cubic extent), the
        ragged dispatch / flops-saved counts, and ``pending_by_key``:
        per coalescing key of not-yet-flushed work, its count, queued
        flops (true-extent m*n^2) and the age of its oldest request,
        all from one clock read."""
        now = time.perf_counter()
        with self._lock:
            s = dict(self._stats)
            s["pending_by_key"] = {
                k: {"count": len(v),
                    "queued_flops": float(sum(
                        m * float(n) ** 2 for _t, _a, _b, (m, n) in v)),
                    "age_s": now - self._oldest.get(k, now)}
                for k, v in self._pending.items() if v}
        d = max(s["dispatches"], 1)
        s["mean_occupancy"] = s.pop("occupancy_sum") / d
        s["mean_padding_waste"] = s.pop("waste_sum") / d
        s["mean_padding_waste_flops"] = s.pop("waste_flops_sum") / d
        flops = s.pop("flops_sum")
        occf = s.pop("occ_flops_sum")
        s["mean_occupancy_weighted"] = occf / flops if flops > 0 \
            else 0.0
        return s

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def close(self) -> None:
        """Flush everything and stop the background flusher."""
        self._closed = True
        self._wake.set()
        self.flush()
        if self._flusher is not None:
            self._flusher.join(timeout=1.0)

    def __enter__(self) -> "CoalescingQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _crop(op: str, outs, m: int, n: int, nrhs: int):
    """Cut one request's logical result out of the padded batched
    output (the padding contract makes the crop exact)."""
    if op == "potrf":
        return outs[0][:n, :n]
    if op in ("getrf", "geqrf"):
        return outs[0][:m, :n], outs[1][: min(m, n)]
    if op in ("posv", "gesv", "potrs", "getrs", "gels"):
        return outs[0][:n, :nrhs]
    if op == "heev":
        return outs[0][:n], outs[1][:n, :n]
    raise ValueError(f"unknown op {op!r}")


def run(op: str, mats, rhs=None, max_batch: Optional[int] = None,
        opts=None, strategy=None, device: DeviceLike = None) -> list:
    """One-shot convenience: coalesce a list of heterogeneous problems
    through a fresh queue and return their results (CPU tensors) in
    submission order. ``strategy`` threads through to the queue (None =
    the tuned/frozen ``batch/strategy`` route)."""
    q = CoalescingQueue(max_batch=max_batch, opts=opts,
                        background=False, strategy=strategy,
                        device=device)
    with q:
        if rhs is None:
            tickets = [q.submit(op, a) for a in mats]
        else:
            tickets = [q.submit(op, a, b) for a, b in zip(mats, rhs)]
        q.flush()
        return [t.result() for t in tickets]

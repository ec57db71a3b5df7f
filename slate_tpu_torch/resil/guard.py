"""Guarded execution and fallback escalation (counterpart of
``slate_tpu/resil/guard.py``). Off by default and observable when it
acts:

* **Bounded retry with backoff** (:func:`retry`) around the operations
  that fail transiently: the batch queue's dispatches and the
  out-of-core streams' transfers (linalg/stream.py). The budget
  rides the tune subsystem: explicit
  argument > measured entry > FROZEN ``resil/max_retries`` /
  ``resil/backoff_us``. Retries engage only on failure, so the steady
  state is untouched; every retry publishes a ``resil::retry`` instant
  and counts ``resil.retries``.

* **Structured failures**: :class:`WorkerLost`,
  :class:`RetriesExhausted` (still transient, so a rung above can
  reroute) and :class:`PanelHealthError` (a panel failed the
  non-finite / growth sentinel).

* **The degradation ladder** (:data:`ESCALATIONS`): when a route fails
  transiently or a sentinel trips, a driver steps down to a slower but
  sturdier route (``rbt_to_getrf`` in gesv_rbt, ``mixed_to_full`` in
  the refinement loops here). Every step funnels through
  :func:`record_escalation`, which counts the rung's ``resil.*``
  counter and publishes a ``resil::fallback`` instant.

Only :data:`TRANSIENT_TYPES` are retried or escalated. A CUDA error, a
failed ``nvcc`` build or a kernel launch failure raises a plain
``RuntimeError`` and is never transient: it propagates, and is never
retried onto another route.

Panel sentinels (:func:`check_panel`) are gated on
:func:`enable_checks` because reading a panel's health is a host read
that waits for the panel.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from .faults import InjectedFault

#: the degradation ladder: rung -> the resil.* counter it increments
ESCALATIONS = {
    "shard_to_stream": "resil.fallback.shard_to_stream",
    "rbt_to_getrf": "resil.fallback.rbt_to_getrf",
    "mixed_to_full": "resil.fallback.mixed_to_full",
    # a stall detected by the obs/health.py watchdog (escalate=True)
    "watchdog_stall": "resil.fallback.watchdog_stall",
    # the serving daemon's admission ladder and the elastic mesh's
    # shrink-to-fit resume (ROADMAP queue 1, items 10-11)
    "shard_shrink": "resil.fallback.shard_shrink",
    "serve_shed": "resil.fallback.serve_shed",
    "serve_degrade": "resil.fallback.serve_degrade",
    "serve_reject": "resil.fallback.serve_reject",
}

#: growth-factor cap of the panel sentinel: |panel|_max may exceed
#: |input|_max by this factor before the panel is declared sick
#: (partial pivoting's worst case is 2^k, but a production stream at
#: 1e6x growth is numerically dead — the reference's gesv_rbt
#: breakdown regime)
GROWTH_CAP = 1.0e6


class ResilError(RuntimeError):
    """Base of the structured resilience failures."""


class WorkerLost(ResilError):
    """A coordinated mesh worker died (testing/multiproc.py reaps the
    rest and surfaces the dead worker's output tail here)."""

    def __init__(self, process_id: int, returncode: Optional[int],
                 tail: str = "", outs: Optional[list] = None) -> None:
        self.process_id = int(process_id)
        self.returncode = returncode
        self.tail = tail
        self.outs = outs or []
        super().__init__(
            "worker %d lost (rc=%s); last output:\n%s"
            % (process_id, returncode, tail[-2000:]))


class RetriesExhausted(ResilError):
    """The bounded retry budget ran out. Carries the site and the
    last failure; still transient, so escalation rungs above the
    retry layer can reroute instead of dying."""

    def __init__(self, site: str, attempts: int,
                 last: BaseException) -> None:
        self.site = site
        self.attempts = attempts
        self.last = last
        super().__init__("site %r failed %d attempt(s); last: %s"
                         % (site, attempts, last))


class PanelHealthError(ResilError):
    """A factored panel failed the non-finite / growth sentinel."""

    def __init__(self, op: str, panel: int, reason: str) -> None:
        self.op = op
        self.panel = panel
        self.reason = reason
        super().__init__("%s panel %d failed health check: %s"
                         % (op, panel, reason))


#: exception types the guard treats as transient (retry/escalate), the
#: reference's exactly. A CUDA error is a RuntimeError, never one.
TRANSIENT_TYPES = (InjectedFault, WorkerLost, RetriesExhausted,
                   TimeoutError, ConnectionError)


def is_transient(e: BaseException) -> bool:
    return isinstance(e, TRANSIENT_TYPES)


#: local mirrors of the resil.* counters (readable with the obs bus
#: off)
_lock = threading.Lock()
_counts: Dict[str, int] = {}


def _count(name: str, value: int = 1) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + value


def counts() -> Dict[str, int]:
    """Copy of the local retry/fallback/sentinel counters."""
    with _lock:
        return dict(_counts)


def reset_counts() -> None:
    with _lock:
        _counts.clear()


def _resolve_budget(retries: Optional[int], backoff_us: Optional[int]
                    ) -> tuple:
    from ..tune.select import resolve
    if retries is None:
        retries = int(resolve("resil", "max_retries"))
    if backoff_us is None:
        backoff_us = int(resolve("resil", "backoff_us"))
    return max(int(retries), 0), max(int(backoff_us), 0)


def retry(fn: Callable[[], Any], site: str,
          retries: Optional[int] = None,
          backoff_us: Optional[int] = None, **ctx) -> Any:
    """Run `fn` with up to `retries` re-attempts on TRANSIENT failure
    (exponential backoff: backoff_us * 2^attempt). Non-transient
    exceptions propagate immediately — the guard must never mask a
    logic bug as flakiness. Exhaustion raises :class:`RetriesExhausted`
    chained from the last failure."""
    retries, backoff_us = _resolve_budget(retries, backoff_us)
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:
            if not is_transient(e):
                raise
            last = e
            if attempt >= retries:
                break
            _count("resil.retries")
            _publish_retry(site, attempt, e, ctx)
            if backoff_us:
                time.sleep(backoff_us * (1 << attempt) / 1e6)
    raise RetriesExhausted(site, retries + 1, last) from last


def retry_after_failure(fn: Callable[[], Any], site: str,
                        first: BaseException, **ctx) -> Any:
    """Continuation for a TRANSIENT failure observed OUTSIDE the
    retry frame: a fast path (the queue's dispatch) tries ``fn()`` bare
    first and enters the guard only on failure; count and publish that
    failure like an in-loop attempt, then run the budget."""
    _count("resil.retries")
    _publish_retry(site, 0, first, ctx)
    return retry(fn, site, **ctx)


def _publish_retry(site: str, attempt: int, err: BaseException,
                   ctx: Dict[str, Any]) -> None:
    from ..obs import events as obs_events
    if not obs_events.enabled():
        return
    from ..obs import metrics as obs_metrics
    obs_metrics.inc("resil.retries")
    obs_events.instant("resil::retry", cat="resil", site=site,
                       attempt=attempt, error=str(err)[:120],
                       **{k: v for k, v in ctx.items()
                          if isinstance(v, (str, int, float, bool))})


def record_escalation(rung: str, **ctx) -> None:
    """THE escalation funnel: every ladder step increments its rung
    counter and the aggregate ``resil.fallbacks`` and publishes one obs
    instant."""
    counter = ESCALATIONS[rung]
    _count(counter)
    _count("resil.fallbacks")
    from ..obs import events as obs_events
    if not obs_events.enabled():
        return
    from ..obs import metrics as obs_metrics
    obs_metrics.inc(counter)
    obs_metrics.inc("resil.fallbacks")
    obs_events.instant("resil::fallback", cat="resil", rung=rung,
                       **{k: v for k, v in ctx.items()
                          if isinstance(v, (str, int, float, bool))})


def escalate(primary: Callable[[], Any], fallback: Callable[[], Any],
             rung: str, **ctx) -> Any:
    """Run `primary`; on a TRANSIENT failure, record the ladder step
    and run `fallback` instead. Non-transient failures propagate —
    a wrong answer must never be retried into a different route."""
    try:
        return primary()
    except Exception as e:
        if not is_transient(e):
            raise
        record_escalation(rung, error=str(e)[:120], **ctx)
        return fallback()


# -- panel sentinels ------------------------------------------------------

_checks_enabled = False


def enable_checks(flag: bool = True) -> None:
    """Turn the per-panel non-finite / growth sentinels on. Off by
    default: reading a panel's health is a host read that waits for
    it, and resil-off drivers add none."""
    global _checks_enabled
    _checks_enabled = bool(flag)


def checks_enabled() -> bool:
    return _checks_enabled


def check_panel(op: str, panel: int, arr, ref=None) -> None:
    """Sentinel for a just-factored panel: every entry finite, and
    max|panel| within GROWTH_CAP of max|ref| (the panel's input state)
    when `ref` is given. No-op unless :func:`enable_checks` ran.
    Violations publish ``resil::sentinel`` + ``resil.sentinels`` and
    raise :class:`PanelHealthError` naming the panel — the stream
    stops AT the sick panel instead of propagating NaNs through every
    trailing update."""
    if not _checks_enabled:
        return
    arr = torch.as_tensor(arr)
    finite = bool(torch.isfinite(arr).all())
    reason = None
    if not finite:
        reason = "non-finite entries"
    elif ref is not None:
        amax = float(arr.abs().max())
        rmax = float(torch.as_tensor(ref).abs().max())
        if amax > GROWTH_CAP * max(rmax, 1e-300):
            reason = "growth factor %.3g exceeds cap %.3g" \
                % (amax / max(rmax, 1e-300), GROWTH_CAP)
    if reason is None:
        return
    _count("resil.sentinels")
    from ..obs import events as obs_events
    if obs_events.enabled():
        from ..obs import metrics as obs_metrics
        obs_metrics.inc("resil.sentinels")
        obs_events.instant("resil::sentinel", cat="resil", op=op,
                           panel=panel, reason=reason)
    raise PanelHealthError(op, panel, reason)

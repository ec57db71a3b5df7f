"""Deterministic fault injection (counterpart of
``slate_tpu/resil/faults.py``).

A process-wide fault plan (seeded, occurrence-indexed, JSON) drives
injection points threaded through the layers that can fail:

  site          where it fires                      context keys
  ----          --------------                      ------------
  ``h2d``       StreamEngine uploads                buf, idx
  ``d2h``       StreamEngine writeback tasks        buf, idx
  ``ppermute``  dist/tree.py scheduled traversals   op, size
  ``step``      OOC driver panel-step loops         op, step, mine
  ``batch``     batch/queue.py dispatches           op
  ``batch_submit``  batch/queue.py submissions      op
  ``flusher``   batch/queue.py background flusher   busy
  ``worker``    testing/multiproc.py worker init    process
  ``serve_admit``  serve/server.py admission        tenant, op
  ``serve_cache``  serve/server.py factor cache     op
  ``serve_drain``  serve/server.py drain/shutdown   pending

The table mirrors the :data:`SITES` registry, which keeps every row of
the reference. Every site has its call site in the port: ``batch``,
``batch_submit``, ``flusher`` (batch/queue.py), ``h2d``, ``d2h``
(linalg/stream.py), ``step`` (linalg/ooc.py), ``ppermute``
(dist/tree.py), ``worker`` (testing/multiproc.py) and the ``serve_*``
sites (serve/server.py).

Plan JSON schema (one object; ``FaultPlan.to_json`` / ``from_json``)::

    {
      "seed": 0,                     # drives probabilistic rules
      "faults": [
        {
          "site":  "batch",          # injection site (table above)
          "match": {"op": "gesv", "host": 1},
                                     # every key must equal the call
                                     # context; "host" matches the
                                     # torch.distributed rank (0
                                     # without a process group);
                                     # omitted keys match anything
          "after": 0,                # skip the first `after` matches
          "times": 1,                # then fire on the next `times`
          "prob":  1.0,              # per-match firing probability,
                                     # hashed from (seed, rule,
                                     # occurrence)
          "kind":  "error"     # error | hang | nan | kill | slow
        }
      ]
    }

Kinds: ``error`` raises :class:`InjectedFault` (transient: the guard's
retry absorbs it); ``hang`` sleeps ``hang_s`` (default 30) and then
raises; ``nan`` returns ``"nan"`` to the call site, which poisons its
payload; ``kill`` calls ``os._exit(KILL_EXIT_CODE)``; ``slow`` sleeps
``slow_s`` (default 0.05) and lets the step proceed.

Determinism: a rule's occurrence counter increments once per matching
``check`` call under one lock, and a probabilistic rule hashes
``(seed, rule index, occurrence)`` with SHA-256, as the reference
does, so one plan and one seed fire at the same occurrences in both
packages. A subprocess picks a plan up from ``SLATE_RESIL_FAULTS``
(``install_env_var`` / ``install_from_env``). Every injection is
logged in the plan (``log()``) and, with the bus on, published as an
obs instant (cat ``resil``) and a ``resil.injected`` count.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: exit status of a `kill` injection — parents assert on it to tell a
#: planned death from a crash
KILL_EXIT_CODE = 17

#: environment variable carrying a serialized plan into subprocesses
ENV_VAR = "SLATE_RESIL_FAULTS"

_KINDS = ("error", "hang", "nan", "kill", "slow")

#: the fault-site schema: site name -> where it fires (the module
#: docstring's table); a rule naming anything else can never fire
SITES = {
    "h2d": "StreamEngine uploads (buf, idx)",
    "d2h": "StreamEngine writeback tasks (buf, idx)",
    "ppermute": "dist/tree.py scheduled traversals (op, size)",
    "step": "OOC driver panel-step loops (op, step; sharded loops "
            "add mine=<this host owns the panel> so straggler plans "
            "can scope their slowdown to owned work)",
    "batch": "batch/queue.py dispatches (op)",
    "batch_submit": "batch/queue.py submissions (op)",
    "flusher": "batch/queue.py background flusher (busy)",
    "worker": "testing/multiproc.py worker init (process)",
    "serve_admit": "serve/server.py admission decisions (tenant, op)",
    "serve_cache": "serve/server.py factor-cache lookups (op)",
    "serve_drain": "serve/server.py drain/shutdown (pending)",
}


class InjectedFault(RuntimeError):
    """A planned failure (kind ``error``/``hang``). Transient by
    construction — guard.retry absorbs it within the retry budget."""

    def __init__(self, site: str, rule: int, occurrence: int,
                 ctx: Dict[str, Any]) -> None:
        self.site = site
        self.rule = rule
        self.occurrence = occurrence
        self.ctx = dict(ctx)
        super().__init__(
            "injected fault at site %r (rule %d, occurrence %d, "
            "ctx %r)" % (site, rule, occurrence, ctx))


class FaultPlan:
    """The parsed plan + its replay state (occurrence counters and the
    injection log). State is per-install: re-installing the same plan
    resets the counters, which is what makes a replay start clean."""

    def __init__(self, faults: List[Dict[str, Any]],
                 seed: int = 0) -> None:
        self.seed = int(seed)
        self.rules: List[Dict[str, Any]] = []
        for i, f in enumerate(faults or []):
            kind = f.get("kind", "error")
            if kind not in _KINDS:
                raise ValueError("fault rule %d: unknown kind %r "
                                 "(have %s)" % (i, kind, list(_KINDS)))
            self.rules.append({
                "site": str(f["site"]),
                "match": dict(f.get("match", {})),
                "after": int(f.get("after", 0)),
                "times": int(f.get("times", 1)),
                "prob": float(f.get("prob", 1.0)),
                "kind": kind,
                "hang_s": float(f.get("hang_s", 30.0)),
                "slow_s": float(f.get("slow_s", 0.05)),
            })
        self._lock = threading.Lock()
        self._seen = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)
        self._log: List[Dict[str, Any]] = []

    # -- serialization ----------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "faults": self.rules},
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        raw = json.loads(text)
        return cls(raw.get("faults", []), seed=raw.get("seed", 0))

    # -- matching ---------------------------------------------------

    @staticmethod
    def _host() -> int:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
        return 0

    def _matches(self, rule: Dict[str, Any], site: str,
                 ctx: Dict[str, Any]) -> bool:
        if rule["site"] != site:
            return False
        for key, want in rule["match"].items():
            have = self._host() if key == "host" else ctx.get(key)
            if have != want:
                return False
        return True

    def _roll(self, rule_idx: int, occurrence: int) -> float:
        """Deterministic per-(rule, occurrence) uniform in [0, 1):
        a hash, not an RNG stream, so thread timing cannot reorder
        the draws."""
        h = hashlib.sha256(("%d:%d:%d" % (self.seed, rule_idx,
                                          occurrence)).encode())
        return int.from_bytes(h.digest()[:8], "big") / 2.0 ** 64

    def _check(self, site: str, ctx: Dict[str, Any]) -> Optional[str]:
        action = None
        for i, rule in enumerate(self.rules):
            if not self._matches(rule, site, ctx):
                continue
            with self._lock:
                occ = self._seen[i]
                self._seen[i] += 1
                live = rule["after"] <= occ < rule["after"] \
                    + rule["times"]
                fire = live and (rule["prob"] >= 1.0
                                 or self._roll(i, occ) < rule["prob"])
                if fire:
                    self._fired[i] += 1
                    self._log.append({"site": site, "rule": i,
                                      "occurrence": occ,
                                      "kind": rule["kind"],
                                      "ctx": dict(ctx)})
            if not fire:
                continue
            _publish(site, i, occ, rule["kind"], ctx)
            if rule["kind"] == "kill":
                os._exit(KILL_EXIT_CODE)
            if rule["kind"] == "nan":
                action = "nan"
                continue
            if rule["kind"] == "slow":
                # a deterministic straggler: stall the matched step by
                # slow_s and continue (no exception, no retry)
                time.sleep(rule["slow_s"])
                continue
            if rule["kind"] == "hang":
                time.sleep(rule["hang_s"])
            raise InjectedFault(site, i, occ, ctx)
        return action

    # -- replay evidence --------------------------------------------

    def log(self) -> List[Dict[str, Any]]:
        """Copy of the injection log — the replay-determinism pin
        compares two runs' logs for equality."""
        with self._lock:
            return [dict(r) for r in self._log]

    def fired(self) -> int:
        with self._lock:
            return sum(self._fired)


def _publish(site: str, rule: int, occ: int, kind: str,
             ctx: Dict[str, Any]) -> None:
    from ..obs import events as obs_events
    if not obs_events.enabled():
        return
    from ..obs import metrics as obs_metrics
    obs_metrics.inc("resil.injected")
    obs_events.instant("resil::inject", cat="resil", site=site,
                       rule=rule, occurrence=occ, kind=kind,
                       **{k: v for k, v in ctx.items()
                          if isinstance(v, (str, int, float, bool))})


#: the process-wide active plan; None = injection entirely off (the
#: default — check() is then one attribute load and a compare)
_PLAN: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Activate `plan` process-wide (None clears). Returns it."""
    global _PLAN
    _PLAN = plan
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _PLAN


def check(site: str, **ctx) -> Optional[str]:
    """The injection point: no-op (None) without a plan; with one,
    evaluates the rules — possibly raising, sleeping, or exiting per
    the matched rule's kind — and returns ``"nan"`` when a corruption
    rule fired (the call site poisons its payload)."""
    plan = _PLAN
    if plan is None:
        return None
    return plan._check(site, dict(ctx))


def install_env_var(plan: FaultPlan,
                    env: Optional[Dict[str, str]] = None
                    ) -> Dict[str, str]:
    """Serialize `plan` into an environment mapping for a subprocess."""
    env = dict(env or {})
    env[ENV_VAR] = plan.to_json()
    return env


def install_from_env() -> Optional[FaultPlan]:
    """Install the plan carried by ``SLATE_RESIL_FAULTS``, if any."""
    text = os.environ.get(ENV_VAR)
    if not text:
        return None
    return install(FaultPlan.from_json(text))

"""Analyzer: the flight-recorder contract (SL601/SL602/SL603).

The ledger/watchdog layer only attributes correctly when three
cross-file agreements hold, none of which any single call site can
see:

  SL601  every OOC step-loop driver publishes a heartbeat: a
         module-level function in linalg/ooc.py or dist/shard_ooc.py
         whose name ends ``_ooc``, carries @instrument_driver, and
         contains a ``for`` loop must call ``heartbeat(...)``
         somewhere in its body — a loop without one is invisible to
         the stall watchdog (obs/health.py), which is exactly the
         silent-wedge class the watchdog exists to kill.
  SL602  ledger phase-name literals are a CLOSED set: every string
         literal passed to ``frame(...)``/``credit(...)`` (and every
         key of a ``phases={...}`` dict literal in an
         ``append(..., phases=...)`` call) must be in
         obs/ledger.py's ``PHASES`` tuple — a typo'd phase is a
         silently-empty attribution column, the SL401 failure mode
         carried to the ledger.
  SL603  the off-state contract ships: FROZEN rows
         ``("obs", "ledger")`` and ``("obs", "watchdog")`` exist in
         tune/cache.py, and obs/health.py publishes the
         ``health::stall`` instant + ``health.stalls`` counter the
         report reads back.
"""

from __future__ import annotations

import ast
import os
from typing import List

from . import astutil
from .core import Finding, PKG, pkg_path, register

LEDGER_PATH = pkg_path("obs/ledger.py")
HEALTH_PATH = pkg_path("obs/health.py")
TUNE_CACHE_PATH = pkg_path("tune/cache.py")
STEP_LOOP_PATHS = (pkg_path("linalg/ooc.py"),
                   pkg_path("dist/shard_ooc.py"))
FROZEN_ROWS = (("obs", "ledger"), ("obs", "watchdog"))
HEALTH_LITERALS = ("health::stall", "health.stalls")


def _has_instrument(node) -> bool:
    for dec in node.decorator_list:
        if isinstance(dec, ast.Call) \
                and isinstance(dec.func, ast.Name) \
                and dec.func.id == "instrument_driver":
            return True
    return False


def _phase_literal_sites(tree):
    """(literal, line) for every phase name passed to frame()/
    credit() or listed in an append(phases={...}) dict literal."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if name in ("frame", "credit") and node.args:
            s = astutil.const_str(node.args[0])
            if s is not None:
                yield s, node.lineno
        elif name == "append":
            for kw in node.keywords:
                if kw.arg == "phases" and isinstance(kw.value,
                                                    ast.Dict):
                    for k in kw.value.keys:
                        s = astutil.const_str(k)
                        if s is not None:
                            yield s, k.lineno


@register("flight-recorder", ("SL601", "SL602", "SL603"),
          "every OOC step loop heartbeats the watchdog; ledger phase "
          "literals are closed-set; FROZEN obs/ledger + obs/watchdog "
          "rows and the health literals ship")
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []

    # SL602 needs the authoritative phase set first
    lpath = os.path.join(repo, LEDGER_PATH)
    phases = astutil.assigned_literal(lpath, "PHASES")
    if not isinstance(phases, tuple) or not phases:
        findings.append(Finding(
            "SL603", LEDGER_PATH, 0,
            "PHASES literal missing or not a plain tuple — the "
            "closed phase set is the attribution vocabulary"))
        phases = ()
    phase_set = set(phases)

    for rel in STEP_LOOP_PATHS:
        path = os.path.join(repo, rel)
        tree = astutil.parse(path)
        if tree is None:
            findings.append(Finding("SL601", rel, 0, "file missing"))
            continue
        # SL601: heartbeat coverage of the step-loop drivers
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not node.name.endswith("_ooc") \
                    or not _has_instrument(node):
                continue
            has_loop = any(isinstance(sub, (ast.For, ast.AsyncFor))
                           for sub in ast.walk(node))
            if not has_loop:
                continue
            if "heartbeat" not in astutil.calls_in(node):
                findings.append(Finding(
                    "SL601", rel, node.lineno,
                    "step-loop driver %r publishes no heartbeat — "
                    "a wedged step is invisible to the stall "
                    "watchdog (obs/health.py)" % node.name))
        # SL602: closed-set phase literals (ledger publishers live in
        # these files plus stream.py/queue.py — scan the whole pkg
        # below instead of per-file here)
    pkg = os.path.join(repo, PKG)
    if phase_set:
        for path in astutil.py_files(pkg):
            tree = astutil.parse(path)
            if tree is None:
                continue
            rel = astutil.rel(repo, path)
            for lit, line in _phase_literal_sites(tree):
                if lit not in phase_set:
                    findings.append(Finding(
                        "SL602", rel, line,
                        "ledger phase literal %r is not in "
                        "obs/ledger.PHASES %r — a typo'd phase is a "
                        "silently-empty attribution column"
                        % (lit, tuple(sorted(phase_set)))))

    # SL603: frozen rows + health literals
    tpath = os.path.join(repo, TUNE_CACHE_PATH)
    keys = astutil.frozen_keys(tpath)
    for row in FROZEN_ROWS:
        if row not in keys:
            findings.append(Finding(
                "SL603", TUNE_CACHE_PATH, 0,
                "FROZEN row %r missing — the recorder/watchdog "
                "off-state default must ship in the tune table"
                % (row,)))
    hpath = os.path.join(repo, HEALTH_PATH)
    htree = astutil.parse(hpath)
    if htree is None:
        findings.append(Finding("SL603", HEALTH_PATH, 0,
                                "file missing"))
    else:
        consts = astutil.str_consts(htree)
        for lit in HEALTH_LITERALS:
            if lit not in consts:
                findings.append(Finding(
                    "SL603", HEALTH_PATH, 0,
                    "watchdog literal %r is not published — the "
                    "stall report keys on it" % lit))
    return findings

"""Analyzer: the fused-visit-sweep contract (SL1001/SL1002/SL1003).

The fused update route only attributes, faults, and demotes
correctly when three cross-file agreements hold — none visible from
any single call site:

  SL1001 the ``fused_update`` node kind is REGISTERED with its
         contract: present in ``sched/graph.NODE_KINDS``, mapped to
         the ``"update"`` ledger phase in ``PHASE_OF_KIND`` (a fused
         node credits the update column ONCE — any other phase
         splits the attribution), and mapped to ``None`` in
         ``FAULT_SITE_OF_KIND`` (the members' per-panel ``step``
         checks fire INSIDE the node closure; a site of its own
         would double-inject).
  SL1002 the arbitration ships: the FROZEN ``("ooc", "visit_fuse")``
         row exists in tune/cache.py AND at least one literal
         ``("ooc", "visit_fuse")`` key read exists in the package
         (the MethodVisitFuse.resolve route) — a row without its
         reader keeps shipping a default nobody consults.
  SL1003 precision discipline of the fused kernels. The reference
         gives each fused kernel a ``*_mx`` twin; the port gives each
         one body for both precisions that takes the lo dtype as its
         ``lo`` parameter (None is the full path). So every
         ``_fused_sweep_*`` / ``*_visit_fused`` def takes ``lo``, and
         every call of the fused route passes it on: each call of a
         fused def anywhere in the package, and each call inside the
         route (the fused defs and the helpers of their module they
         reach) to a helper of that module that takes ``lo``. A call
         that drops ``lo`` (or passes a literal None) silently runs
         the full-precision update on a bf16 stream — the failure a
         missing ``_mx`` twin is in the reference.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional

from . import astutil
from .core import Finding, PKG, pkg_path, register

GRAPH_PATH = pkg_path("sched/graph.py")
TUNE_CACHE_PATH = pkg_path("tune/cache.py")
FUSE_ROW = ("ooc", "visit_fuse")
FUSED_KIND = "fused_update"
#: the precision parameter of the fused route
LO = "lo"
_FUSED_DEF = re.compile(r"(^_fused_sweep_\w+$)|(^_\w+_visit_fused$)")


def _lo_index(fn: ast.FunctionDef) -> Optional[int]:
    """Position of `fn`'s ``lo`` parameter (-1 when keyword-only),
    None when it has none."""
    pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if LO in pos:
        return pos.index(LO)
    if LO in [a.arg for a in fn.args.kwonlyargs]:
        return -1
    return None


def _passes_lo(call: ast.Call, idx: int) -> bool:
    """Whether `call` hands a value other than a literal None to the
    ``lo`` parameter at position `idx` (an unpacked ``*args`` /
    ``**kwargs`` is given the benefit of the doubt)."""
    for kw in call.keywords:
        if kw.arg is None:
            return True
        if kw.arg == LO:
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is None)
    if any(isinstance(a, ast.Starred) for a in call.args):
        return True
    if 0 <= idx < len(call.args):
        a = call.args[idx]
        return not (isinstance(a, ast.Constant) and a.value is None)
    return False


def _route_findings(rel: str, tree) -> List[Finding]:
    """SL1003 inside one module: the fused defs take ``lo``, and every
    call of the route to a ``lo``-taking helper of the module passes
    it."""
    out: List[Finding] = []
    defs: Dict[str, ast.FunctionDef] = {
        n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    fused = sorted(n for n in defs if _FUSED_DEF.match(n))
    for name in fused:
        if _lo_index(defs[name]) is None:
            out.append(Finding(
                "SL1003", rel, defs[name].lineno,
                "fused kernel %r takes no `%s` parameter — the fused "
                "route cannot carry the stream's precision, so a bf16 "
                "run silently takes the full-precision update"
                % (name, LO)))
    route, todo = set(fused), list(fused)
    while todo:
        fn = defs[todo.pop()]
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Name)):
                continue
            callee = defs.get(call.func.id)
            if callee is None or callee is fn \
                    or _FUSED_DEF.match(callee.name):
                continue      # a fused callee: _fused_call_findings
            idx = _lo_index(callee)
            if idx is None:
                continue
            if not _passes_lo(call, idx):
                out.append(Finding(
                    "SL1003", rel, call.lineno,
                    "%s() calls %s() without its `%s` — the fused "
                    "route drops the precision here and runs this "
                    "step at full precision on a bf16 stream"
                    % (fn.name, callee.name, LO)))
            if callee.name not in route:
                route.add(callee.name)
                todo.append(callee.name)
    return out


def _fused_call_findings(rel: str, tree, lo_idx: Dict[str, int]
                         ) -> List[Finding]:
    """SL1003 at the call sites of the fused defs, in any module."""
    out: List[Finding] = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        name = astutil.call_name(call)
        if name not in lo_idx or _passes_lo(call, lo_idx[name]):
            continue
        out.append(Finding(
            "SL1003", rel, call.lineno,
            "call of fused kernel %r drops `%s` — the fused update "
            "runs at full precision on a bf16 stream" % (name, LO)))
    return out


@register("visit-fuse", ("SL1001", "SL1002", "SL1003"),
          "fused_update kind registered with update-phase/no-site "
          "contract; FROZEN ooc/visit_fuse row ships with a literal "
          "reader; the fused route carries the precision (`lo`)")
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []

    # SL1001: kind tables carry the fused contract
    gpath = os.path.join(repo, GRAPH_PATH)
    kinds = astutil.assigned_literal(gpath, "NODE_KINDS")
    if not (isinstance(kinds, tuple) and FUSED_KIND in kinds):
        findings.append(Finding(
            "SL1001", GRAPH_PATH, 0,
            "node kind %r missing from NODE_KINDS — the fused sweep "
            "cannot be issued" % FUSED_KIND))
    phase_of = astutil.assigned_literal(gpath, "PHASE_OF_KIND")
    if not (isinstance(phase_of, dict)
            and phase_of.get(FUSED_KIND) == "update"):
        findings.append(Finding(
            "SL1001", GRAPH_PATH, 0,
            "PHASE_OF_KIND[%r] must be 'update' — a fused node "
            "credits the update attribution column exactly once"
            % FUSED_KIND))
    site_of = astutil.assigned_literal(gpath, "FAULT_SITE_OF_KIND")
    if not (isinstance(site_of, dict) and FUSED_KIND in site_of
            and site_of[FUSED_KIND] is None):
        findings.append(Finding(
            "SL1001", GRAPH_PATH, 0,
            "FAULT_SITE_OF_KIND[%r] must be None — the members' "
            "per-panel step checks fire inside the node closure; a "
            "site of its own would double-inject" % FUSED_KIND))

    # SL1002: the FROZEN row plus a literal reader
    tpath = os.path.join(repo, TUNE_CACHE_PATH)
    if FUSE_ROW not in astutil.frozen_keys(tpath):
        findings.append(Finding(
            "SL1002", TUNE_CACHE_PATH, 0,
            "FROZEN row %r missing — the visit-fuse cold route must "
            "ship in the tune table" % (FUSE_ROW,)))
    pkg = os.path.join(repo, PKG)
    if astutil.unread_rows(pkg, (FUSE_ROW,)):
        findings.append(Finding(
            "SL1002", TUNE_CACHE_PATH, 0,
            "no literal %r key read anywhere in %s/ — the FROZEN "
            "visit-fuse row has no reader, so the arbitration is dead"
            % (FUSE_ROW, PKG)))

    # SL1003: the fused route carries `lo`
    trees = []
    for path in astutil.py_files(pkg):
        tree = astutil.parse(path)
        if tree is not None:
            trees.append((astutil.rel(repo, path), tree))
    lo_idx: Dict[str, int] = {}
    for rel, tree in trees:
        findings.extend(_route_findings(rel, tree))
        for n in tree.body:
            if isinstance(n, ast.FunctionDef) and _FUSED_DEF.match(n.name):
                idx = _lo_index(n)
                if idx is not None:
                    lo_idx[n.name] = idx
    for rel, tree in trees:
        findings.extend(_fused_call_findings(rel, tree, lo_idx))
    return findings

"""Analyzer: fault-site coverage (SL501/SL502/SL503).

The resil fault plans (resil/faults.py) are matched by SITE NAME
string at runtime: a plan rule ``{"site": "h2d", ...}`` fires only
where some live code path calls ``faults.check("h2d", ...)`` (or
``_guard_transfer("h2d", ...)``, which forwards its site). Nothing
validates the names: a rule naming a site that no code checks NEVER
fires — the test that injected it silently tests nothing — and a
``check()`` call site absent from the schema is an injection point
no documented plan can target.

The machine-readable schema is the ``SITES`` dict literal in
resil/faults.py (site -> short description), which the module
docstring's table mirrors.

  SL501  a SITES entry has no live ``check(site)``/
         ``_guard_transfer(site)`` call anywhere in the package —
         dead schema: plans naming it never fire.
  SL502  a live site literal is not in SITES — an injection point
         shipping outside the plan schema.
  SL503  a plan-rule site literal (a ``{"site": X, ...}`` dict) names
         a site not in SITES. Plans are scanned where the port's live:
         the package, its tests (``tests/test_torch_*.py``),
         ``chip_smoke.py`` and ``examples/torch/`` — not the JAX
         package's tests, whose plans name the reference's SITES.
"""

from __future__ import annotations

import ast
import glob
import os
from typing import Dict, List, Tuple

from . import astutil
from .core import Finding, PKG, pkg_path, register

FAULTS_PATH = pkg_path("resil/faults.py")

#: where plan-rule dict literals live (site consumers): directories,
#: files, or glob patterns, relative to the repo
PLAN_SCAN = (PKG, "tests/test_torch_*.py", "chip_smoke.py",
             "examples/torch")


def _live_sites(repo: str) -> Dict[str, List[Tuple[str, int]]]:
    """site -> [(rel, line)] of every ``check("site", ...)`` and
    ``_guard_transfer("site", ...)`` call in the package. A ``check``
    call counts when its receiver names the faults module
    (``_faults.check`` / ``_rfaults.check``) or when it is a bare
    name the module imported from resil.faults — a generic
    ``.check()`` on some other object is not an injection point."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    pkg = os.path.join(repo, PKG)
    for path in astutil.py_files(pkg):
        tree = astutil.parse(path)
        if tree is None:
            continue
        rel = astutil.rel(repo, path)
        # names bound by `from ...faults import check [as alias]`
        bare_checks = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.split(".")[-1] == "faults":
                for a in node.names:
                    if a.name == "check":
                        bare_checks.add(a.asname or a.name)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            name = astutil.call_name(node)
            site = astutil.const_str(node.args[0])
            if site is None:
                continue
            if name == "_guard_transfer":
                out.setdefault(site, []).append((rel, node.lineno))
            elif name == "check" or name in bare_checks:
                f = node.func
                hit = (isinstance(f, ast.Attribute)
                       and isinstance(f.value, ast.Name)
                       and "fault" in f.value.id.lower()) \
                    or (isinstance(f, ast.Name)
                        and f.id in bare_checks)
                if hit:
                    out.setdefault(site, []).append((rel, node.lineno))
    return out


def _plan_sites(repo: str) -> List[Tuple[str, str, int]]:
    """(site, rel, line) for every ``{"site": <const>, ...}`` dict
    literal in the scanned trees — fault-plan rules in drivers,
    tests, the chip smoke and the examples."""
    out: List[Tuple[str, str, int]] = []
    paths: List[str] = []
    for sub in PLAN_SCAN:
        for p in sorted(glob.glob(os.path.join(repo, sub))):
            if os.path.isfile(p):
                paths.append(p)
            elif os.path.isdir(p):
                paths.extend(astutil.py_files(p))
    for path in paths:
        tree = astutil.parse(path)
        if tree is None:
            continue
        rel = astutil.rel(repo, path)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if astutil.const_str(k) == "site":
                    site = astutil.const_str(v)
                    if site is not None:
                        out.append((site, rel, node.lineno))
    return out


@register("fault-sites", ("SL501", "SL502", "SL503"),
          "every schema site has a live check() call, every live "
          "site is in the schema, every plan rule names a real site")
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []
    fpath = os.path.join(repo, FAULTS_PATH)
    sites = astutil.assigned_literal(fpath, "SITES")
    if not isinstance(sites, dict) or not sites:
        return [Finding(
            "SL501", FAULTS_PATH, 0,
            "SITES schema literal missing or not a plain dict — the "
            "fault-plan site names have no machine-readable registry")]
    live = _live_sites(repo)
    for site in sorted(sites):
        if site not in live:
            findings.append(Finding(
                "SL501", FAULTS_PATH, 0,
                "schema site %r has no live faults.check()/"
                "_guard_transfer() call site in %s/ — plans naming "
                "it can never fire" % (site, PKG)))
    for site, occurrences in sorted(live.items()):
        if site not in sites:
            rel, line = occurrences[0]
            findings.append(Finding(
                "SL502", rel, line,
                "injection site %r is checked here but absent from "
                "the SITES schema in %s — undocumented sites are "
                "untargetable by reviewed plans" % (site, FAULTS_PATH)))
    for site, rel, line in _plan_sites(repo):
        if site not in sites:
            findings.append(Finding(
                "SL503", rel, line,
                "fault-plan rule names site %r, which is not in the "
                "SITES schema (%s) — the rule can never fire, so the "
                "test silently covers nothing" % (site, FAULTS_PATH)))
    return findings

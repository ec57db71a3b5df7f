"""Analyzer: obs literal integrity (SL401/SL402).

Every counter/histogram/gauge/span/instant series in the codebase is
born from a string literal at its publish site — ``inc("ooc.h2d_
bytes", ...)``, ``span("shard::bcast_wait")`` — and read back by
name in the report, chip_smoke.py and the tests. A one-off typo
(``batch.dispatchs``) creates a silently-EMPTY series: the publisher
feeds the typo, the reader sees zeros, and a measurement then shows
an improvement that is actually a dead counter. The
near-miss check makes that class of drift a lint failure instead of
a wrong conclusion.

  SL401  two distinct published names of the same kind are a
         near-miss pair: Levenshtein distance 1, or identical after
         separator normalization (``.``/``_``/``::``/``-`` treated
         equal). Different kinds (a counter vs an instant) may
         legitimately share stems (``resil.fallbacks`` /
         ``resil::fallback``) and are not compared.
  SL402  docs/OBS_REFERENCE_TORCH.md does not match the generated
         registry (regenerate with
         ``python -m tools.slate_lint_torch --obs-doc``). The
         reference package keeps its own docs/OBS_REFERENCE.md.

Dynamic names (``"ooc.%s_invalidations" % cause``) are collected as
``*`` wildcard patterns: they appear in the reference doc and are
near-miss-compared against each other, but never against static
names (a pattern legitimately brackets many concrete series).
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Tuple

from . import astutil
from .core import Finding, PKG, register

DOC_PATH = "docs/OBS_REFERENCE_TORCH.md"

#: publisher call name -> series kind
WRITERS = {
    "inc": "counter",
    "flag_concrete": "counter",
    "counter": "counter",          # events.counter(): a counter track
    "observe": "histogram",
    "observe_concrete": "histogram",
    "set_gauge": "gauge",
    "span": "span",
    "span_begin": "span",          # events.span_begin(): a hot-path span
    "instant": "instant",
    "sample": "series",            # obs/series.py time-series samples
}

KIND_ORDER = ("counter", "histogram", "gauge", "span", "instant",
              "series")
KIND_TITLES = {"counter": "Counters", "histogram": "Histograms",
               "gauge": "Gauges", "span": "Spans",
               "instant": "Instants", "series": "Series"}

_SEPS = str.maketrans("", "", "._:-")


def _normalize(name: str) -> str:
    return name.translate(_SEPS)


class Entry:
    __slots__ = ("kind", "name", "static", "sites")

    def __init__(self, kind, name, static):
        self.kind, self.name, self.static = kind, name, static
        self.sites: List[Tuple[str, int]] = []   # (rel, line)


def collect(repo: str) -> Dict[Tuple[str, str], Entry]:
    """(kind, name) -> Entry for every publish literal/pattern in
    the package (plus obs/metrics.py's direct ``_counters[...]``
    literal writes, under the registry lock)."""
    out: Dict[Tuple[str, str], Entry] = {}

    def add(kind, name, static, rel, line):
        e = out.get((kind, name))
        if e is None:
            e = out[(kind, name)] = Entry(kind, name, static)
        e.sites.append((rel, line))

    pkg = os.path.join(repo, PKG)
    for path in astutil.py_files(pkg):
        tree = astutil.parse(path)
        if tree is None:
            continue
        rel = astutil.rel(repo, path)
        is_metrics = rel.endswith("obs/metrics.py")
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and node.args:
                kind = WRITERS.get(astutil.call_name(node))
                if kind is not None:
                    pat = astutil.name_pattern(node.args[0])
                    if pat is not None:
                        add(kind, pat[0], pat[1], rel, node.lineno)
            elif is_metrics and isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "_counters":
                        pat = astutil.name_pattern(t.slice)
                        if pat is not None:
                            add("counter", pat[0], pat[1], rel,
                                node.lineno)
    return out


def generate_reference(repo: str) -> str:
    """The markdown registry DOC_PATH must equal."""
    entries = collect(repo)
    lines = [
        "# Observability series reference (PyTorch port)",
        "",
        "Every counter / histogram / gauge / span / instant / series",
        "name published in `%s/`, with the modules that" % PKG,
        "publish it. Names containing `*` are dynamic patterns (the",
        "publisher formats a runtime value into the series name).",
        "The JAX package's series are in `docs/OBS_REFERENCE.md`.",
        "",
        "GENERATED FILE — regenerate with",
        "`python -m tools.slate_lint_torch --obs-doc` after adding or",
        "renaming a series; lint rule SL402",
        "(tools/slate_lint_torch/obs_literals.py) fails when this",
        "file drifts from the publish sites.",
    ]
    for kind in KIND_ORDER:
        es = [e for (k, _n), e in sorted(entries.items())
              if k == kind]
        if not es:
            continue
        lines += ["", "## %s" % KIND_TITLES[kind], "",
                  "| series | published by |", "|---|---|"]
        for e in es:
            mods = sorted({rel for rel, _l in e.sites})
            lines.append("| `%s` | %s |"
                         % (e.name,
                            ", ".join("`%s`" % m for m in mods)))
    return "\n".join(lines) + "\n"


@register("obs-literals", ("SL401", "SL402"),
          "no near-miss series names (typo'd literals make silently-"
          "empty series); %s matches the generated registry"
          % DOC_PATH)
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []
    entries = collect(repo)
    by_kind: Dict[str, List[Entry]] = {}
    for (kind, _name), e in sorted(entries.items()):
        by_kind.setdefault(kind, []).append(e)
    for kind, es in sorted(by_kind.items()):
        for i, a in enumerate(es):
            for b in es[i + 1:]:
                if a.static != b.static:
                    continue     # a pattern brackets many names
                near = astutil.levenshtein(a.name, b.name, cap=1) == 1 \
                    or (_normalize(a.name) == _normalize(b.name))
                if near:
                    rel, line = b.sites[0]
                    findings.append(Finding(
                        "SL401", rel, line,
                        "obs %s literal %r is a near-miss of %r "
                        "(published at %s:%d) — a one-off typo makes "
                        "a silently-empty series; unify the names"
                        % (kind, b.name, a.name, a.sites[0][0],
                           a.sites[0][1])))
    doc = os.path.join(repo, DOC_PATH)
    want = generate_reference(repo)
    have = astutil.source(doc)
    if not have:
        findings.append(Finding(
            "SL402", DOC_PATH, 0,
            "missing — generate it with `python -m "
            "tools.slate_lint_torch --obs-doc`"))
    elif have != want:
        findings.append(Finding(
            "SL402", DOC_PATH, 0,
            "stale — the checked-in registry no longer matches the "
            "publish sites; regenerate with `python -m "
            "tools.slate_lint_torch --obs-doc`"))
    return findings

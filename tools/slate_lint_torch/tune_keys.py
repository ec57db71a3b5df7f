"""Analyzer: tune-arbitration integrity (SL201/SL202/SL203).

The tune subsystem's contract is cross-file: a driver reads a knob by
``(op, param)`` string key (tune/select.resolve, tuned_int,
frozen_default, get_option_tuned) and the shipped default lives as a
FROZEN row in tune/cache.py. NOTHING ties the two ends together at
runtime — a typo'd key silently resolves to the caller's fallback (or
None), and a FROZEN row whose reader was refactored away keeps
shipping a default nobody consults.

  SL201  a tune key read somewhere in the package has no matching
         FROZEN row — exact ``(op, param)``, the ``("*", param)``
         wildcard row, or (for a dynamic op like
         ``resolve(op, "chain")``) any row with that param.
  SL202  a FROZEN row is never read anywhere (orphan row): no reader
         names its (op, param), nor param under a dynamic op, nor
         (for "*" rows) the param under any op.
  SL203  a ``str2method``/``tuned_method`` family literal is not a
         key of core/methods.str2method's family map (an unknown
         family raises KeyError at runtime, which the resolvers
         swallow into the frozen route — i.e. the typo'd entry is
         silently dead).

``tuned_method`` keys (``method_<family>``) are written only by
probes and deliberately have no FROZEN rows (tune/cache.py doc), so
they are exempt from SL201; their *family* strings are checked.

A FROZEN row the port keeps as a mirror of the reference's table
while its reader is absent by design carries an SL202 exemption at
the row, naming the departure.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Set, Tuple

from . import astutil
from .core import Finding, PKG, pkg_path, register

TUNE_CACHE_PATH = pkg_path("tune/cache.py")
OPTIONS_PATH = pkg_path("core/options.py")
METHODS_PATH = pkg_path("core/methods.py")

#: files whose generic plumbing reads keys through variables (the
#: framework itself) — scanning them would only yield dynamic reads
EXCLUDE = (TUNE_CACHE_PATH, pkg_path("tune/select.py"))

#: call names whose (args[0], args[1]) are an (op, param) key read
KEY_READERS = ("resolve", "_resolve", "tuned_int", "frozen_default",
               "get_param")


def _tune_param_map(repo: str) -> Dict[str, str]:
    """Option attr name -> tune param (core/options._TUNE_PARAM),
    parsed structurally: keys are ``Option.X`` attributes, values
    string constants."""
    tree = astutil.parse(os.path.join(repo, OPTIONS_PATH))
    if tree is None:
        return {}
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name) and t.id == "_TUNE_PARAM"
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Attribute) \
                        and astutil.const_str(v) is not None:
                    out[k.attr] = v.value
            return out
    return {}


def _method_families(repo: str) -> Set[str]:
    """Keys of the ``fam`` dict literal inside methods.str2method."""
    tree = astutil.parse(os.path.join(repo, METHODS_PATH))
    if tree is None:
        return set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) \
                and node.name == "str2method":
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "fam"
                                for t in sub.targets)):
                    continue
                val = sub.value
                # the live shape is `fam = {...}[family]` — unwrap
                # the immediate subscript to the dict literal
                if isinstance(val, ast.Subscript):
                    val = val.value
                if isinstance(val, ast.Dict):
                    return {astutil.const_str(k) for k in val.keys
                            if astutil.const_str(k) is not None}
    return set()


class _Read:
    """One static key read: op/param may be None when that position
    is a runtime value (dynamic)."""

    __slots__ = ("op", "param", "rel", "line")

    def __init__(self, op, param, rel, line):
        self.op, self.param, self.rel, self.line = op, param, rel, line


def _collect(repo: str, tune_param: Dict[str, str]):
    """(key reads, family reads) across the package."""
    reads: List[_Read] = []
    fams: List[Tuple[str, str, int]] = []   # (family, rel, line)
    pkg = os.path.join(repo, PKG)
    for path in astutil.py_files(pkg):
        rel = astutil.rel(repo, path)
        if rel in EXCLUDE:
            continue
        tree = astutil.parse(path)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            if name in KEY_READERS and len(node.args) >= 2:
                op = astutil.const_str(node.args[0])
                param = astutil.const_str(node.args[1])
                if op is not None or param is not None:
                    reads.append(_Read(op, param, rel, node.lineno))
            elif name == "get_option_tuned" and len(node.args) >= 3:
                # (opts, Option.X, op, ...) -> (op, _TUNE_PARAM[X])
                key = node.args[1]
                if isinstance(key, ast.Attribute):
                    param = tune_param.get(key.attr)
                    if param is not None:
                        op = astutil.const_str(node.args[2])
                        reads.append(_Read(op, param, rel, node.lineno))
            elif name == "tuned_method" and len(node.args) >= 2:
                fam = astutil.const_str(node.args[1])
                if fam is not None:
                    fams.append((fam, rel, node.lineno))
            elif name == "str2method" and node.args:
                fam = astutil.const_str(node.args[0])
                if fam is not None:
                    fams.append((fam, rel, node.lineno))
    return reads, fams


@register("tune-keys", ("SL201", "SL202", "SL203"),
          "every tune key read has a FROZEN row, every FROZEN row is "
          "read somewhere, every method-family literal exists")
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []
    tpath = os.path.join(repo, TUNE_CACHE_PATH)
    frozen = astutil.frozen_keys(tpath)
    row_lines = astutil.frozen_row_lines(tpath)
    reads, fams = _collect(repo, _tune_param_map(repo))

    params_frozen = {p for (_o, p) in frozen}
    ops_frozen = {o for (o, _p) in frozen}

    # SL201: reads with no matching row
    for r in reads:
        if r.op is not None and r.param is not None:
            ok = (r.op, r.param) in frozen \
                or ("*", r.param) in frozen
        elif r.param is not None:        # dynamic op
            ok = r.param in params_frozen
        else:                            # dynamic param, known op
            ok = r.op in ops_frozen or r.op == "*"
        if not ok:
            key = (r.op or "<dynamic>", r.param or "<dynamic>")
            findings.append(Finding(
                "SL201", r.rel, r.line,
                "tune key (%r, %r) is read here but has no FROZEN "
                "row in %s — typo'd key, or a knob shipping without "
                "a default" % (key[0], key[1], TUNE_CACHE_PATH)))

    # SL202: orphan FROZEN rows
    read_exact = {(r.op, r.param) for r in reads
                  if r.op is not None and r.param is not None}
    read_params_dyn = {r.param for r in reads
                       if r.op is None and r.param is not None}
    read_ops_dyn = {r.op for r in reads
                    if r.param is None and r.op is not None}
    read_params_any = {r.param for r in reads if r.param is not None}
    for (op, param) in sorted(frozen):
        if op == "*":
            matched = param in read_params_any
        else:
            matched = (op, param) in read_exact \
                or param in read_params_dyn \
                or op in read_ops_dyn
        if not matched:
            findings.append(Finding(
                "SL202", TUNE_CACHE_PATH,
                row_lines.get((op, param), 0),
                "FROZEN row (%r, %r) is never read anywhere in "
                "%s/ (orphan row — its reader was removed or never "
                "wired through the arbitration)" % (op, param, PKG)))

    # SL203: unknown method families
    families = _method_families(repo)
    for fam, rel, line in fams:
        if families and fam not in families:
            findings.append(Finding(
                "SL203", rel, line,
                "str2method family %r does not exist in "
                "core/methods.str2method (known: %s) — the typo'd "
                "route silently demotes to the frozen default"
                % (fam, ", ".join(sorted(families)))))
    return findings

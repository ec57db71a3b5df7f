"""Analyzer: lock discipline (SL301).

The threaded layers (linalg/stream.py PanelCache/StreamEngine and
its pinned stagers, batch/queue.py, obs/metrics.py and the obs bus,
resil/faults.py, tune/cache.py, serve/) share state between the main
thread, prefetch/writer workers, and the background flusher. The
convention is that state a ``with <lock>:`` block protects is ONLY
mutated under that lock — mixed discipline (some mutations locked,
some not) is the race class that survives every test until a run on
the card reorders threads.

  SL301  in a lock-owning scope (a class whose ``__init__`` creates a
         ``threading.Lock``/``RLock``/``Condition`` attribute, or a
         module with one at top level), an attribute/global is
         mutated BOTH inside ``with <lock>:`` blocks and outside
         them. Each unlocked mutation site is one finding.

Deliberate lock-free paths (dispatch-free fast paths, helpers whose
callers all hold the lock) are annotated in-source::

    # slate-lint: exempt[SL301] callers hold self._lock

Scope rules (documented so exemptions stay rare and honest):

* ``__init__`` bodies and module top level are construction —
  pre-sharing, never counted.
* Nested function bodies reset the lock context (they run later,
  usually on another thread), so a worker closure mutating state
  does not inherit its definition site's lock.
* A mutation is an assignment/augmented assignment to the attribute
  (or a subscript of it), or a mutating container-method call
  (append/pop/clear/update/...). Plain reads are never flagged —
  lock-free reads of monotonic counters are this codebase's
  documented fast-path idiom.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import Finding, PKG, register

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

#: container-method names that mutate their receiver
MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "discard",
    "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse",
}


def _is_lock_make(value) -> bool:
    """True for ``threading.Lock()`` / ``Lock()`` / RLock/Condition."""
    return isinstance(value, ast.Call) \
        and astutil.call_name(value) in LOCK_FACTORIES


def _lockish(expr) -> bool:
    """True when a with-item context expression is a lock: a Name or
    terminal Attribute whose name contains 'lock' (covers self._lock,
    module _lock, AND another object's lock like self.cache._lock —
    holding *a* lock for the mutation is the discipline; WHICH lock
    guards which attr is a design-review question, not a lint)."""
    if isinstance(expr, ast.Name):
        return "lock" in expr.id.lower()
    if isinstance(expr, ast.Attribute):
        return "lock" in expr.attr.lower()
    return False


def _target_path(expr, root: str) -> Optional[Tuple[str, ...]]:
    """Attribute path of a mutation target rooted at Name `root`
    (``self.cache.uploaded_bytes`` -> ('cache', 'uploaded_bytes')),
    unwrapping subscripts (``self._seen[i]`` mutates self._seen).
    None when not rooted there."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name) and expr.id == root and parts:
        return tuple(reversed(parts))
    return None


def _global_name(expr, declared: Set[str], module_globals: Set[str],
                 call: bool = False) -> Optional[str]:
    """Name of a module-global mutation target: a plain Name REBIND
    needs a ``global`` declaration to even reach the module scope,
    but a subscript mutation (``_counters[k] = v``) or a mutating
    method call (``_counters.clear()``) hits the module object with
    no declaration."""
    sub = call
    while isinstance(expr, ast.Subscript):
        expr = expr.value
        sub = True
    if isinstance(expr, ast.Name):
        if sub and expr.id in module_globals:
            return expr.id
        if not sub and expr.id in declared:
            return expr.id
    return None


class _Site:
    __slots__ = ("line", "locked", "func")

    def __init__(self, line, locked, func):
        self.line, self.locked, self.func = line, locked, func


def _scan_func(func, is_method: bool, declared: Set[str],
               module_globals: Set[str],
               out: Dict[Tuple[str, ...], List[_Site]]) -> None:
    """Collect mutation sites in one function body, tracking whether
    each is lexically inside a lock-holding ``with``."""

    def record(path, node, locked):
        out.setdefault(path, []).append(
            _Site(node.lineno, locked, func.name))

    def targets_of(node):
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target] if getattr(node, "value", True) \
                else []
        return []

    def visit(node, locked):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not func:
            # a nested def runs later (often on a worker thread): its
            # body does not inherit the definition site's lock
            for child in ast.iter_child_nodes(node):
                visit(child, False)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = locked or any(_lockish(i.context_expr)
                                  for i in node.items)
            for i in node.items:
                visit(i.context_expr, locked)
            for child in node.body:
                visit(child, inner)
            return
        for t in targets_of(node):
            if is_method:
                path = _target_path(t, "self")
            else:
                name = _global_name(t, declared, module_globals)
                path = (name,) if name else None
            if path:
                record(path, node, locked)
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATORS:
            if is_method:
                path = _target_path(node.func.value, "self")
            else:
                name = _global_name(node.func.value, declared,
                                    module_globals, call=True)
                path = (name,) if name else None
            if path:
                record(path, node, locked)
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in func.body:
        visit(stmt, False)


def _class_findings(rel: str, cls: ast.ClassDef) -> List[Finding]:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    lock_attrs = set()
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and _is_lock_make(node.value):
                for t in node.targets:
                    p = _target_path(t, "self")
                    if p and len(p) == 1:
                        lock_attrs.add(p[0])
    if not lock_attrs:
        return []
    sites: Dict[Tuple[str, ...], List[_Site]] = {}
    for m in methods:
        if m.name == "__init__":
            continue          # construction precedes sharing
        _scan_func(m, True, set(), set(), sites)
    return _mixed(rel, " (class %s)" % cls.name, "self.", sites,
                  lock_attrs)


def _module_findings(rel: str, tree: ast.Module) -> List[Finding]:
    lock_names = set()
    module_globals = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    module_globals.add(t.id)
                    if _is_lock_make(node.value):
                        lock_names.add(t.id)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            module_globals.add(node.target.id)
    if not lock_names:
        return []
    sites: Dict[Tuple[str, ...], List[_Site]] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            declared = {n for g in ast.walk(node)
                        if isinstance(g, ast.Global) for n in g.names}
            _scan_func(node, False, declared, module_globals, sites)
        elif isinstance(node, ast.ClassDef):
            # class methods mutating module globals (rare): scan them
            # in module mode too
            for m in node.body:
                if isinstance(m, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                    declared = {n for g in ast.walk(m)
                                if isinstance(g, ast.Global)
                                for n in g.names}
                    _scan_func(m, False, declared, module_globals,
                               sites)
    return _mixed(rel, " (module global)", "", sites, lock_names)


def _mixed(rel: str, scope: str, attr_prefix: str,
           sites: Dict[Tuple[str, ...], List[_Site]],
           lock_names: Set[str]) -> List[Finding]:
    findings = []
    for path, ss in sorted(sites.items()):
        if path[0] in lock_names or path[-1] in lock_names:
            continue                      # the lock itself
        locked = [s for s in ss if s.locked]
        unlocked = [s for s in ss if not s.locked]
        if not (locked and unlocked):
            continue
        attr = attr_prefix + ".".join(path)
        for s in sorted(unlocked, key=lambda s: s.line):
            findings.append(Finding(
                "SL301", rel, s.line,
                "%s%s is mutated under a lock elsewhere (e.g. %s, "
                "line %d) but without one here in %s() — mixed lock "
                "discipline; take the lock, or annotate a deliberate "
                "lock-free path with `# slate-lint: exempt[SL301] "
                "<why>`" % (attr, scope, locked[0].func,
                            locked[0].line, s.func)))
    return findings


@register("lock-discipline", ("SL301",),
          "state mutated under a lock somewhere is never mutated "
          "lock-free elsewhere in the same class/module")
def analyze(repo: str) -> List[Finding]:
    findings: List[Finding] = []
    pkg = os.path.join(repo, PKG)
    for path in astutil.py_files(pkg):
        tree = astutil.parse(path)
        if tree is None:
            continue
        rel = astutil.rel(repo, path)
        findings.extend(_module_findings(rel, tree))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                findings.extend(_class_findings(rel, node))
    return findings

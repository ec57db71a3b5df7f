"""Shared AST plumbing for the slate_lint_torch analyzers.

Everything here is stdlib-only (no torch import — the tier-1-fast
contract): cached source/AST loading, call/name extraction, literal
parsing for the registry tables the analyzers cross-check
(tune/cache.FROZEN, ops/kernels.KERNEL_REGISTRY, resil/faults.SITES),
the literal tune-key reader scan, and the publish-name pattern
normalizer the obs analyzer uses for ``"prefix.%s_suffix" % x``-style
dynamic series.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

#: path -> source text / parsed module (one process == one tree scan;
#: core.run() clears between runs so tests can point at tmp trees)
_src_cache: Dict[str, str] = {}
_tree_cache: Dict[str, Optional[ast.Module]] = {}


def clear_cache() -> None:
    _src_cache.clear()
    _tree_cache.clear()


def source(path: str) -> str:
    """File text ('' when missing/unreadable)."""
    if path not in _src_cache:
        try:
            with open(path) as f:
                _src_cache[path] = f.read()
        except OSError:
            _src_cache[path] = ""
    return _src_cache[path]


def source_lines(path: str) -> List[str]:
    return source(path).splitlines()


def parse(path: str) -> Optional[ast.Module]:
    """Parsed module, or None when missing or syntactically broken
    (a broken file is the compiler's problem, not the linter's)."""
    if path not in _tree_cache:
        text = source(path)
        if not text and not os.path.exists(path):
            _tree_cache[path] = None
        else:
            try:
                _tree_cache[path] = ast.parse(text, filename=path)
            except SyntaxError:
                _tree_cache[path] = None
    return _tree_cache[path]


def py_files(root: str) -> List[str]:
    """Every .py under `root`, sorted for deterministic output."""
    out = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fn in sorted(files):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def rel(repo: str, path: str) -> str:
    return os.path.relpath(path, repo).replace(os.sep, "/")


def call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def calls_in(node) -> Set[str]:
    """Every function/attribute name called anywhere inside `node`."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if name:
                out.add(name)
    return out


def names_in(node) -> Set[str]:
    """Every bare Name referenced inside `node`."""
    return {sub.id for sub in ast.walk(node)
            if isinstance(sub, ast.Name)}


def str_consts(tree) -> Set[str]:
    return {c.value for c in ast.walk(tree)
            if isinstance(c, ast.Constant) and isinstance(c.value, str)}


def assigned_literal(path: str, name: str):
    """literal_eval of the top-level ``name = <literal>`` assignment
    in `path` (None when the file, the assignment, or literal-ness is
    missing) — the machine-readable registry tables live this way."""
    tree = parse(path)
    if tree is None:
        return None
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets) and node.value is not None:
                try:
                    return ast.literal_eval(node.value)
                except Exception:
                    return None
    return None


def frozen_keys(path: str) -> Set[tuple]:
    """Full (op, param) keys of the FROZEN table in tune/cache.py."""
    tab = assigned_literal(path, "FROZEN")
    return set(tab) if isinstance(tab, dict) else set()


def frozen_row_lines(path: str) -> Dict[tuple, int]:
    """(op, param) -> line number of each FROZEN row (for anchoring
    orphan-row findings at the row itself)."""
    tree = parse(path)
    if tree is None:
        return {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "FROZEN"
                   for t in targets) \
                    and isinstance(node.value, ast.Dict):
                out = {}
                for k in node.value.keys:
                    try:
                        key = ast.literal_eval(k)
                    except Exception:
                        continue
                    if isinstance(key, tuple):
                        out[key] = k.lineno
                return out
    return {}


def literal_row_reads(tree, row) -> List[int]:
    """Lines of calls whose first two args are the literal `row` key
    ``(op, param)`` — the shape of every tune-key reader
    (tune_keys.KEY_READERS, the Method*.resolve routes)."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and len(node.args) >= 2 \
                and const_str(node.args[0]) == row[0] \
                and const_str(node.args[1]) == row[1]:
            out.append(node.lineno)
    return out


def unread_rows(root: str, rows) -> List[tuple]:
    """The rows of `rows` with no literal reader in any .py under
    `root` (stops scanning once every row has one)."""
    missing = list(rows)
    for path in py_files(root):
        tree = parse(path)
        if tree is None:
            continue
        missing = [r for r in missing if not literal_row_reads(tree, r)]
        if not missing:
            break
    return missing


def name_pattern(node) -> Optional[Tuple[str, bool]]:
    """Normalize an obs publish-name expression to (text, is_static):
    a plain string constant is static; ``"a.%s_b" % x`` and f-strings
    become wildcard patterns ('a.*_b', False); anything else (a bare
    variable) is None — nothing checkable."""
    s = const_str(node)
    if s is not None:
        return s, True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
        base = const_str(node.left)
        if base is not None:
            pat = base
            for spec in ("%s", "%d", "%r", "%f", "%x"):
                pat = pat.replace(spec, "*")
            return pat, False
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            c = const_str(v)
            parts.append(c if c is not None else "*")
        pat = "".join(parts)
        return (pat, False) if pat.strip("*") else None
    return None


def levenshtein(a: str, b: str, cap: int = 2) -> int:
    """Edit distance, early-exited at `cap` (the near-miss check only
    cares about 'is it <= 1')."""
    if a == b:
        return 0
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        best = i
        for j, cb in enumerate(b, 1):
            c = min(prev[j] + 1, cur[j - 1] + 1,
                    prev[j - 1] + (ca != cb))
            cur.append(c)
            best = min(best, c)
        if best > cap:
            return cap + 1
        prev = cur
    return prev[-1]

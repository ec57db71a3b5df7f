"""Framework core: findings, the analyzer registry, in-source
exemption comments, the baseline mechanism, and the runner.

Contracts:

* A **Finding** is one violation: (code, repo-relative path, line,
  message). Codes are stable (``SLxyz``); exemptions key on the code
  alone, and a baseline entry may omit its ``message`` to match
  every finding of its (code, path) — the form that survives message
  rewording.
* An **analyzer** is a registered named pass ``fn(repo) ->
  [Finding]``; registration binds its finding codes, so ``--only``
  can select by analyzer name or code (prefix).
* An **exemption** is an in-source annotation on (or up to two lines
  above) the flagged line::

      # slate-lint: exempt[SL301] <one-line justification>

  The justification is REQUIRED — a bare marker does not exempt.
  Exempted findings are reported separately and never fail the run.
* A **baseline** is a JSON file of finding keys (code/path/message)
  to tolerate — the adoption ramp for a new analyzer on a dirty
  tree. ``--write-baseline`` emits one; a baselined finding is
  reported but does not fail the run. The tree carries none.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import astutil

#: repo root (tools/slate_lint_torch/core.py -> repo)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the package the analyzers check; every path constant is built
#: from it
PKG = "slate_tpu_torch"


def pkg_path(rel: str) -> str:
    """Repo-relative path of `rel` inside the checked package."""
    return "%s/%s" % (PKG, rel)


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str          # repo-relative; "" for repo-wide findings
    line: int          # 1-based; 0 when not line-anchored
    message: str

    def render(self) -> str:
        if self.path and self.line:
            return "%s %s:%d: %s" % (self.code, self.path, self.line,
                                     self.message)
        if self.path:
            return "%s %s: %s" % (self.code, self.path, self.message)
        return "%s %s" % (self.code, self.message)

    def key(self) -> Dict[str, str]:
        return {"code": self.code, "path": self.path,
                "message": self.message}


@dataclasses.dataclass(frozen=True)
class Analyzer:
    name: str
    codes: Tuple[str, ...]
    doc: str
    fn: Callable


#: name -> Analyzer, in registration order (== report order)
REGISTRY: Dict[str, Analyzer] = {}


def register(name: str, codes, doc: str):
    """Decorator: register ``fn(repo) -> [Finding]`` under `name`."""
    def deco(fn):
        REGISTRY[name] = Analyzer(name, tuple(codes), doc, fn)
        return fn
    return deco


def select(only: Optional[str]) -> List[Analyzer]:
    """Analyzers matching ``--only`` (name, exact code, or code
    prefix); all of them when `only` is falsy."""
    ans = list(REGISTRY.values())
    if not only:
        return ans
    hit = [a for a in ans
           if a.name == only or only in a.codes
           or any(c.startswith(only) for c in a.codes)]
    if not hit:
        raise ValueError(
            "--only %r matches no analyzer (have: %s)"
            % (only, ", ".join("%s %s" % (a.name, "/".join(a.codes))
                               for a in ans)))
    return hit


# -- exemption comments -------------------------------------------------

_EXEMPT_RE = re.compile(
    r"#\s*slate-lint:\s*exempt\[(SL\d+)\]\s+(\S.*?)\s*$")


def exemption(repo: str, f: Finding) -> Optional[str]:
    """The justification string when `f`'s line (or one of the two
    lines above it) carries a matching exempt annotation, else None."""
    if not f.path or not f.line:
        return None
    lines = astutil.source_lines(os.path.join(repo, f.path))
    for ln in range(f.line, max(f.line - 3, 0), -1):
        if 0 < ln <= len(lines):
            m = _EXEMPT_RE.search(lines[ln - 1])
            if m and m.group(1) == f.code:
                return m.group(2)
    return None


# -- baseline -----------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: Optional[str]) -> List[Dict[str, str]]:
    if not path or not os.path.exists(path):
        return []
    try:
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw, dict) \
                and raw.get("version") == BASELINE_VERSION \
                and isinstance(raw.get("entries"), list):
            return [e for e in raw["entries"] if isinstance(e, dict)]
    except Exception:
        pass
    return []


def write_baseline(path: str, findings: List[Finding]) -> str:
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION,
                   "entries": [fi.key() for fi in findings]},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def _baselined(entries: List[Dict[str, str]], f: Finding) -> bool:
    k = f.key()
    return any(e.get("code") == k["code"] and e.get("path") == k["path"]
               and e.get("message", k["message"]) == k["message"]
               for e in entries)


# -- runner -------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    findings: List[Finding]                    # live violations
    exempted: List[Tuple[Finding, str]]        # (finding, why)
    baselined: List[Finding]
    timings: Dict[str, float]                  # analyzer -> seconds

    @property
    def ok(self) -> bool:
        return not self.findings


def run(repo: Optional[str] = None, only: Optional[str] = None,
        baseline: Optional[str] = None) -> RunResult:
    """Run the selected analyzers over `repo` and classify every
    finding as live / exempted / baselined."""
    repo = os.path.abspath(repo or REPO)
    astutil.clear_cache()
    entries = load_baseline(baseline)
    res = RunResult([], [], [], {})
    for an in select(only):
        t0 = time.perf_counter()
        found = an.fn(repo)
        res.timings[an.name] = time.perf_counter() - t0
        for f in found:
            why = exemption(repo, f)
            if why is not None:
                res.exempted.append((f, why))
            elif _baselined(entries, f):
                res.baselined.append(f)
            else:
                res.findings.append(f)
    return res

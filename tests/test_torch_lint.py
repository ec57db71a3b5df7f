"""tools/slate_lint_torch, the contract lint of slate_tpu_torch/: the
registry, one clean and one violating fixture per analyzer for every
code it owns (written as source text into tmp_path, never as live
literals in this file, which the fault-site scans read), the rules
that check the port's form of a contract (SL103's launch wrappers,
SL106's resolving helper, SL503's plan scope, SL1003's `lo`), the
exemption and baseline paths, the CLI, the live tree, and the
package's imports."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools import slate_lint as reference                   # noqa: E402
from tools.slate_lint_torch import (REGISTRY, astutil, core,
                                    generate_reference, legacy,
                                    obs_literals)           # noqa: E402

PKG = core.PKG
LINT_DIR = os.path.join(REPO, "tools", "slate_lint_torch")


def _write(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(tmp_path)


def _codes(findings):
    return sorted(f.code for f in findings)


def _only(repo, name, **kw):
    return core.run(repo=repo, only=name, **kw)


def _msgs(res):
    return " ".join(f.message for f in res.findings)


# -- registry, live tree, imports ---------------------------------------

ANALYZERS = {
    "instrumented", "kernel-registry", "resil-contract",
    "shard-lookahead", "precision", "tune-keys", "lock-discipline",
    "obs-literals", "fault-sites", "flight-recorder", "sched-graph",
    "reqtrace-ctx", "elastic-mesh", "visit-fuse"}

CODES = {"SL101", "SL102", "SL103", "SL104", "SL105", "SL106",
         "SL201", "SL202", "SL203", "SL301", "SL401", "SL402",
         "SL501", "SL502", "SL503", "SL601", "SL602", "SL603",
         "SL701", "SL702", "SL703", "SL801", "SL802", "SL803",
         "SL901", "SL902", "SL903", "SL1001", "SL1002", "SL1003"}


def test_registry_lists_14_analyzers_and_30_codes():
    assert set(REGISTRY) == ANALYZERS and len(REGISTRY) == 14
    codes = [c for a in REGISTRY.values() for c in a.codes]
    assert set(codes) == CODES and len(codes) == 30


def test_registry_matches_the_reference_lint():
    """Every analyzer of tools/slate_lint has its counterpart here,
    under the same name, owning the same codes, in the same order."""
    assert [(a.name, a.codes) for a in REGISTRY.values()] \
        == [(a.name, a.codes) for a in reference.REGISTRY.values()]


#: the exemptions the port carries (code, path), each with its reason
LIVE_EXEMPTIONS = {
    ("SL202", PKG + "/tune/cache.py"),        # heev's two D&C rows
    ("SL301", PKG + "/tune/cache.py"),        # TuneCache._load
    ("SL301", PKG + "/linalg/stream.py"),     # _Stager._slot
}


def test_clean_on_live_tree():
    """Zero live findings, zero baselined, every exemption justified,
    and no exemption beyond the ones the port documents."""
    res = core.run(repo=REPO)
    assert res.findings == []
    assert res.baselined == []
    assert len(res.exempted) == 4
    assert {(f.code, f.path) for f, _ in res.exempted} == LIVE_EXEMPTIONS
    for _f, why in res.exempted:
        assert why.strip()
    heev = [f for f, _ in res.exempted if f.code == "SL202"]
    assert all("'heev'" in f.message for f in heev)
    assert all("eig.py:112" in why for f, why in res.exempted
               if f.code == "SL202")


def test_no_baseline_file_in_tree():
    assert not [n for n in os.listdir(LINT_DIR) if n.endswith(".json")]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod):
    root = mod.split(".")[0]
    return root in ("jax", "jaxlib", "torch", "slate_tpu",
                    "slate_tpu_torch") \
        or mod == "tools.slate_lint" \
        or mod.startswith("tools.slate_lint.") \
        or mod == "tools" or mod == "tools.check_instrumented"


@pytest.mark.parametrize("fn", sorted(
    f for f in os.listdir(LINT_DIR) if f.endswith(".py")))
def test_package_imports_nothing_checked_or_heavy(fn):
    """AST-only: no torch, no jax, neither package, not the reference
    lint — only the stdlib and its own modules (relative imports)."""
    mods = list(_imported_modules(os.path.join(LINT_DIR, fn)))
    assert not [m for m in mods if _forbidden(m)], mods


def test_every_path_constant_is_built_from_pkg():
    from tools.slate_lint_torch import (elastic_mesh, fault_sites,
                                        flight, reqtrace_ctx,
                                        sched_graph, tune_keys,
                                        visit_fuse)
    mods = (legacy, tune_keys, fault_sites, flight, sched_graph,
            reqtrace_ctx, elastic_mesh, visit_fuse)
    paths = [v for m in mods for k, v in vars(m).items()
             if k.endswith("_PATH") and isinstance(v, str)]
    paths += list(legacy.REQUIRED) + list(legacy.PRECISION_DRIVERS)
    paths += list(tune_keys.EXCLUDE) + list(flight.STEP_LOOP_PATHS)
    assert len(paths) > 20
    assert all(p.startswith(PKG + "/") for p in paths), paths
    assert legacy.KERNELS_PATH == PKG + "/ops/kernels.py"
    assert fault_sites.PLAN_SCAN[0] == PKG


@pytest.mark.parametrize("rel,name,module,attr", [
    ("sched/graph.py", "NODE_KINDS", "sched.graph", "NODE_KINDS"),
    ("sched/graph.py", "PHASE_OF_KIND", "sched.graph", "PHASE_OF_KIND"),
    ("sched/graph.py", "FAULT_SITE_OF_KIND", "sched.graph",
     "FAULT_SITE_OF_KIND"),
    ("obs/ledger.py", "PHASES", "obs.ledger", "PHASES"),
    ("resil/faults.py", "SITES", "resil.faults", "SITES"),
    ("resil/guard.py", "ESCALATIONS", "resil.guard", "ESCALATIONS"),
    ("ops/kernels.py", "KERNEL_REGISTRY", "ops.kernels",
     "KERNEL_REGISTRY"),
    ("tune/cache.py", "FROZEN", "tune.cache", "FROZEN"),
])
def test_live_tables_match_runtime(rel, name, module, attr):
    """The analyzers' literal_eval view of the port equals the tables
    the imported package runs with."""
    import importlib
    live = importlib.import_module("%s.%s" % (PKG, module))
    got = astutil.assigned_literal(os.path.join(REPO, PKG, rel), name)
    assert got == getattr(live, attr)


def test_frozen_rows_mirror_the_reference():
    """The port's FROZEN table has the reference's keys, so the two
    heev rows stay (exempted) instead of being dropped."""
    ours = astutil.frozen_keys(os.path.join(REPO, PKG, "tune/cache.py"))
    ref = astutil.frozen_keys(os.path.join(REPO, "slate_tpu/tune/cache.py"))
    assert ours == ref
    assert {("heev", "spectral_dc_min_n"), ("heev", "dc_leaf")} <= ours


# -- instrumented (SL101/SL102) -------------------------------------------

_HOOKED = """
    def instrument_driver(op):
        return lambda f: f

    @instrument_driver("%s")
    def %s(a):
        return a
"""


def test_instrumented_clean(tmp_path, monkeypatch):
    monkeypatch.setattr(legacy, "REQUIRED", {
        PKG + "/batch/drivers.py": ["potrf_batched"],
        PKG + "/dist/shard_ooc.py": ["shard_potrf_ooc"]})
    repo = _write(tmp_path, {
        PKG + "/batch/drivers.py": _HOOKED % ("potrf_batched",
                                              "potrf_batched") + """
    def _pad_batched(a):          # private: no hook needed
        return a
""",
        PKG + "/dist/shard_ooc.py": _HOOKED % ("shard_potrf_ooc",
                                               "shard_potrf_ooc"),
    })
    assert _only(repo, "instrumented").findings == []


def test_instrumented_catches_both(tmp_path, monkeypatch):
    monkeypatch.setattr(legacy, "REQUIRED", {
        PKG + "/batch/drivers.py": ["potrf_batched"],
        PKG + "/dist/shard_ooc.py": ["shard_potrf_ooc"],
        PKG + "/linalg/gone.py": ["gone"]})
    repo = _write(tmp_path, {
        PKG + "/batch/drivers.py": """
            def potrf_batched(a):         # lost its hook: SL102
                return a

            def gesv_batched(a, b):       # unobservable: SL101
                return b
        """,
        PKG + "/dist/shard_ooc.py": _HOOKED % ("shard_potrf_ooc",
                                               "shard_potrf_ooc") + """
    def shard_geqrf_ooc(a, grid):     # unobservable: SL101
        return a
""",
    })
    res = _only(repo, "instrumented")
    # potrf_batched both lost its REQUIRED hook and ships unobservable
    assert _codes(res.findings) == ["SL101"] * 3 + ["SL102"] * 2
    msgs = _msgs(res)
    assert "'gesv_batched'" in msgs and "'shard_geqrf_ooc'" in msgs
    assert "'potrf_batched' lost its" in msgs
    assert "gone.py: file missing" in msgs


def test_required_map_names_the_ports_drivers():
    """The map covers every decorated driver of the port's modules."""
    for rel, ops in legacy.REQUIRED.items():
        tree = astutil.parse(os.path.join(REPO, rel))
        decorated = {op for op in legacy._decorated_ops(tree).values()
                     if op}
        assert set(ops) == decorated, rel


# -- kernel-registry (SL103) ----------------------------------------------

_KERNEL_TUNE = """
    FROZEN = {("qr_panel", "max_w"): 128}
"""

_KERNELS_CLEAN = """
    KERNEL_REGISTRY = {
        "qr_panel": ("qr_panel_eligible", "qr_panel"),
    }

    def qr_panel_reject_reason(m, w, dtype, device=None):
        return None

    def qr_panel_eligible(m, w, dtype, device=None):
        return qr_panel_reject_reason(m, w, dtype, device) is None

    def _qr_panel_launch(a):
        _qr_panel_launch.launches += 1
        return a

    def qr_panel(a):
        if qr_panel_reject_reason(*a.shape, a.dtype, a.device):
            return None
        return _qr_panel_launch(a)

    def steqr_sweep(d, e):        # launches its kernel itself
        return _sweep_setup("steqr_sweep", d, e)
"""


def test_kernel_registry_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/ops/kernels.py": _KERNELS_CLEAN,
        PKG + "/tune/cache.py": _KERNEL_TUNE,
    })
    assert _only(repo, "kernel-registry").findings == []


def test_kernel_registry_catches_launch_entries(tmp_path):
    """The port's dispatch marker is a _*_launch wrapper: a public
    entry calling one must be registered; a registered entry must
    consult its gate and have a FROZEN tune op."""
    repo = _write(tmp_path, {
        PKG + "/ops/kernels.py": _KERNELS_CLEAN.replace(
            '"qr_panel": ("qr_panel_eligible", "qr_panel"),',
            '"qr_panel": ("qr_panel_eligible", "qr_panel"),\n'
            '        "trtri_lower": ("trtri_eligible", "trtri"),'
        ) + """
    def trtri_eligible(n, dtype, device=None):
        return True

    def _trtri_lower_launch(a):
        return a

    def trtri_lower(a):           # never consults its gate
        return _trtri_lower_launch(a)

    def _chol_panel_launch(a):
        return a

    def chol_panel(a):            # unregistered entry
        return _chol_panel_launch(a)
""",
        PKG + "/tune/cache.py": _KERNEL_TUNE,
    })
    res = _only(repo, "kernel-registry")
    assert _codes(res.findings) == ["SL103"] * 3
    msgs = _msgs(res)
    assert "'chol_panel' dispatches a kernel launch wrapper" in msgs
    assert "never consults its registered gate 'trtri_eligible'" in msgs
    assert "tune op 'trtri' with no FROZEN row" in msgs


def test_kernel_registry_missing_module(tmp_path):
    repo = _write(tmp_path, {PKG + "/tune/cache.py": _KERNEL_TUNE})
    res = _only(repo, "kernel-registry")
    assert _codes(res.findings) == ["SL103"]
    assert "ops/kernels.py: file missing" in res.findings[0].message


# -- resil-contract (SL104) -----------------------------------------------

_RESIL_TUNE = """
    FROZEN = {
        ("resil", "max_retries"): 2,
        ("resil", "backoff_us"): 0,
        ("resil", "ckpt_every"): 0,
    }
"""

_GUARD = """
    ESCALATIONS = {
        "mixed_to_full": "resil.mixed_to_full",
    }

    def record_escalation(rung, **ctx):
        instant("resil::escalation", rung=rung)
        inc(ESCALATIONS[rung])
"""


def test_resil_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/resil/guard.py": _GUARD,
        PKG + "/linalg/refine.py": """
            from ..resil import guard

            def refine(x):
                guard.record_escalation("mixed_to_full", op="gesv")
        """,
        PKG + "/tune/cache.py": _RESIL_TUNE,
    })
    assert _only(repo, "resil-contract").findings == []


def test_resil_catches_ladder_drift(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/resil/guard.py": """
            ESCALATIONS = {
                "mixed_to_full": "mixed_to_full",   # no resil. prefix
            }

            def record_escalation(rung, **ctx):
                inc(ESCALATIONS[rung])              # no instant
        """,
        PKG + "/tune/cache.py": """
            FROZEN = {("resil", "max_retries"): 2}
        """,
    })
    res = _only(repo, "resil-contract")
    assert set(_codes(res.findings)) == {"SL104"}
    msgs = _msgs(res)
    assert "must be resil.-prefixed" in msgs
    assert "must publish an obs instant" in msgs
    assert "not wired into any driver" in msgs
    assert "('resil', 'backoff_us')" in msgs
    assert "('resil', 'ckpt_every')" in msgs


# -- shard-lookahead (SL105) ----------------------------------------------

_SHARD_TUNE = """
    FROZEN = {("ooc", "shard_lookahead"): 0}
"""


def test_shard_lookahead_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/dist/shard_ooc.py": """
            def shard_potrf_ooc(a, grid, lookahead=None):
                with span("shard::bcast_wait"):
                    inc("ooc.shard.bcast_wait_seconds", 0.0)
                return a
        """,
        PKG + "/tune/cache.py": _SHARD_TUNE,
    })
    assert _only(repo, "shard-lookahead").findings == []


def test_shard_lookahead_catches_all(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/dist/shard_ooc.py": """
            def shard_potrf_ooc(a, grid):        # no lookahead
                return a
        """,
        PKG + "/tune/cache.py": "FROZEN = {}\n",
    })
    res = _only(repo, "shard-lookahead")
    assert _codes(res.findings) == ["SL105"] * 4
    msgs = _msgs(res)
    assert "'shard_potrf_ooc' has no `lookahead`" in msgs
    assert "'shard::bcast_wait'" in msgs
    assert "'ooc.shard.bcast_wait_seconds'" in msgs
    assert "('ooc', 'shard_lookahead')" in msgs


# -- precision (SL106) ----------------------------------------------------

_PREC_SIDE = {
    PKG + "/linalg/stream.py": """
        def demote(x):
            inc("ooc.cast_demote_bytes", 1)
            inc("ooc.cast_promote_bytes", 1)
    """,
    PKG + "/linalg/refine.py": """
        def host_ir():
            with span("ooc::refine"):
                pass
    """,
    PKG + "/tune/cache.py": """
        FROZEN = {("ooc", "precision"): "f32"}
    """,
}

_PREC_OOC = """
    def potrf_ooc(a, precision=None):
        lo = _resolve_precision(precision, a.shape[0], a.dtype)
        return a
"""

_PREC_SHARD = """
    class _Setup:
        def __init__(self, op, a, grid, precision):
            from ..linalg.ooc import _resolve_precision
            self.lo = _resolve_precision(precision, a.shape[0], a.dtype)

    def _plan(a, grid, precision):
        return _Setup("geqrf", a, grid, precision)

    def shard_potrf_ooc(a, grid, precision=None):
        s = _Setup("potrf", a, grid, precision)
        return a

    def shard_geqrf_ooc(a, grid, *, precision=None):
        s = _plan(a, grid, precision=precision)   # two levels down
        return a
"""


def _prec_drivers(monkeypatch):
    monkeypatch.setattr(legacy, "PRECISION_DRIVERS", {
        PKG + "/linalg/ooc.py": ["potrf_ooc"],
        PKG + "/dist/shard_ooc.py": ["shard_potrf_ooc",
                                     "shard_geqrf_ooc"]})


def test_precision_clean_with_resolving_helper(tmp_path, monkeypatch):
    """A shard driver satisfies the contract by handing `precision`
    to a helper of its module that resolves it (the port's _Setup),
    directly or through another helper."""
    _prec_drivers(monkeypatch)
    repo = _write(tmp_path, dict(_PREC_SIDE, **{
        PKG + "/linalg/ooc.py": _PREC_OOC,
        PKG + "/dist/shard_ooc.py": _PREC_SHARD,
    }))
    assert _only(repo, "precision").findings == []


def test_precision_catches_driver_that_neither_resolves_nor_hands_on(
        tmp_path, monkeypatch):
    _prec_drivers(monkeypatch)
    repo = _write(tmp_path, dict(_PREC_SIDE, **{
        PKG + "/linalg/ooc.py": _PREC_OOC,
        PKG + "/dist/shard_ooc.py": _PREC_SHARD.replace(
            's = _Setup("potrf", a, grid, precision)',
            's = _Setup("potrf", a, grid, None)'),
    }))
    res = _only(repo, "precision")
    assert _codes(res.findings) == ["SL106"]
    assert "'shard_potrf_ooc' never resolves" in res.findings[0].message
    assert res.findings[0].path == PKG + "/dist/shard_ooc.py"


def test_precision_helper_that_does_not_resolve_is_a_finding(
        tmp_path, monkeypatch):
    _prec_drivers(monkeypatch)
    repo = _write(tmp_path, dict(_PREC_SIDE, **{
        PKG + "/linalg/ooc.py": _PREC_OOC,
        PKG + "/dist/shard_ooc.py": _PREC_SHARD.replace(
            "self.lo = _resolve_precision(precision, a.shape[0], "
            "a.dtype)", "self.lo = precision"),
    }))
    res = _only(repo, "precision")
    assert _codes(res.findings) == ["SL106", "SL106"]
    assert "'shard_geqrf_ooc'" in _msgs(res)


def test_precision_catches_params_and_literals(tmp_path, monkeypatch):
    _prec_drivers(monkeypatch)
    repo = _write(tmp_path, {
        PKG + "/linalg/ooc.py": """
            def potrf_ooc(a):                  # no precision param
                return a
        """,
        PKG + "/dist/shard_ooc.py": _PREC_SHARD,
        PKG + "/linalg/stream.py": "",         # no cast counters
        PKG + "/tune/cache.py": "FROZEN = {}\n",
    })
    res = _only(repo, "precision")
    assert set(_codes(res.findings)) == {"SL106"}
    msgs = _msgs(res)
    assert "'potrf_ooc' has no `precision` parameter" in msgs
    assert "'ooc.cast_demote_bytes'" in msgs
    assert "refine.py: file missing" in msgs
    assert "('ooc', 'precision')" in msgs


# -- tune-keys (SL201/SL202/SL203) ----------------------------------------

_METHODS = """
    def str2method(family, s):
        fam = {
            "ooc": object, "precision": object,
        }[family]
        return fam
"""


def test_tune_keys_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/tune/cache.py": """
            FROZEN = {
                ("ooc", "panel_cols"): 8192,
                ("*", "nb"): 256,
            }
        """,
        PKG + "/core/methods.py": _METHODS,
        PKG + "/linalg/ooc.py": """
            def width(n, dtype):
                m = str2method("ooc", "stream")
                nb = tuned_int("getrf", "nb", 256)
                return int(resolve("ooc", "panel_cols", n=n))
        """,
    })
    assert _only(repo, "tune-keys").findings == []


def test_tune_keys_catches_typo_orphan_and_family(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/tune/cache.py": """
            FROZEN = {
                ("ooc", "panel_cols"): 8192,
                ("dead", "row"): 1,
            }
        """,
        PKG + "/core/methods.py": _METHODS,
        PKG + "/linalg/ooc.py": """
            def width(n, dtype):
                m = str2method("oocc", "stream")          # bad family
                return int(resolve("ooc", "panel_colz"))  # typo'd key

            def width_ok(n):
                return int(resolve("ooc", "panel_cols", n=n))
        """,
    })
    res = _only(repo, "tune-keys")
    assert _codes(res.findings) == ["SL201", "SL202", "SL203"]
    by = {f.code: f for f in res.findings}
    assert "panel_colz" in by["SL201"].message
    assert by["SL201"].path == PKG + "/linalg/ooc.py"
    assert "('dead', 'row')" in by["SL202"].message
    assert PKG + "/" in by["SL202"].message
    assert by["SL202"].line > 0
    assert "'oocc'" in by["SL203"].message


def test_tune_keys_orphan_row_exemption_at_the_row(tmp_path):
    """The port's form of a mirrored row with no reader: an SL202
    exemption on the line above the row, its reason required."""
    text = """
        FROZEN = {
            ("ooc", "panel_cols"): 8192,
            # slate-lint: exempt[SL202] mirror row, no route here
            ("heev", "dc_leaf"): 256,
        }
    """
    files = {PKG + "/core/methods.py": _METHODS,
             PKG + "/linalg/ooc.py": """
                 def width(n):
                     return resolve("ooc", "panel_cols", n=n)
             """}
    repo = _write(tmp_path, dict(files, **{PKG + "/tune/cache.py": text}))
    res = _only(repo, "tune-keys")
    assert res.findings == []
    assert [why for _f, why in res.exempted] == ["mirror row, no route here"]
    repo = _write(tmp_path, {PKG + "/tune/cache.py": text.replace(
        " mirror row, no route here", "")})
    assert _codes(_only(repo, "tune-keys").findings) == ["SL202"]


# -- lock-discipline (SL301) ----------------------------------------------

_STAGER = """
    import threading

    class _Stager:
        def __init__(self):
            self._lock = threading.Lock()
            self._events = [None, None]

        def _slot(self, i):
            %s
            self._events[i] = None       # unlocked mutation

        def h2d(self, i):
            with self._lock:
                self._slot(i)
                self._events[i] = object()
"""


def test_lock_discipline_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/x.py": """
            import threading

            class Clean:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0           # construction: fine

                def bump(self):
                    with self._lock:
                        self.n += 1

            class NoLock:
                def bump(self):
                    self.n = 1           # no lock owned: fine
        """,
    })
    assert _only(repo, "lock-discipline").findings == []


def test_lock_discipline_catches_mixed_mutation(tmp_path):
    repo = _write(tmp_path, {PKG + "/linalg/stream.py": _STAGER % "pass"})
    res = _only(repo, "lock-discipline")
    assert _codes(res.findings) == ["SL301"]
    f = res.findings[0]
    assert "self._events (class _Stager)" in f.message
    assert "_slot()" in f.message and f.line > 0


def test_lock_discipline_exemption_needs_a_reason(tmp_path):
    repo = _write(tmp_path, {PKG + "/linalg/stream.py": _STAGER
                             % "# slate-lint: exempt[SL301] callers "
                               "hold self._lock"})
    res = _only(repo, "lock-discipline")
    assert res.findings == []
    assert res.exempted[0][1] == "callers hold self._lock"
    repo = _write(tmp_path, {PKG + "/linalg/stream.py": _STAGER
                             % "# slate-lint: exempt[SL301]"})
    assert _codes(_only(repo, "lock-discipline").findings) == ["SL301"]


def test_lock_discipline_module_globals_and_closures(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/m.py": """
            import threading

            _lock = threading.Lock()
            _counters = {}

            def inc(name):
                with _lock:
                    _counters[name] = 1

            def reset():
                _counters.clear()        # unlocked mutation
        """,
        PKG + "/e.py": """
            import threading

            class Eng:
                def __init__(self):
                    self._lock = threading.Lock()

                def a(self):
                    with self._lock:
                        self.secs = 1.0

                def b(self):
                    with self._lock:
                        def task():
                            self.secs = 2.0      # runs lock-free
                        return task
        """,
    })
    res = _only(repo, "lock-discipline")
    assert _codes(res.findings) == ["SL301", "SL301"]


# -- obs-literals (SL401/SL402) -------------------------------------------

def test_obs_literals_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/q.py": """
            def record(k):
                inc("resil.fallbacks")
                instant("resil::fallback", cat="resil")   # other kind
                inc("ooc.%s_invalidations" % k)
        """,
    })
    (tmp_path / "docs").mkdir()
    (tmp_path / obs_literals.DOC_PATH).write_text(generate_reference(repo))
    assert _only(repo, "obs-literals").findings == []


def test_obs_literals_catches_near_miss(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/q.py": """
            def record(k):
                inc("batch.dispatches")
                inc("batch.dispatchs", k)        # one-off typo
                inc("ooc.cast_bytes")
                inc("ooc.cast.bytes")            # separator drift
                sp = span_begin("lu::swaps", "layer")
                span("lu::swap")                 # a hot-path span's twin
        """,
    })
    near = [f for f in _only(repo, "obs-literals").findings
            if f.code == "SL401"]
    assert len(near) == 3
    assert any("lu::swap" in f.message and "lu::swaps" in f.message
               for f in near)
    assert "batch.dispatchs" in near[0].message \
        or "batch.dispatchs" in near[1].message


def test_obs_doc_is_the_ports_own(tmp_path):
    """SL402 holds docs/OBS_REFERENCE_TORCH.md: missing, then
    generated (naming the port, not the reference's header), then
    stale after a drift. The reference's docs/OBS_REFERENCE.md does
    not stand in for it."""
    repo = _write(tmp_path, {
        PKG + "/q.py": """
            def record():
                inc("ooc.h2d_bytes")
        """,
    })
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "OBS_REFERENCE.md").write_text(
        generate_reference(repo))
    res = _only(repo, "obs-literals")
    assert [(f.code, f.path) for f in res.findings] \
        == [("SL402", "docs/OBS_REFERENCE_TORCH.md")]
    assert "missing" in res.findings[0].message
    text = generate_reference(repo)
    assert "`%s/`" % PKG in text and "tools.slate_lint_torch" in text
    assert "`%s/q.py`" % PKG in text
    doc = tmp_path / "docs" / "OBS_REFERENCE_TORCH.md"
    doc.write_text(text)
    assert _only(repo, "obs-literals").findings == []
    doc.write_text(text + "stray\n")
    res = _only(repo, "obs-literals")
    assert [f.code for f in res.findings] == ["SL402"]
    assert "stale" in res.findings[0].message


def test_obs_reference_torch_doc_matches_live_tree():
    with open(os.path.join(REPO, obs_literals.DOC_PATH)) as f:
        assert f.read() == generate_reference(REPO)


# -- fault-sites (SL501/SL502/SL503) --------------------------------------

_FAULTS = """
    SITES = {
        "h2d": "uploads",
        "ghost": "documented but never checked",
    }

    def check(site, **ctx):
        return None
"""


def test_fault_sites_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/resil/faults.py": """
            SITES = {"h2d": "uploads", "step": "panel loops"}
        """,
        PKG + "/linalg/stream.py": """
            from ..resil import faults as _faults

            def _guard_transfer(site, fn, **ctx):
                _faults.check(site, **ctx)       # dynamic: ignored
                return fn()

            def upload(loader):
                return _guard_transfer("h2d", loader, buf="A")
        """,
        PKG + "/linalg/ooc.py": """
            from ..resil.faults import check

            def step(v):
                check("step", k=0)
                v.check("ghost")                 # unrelated .check()
        """,
        "tests/test_torch_x.py": """
            PLAN = [{"site": "h2d", "times": 1}]
        """,
        "chip_smoke.py": """
            PLAN = [{"site": "step", "times": 1}]
        """,
    })
    assert _only(repo, "fault-sites").findings == []


def test_fault_sites_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/resil/faults.py": _FAULTS,
        PKG + "/linalg/stream.py": """
            from ..resil import faults as _faults

            def upload():
                _faults.check("h2d", buf="A")
                _faults.check("rogue", buf="B")   # not in SITES
        """,
        PKG + "/testing/shard_checks.py": """
            PLAN = [{"site": "h2dd", "times": 1}]
        """,
    })
    res = _only(repo, "fault-sites")
    assert _codes(res.findings) == ["SL501", "SL502", "SL503"]
    by = {f.code: f for f in res.findings}
    assert "'ghost'" in by["SL501"].message
    assert "'rogue'" in by["SL502"].message
    assert by["SL502"].path == PKG + "/linalg/stream.py"
    assert by["SL503"].path == PKG + "/testing/shard_checks.py"


def test_fault_sites_plan_scope_is_the_ports(tmp_path):
    """SL503 reads the plans of the port's tests, chip_smoke.py and
    examples/torch/ — and not the reference's tests, whose plans name
    the JAX package's SITES."""
    repo = _write(tmp_path, {
        PKG + "/resil/faults.py": """
            SITES = {"h2d": "uploads"}
        """,
        PKG + "/linalg/stream.py": """
            def upload(_faults):
                _faults.check("h2d")
        """,
        "tests/test_torch_stream.py": """
            PLAN = [{"site": "h2dx", "times": 1}]
        """,
        "tests/test_stream.py": """
            PLAN = [{"site": "panel", "times": 1}]   # reference's
        """,
        "chip_smoke.py": """
            PLAN = [{"site": "d2hx", "times": 1}]
        """,
        "examples/torch/ex17_out_of_core.py": """
            PLAN = [{"site": "stepx", "times": 1}]
        """,
        "bench.py": """
            PLAN = [{"site": "benchx", "times": 1}]  # not scanned
        """,
    })
    res = _only(repo, "fault-sites")
    assert _codes(res.findings) == ["SL503"] * 3
    assert sorted(f.path for f in res.findings) == [
        "chip_smoke.py", "examples/torch/ex17_out_of_core.py",
        "tests/test_torch_stream.py"]
    assert "'h2dx'" in _msgs(res)


def test_fault_sites_missing_schema(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/resil/faults.py": "def check(site):\n    pass\n",
    })
    res = _only(repo, "fault-sites")
    assert _codes(res.findings) == ["SL501"]
    assert "SITES" in res.findings[0].message


# -- flight-recorder (SL601/SL602/SL603) ----------------------------------

_LEDGER = """
    PHASES = ("stage", "factor", "update", "bcast_wait", "cache",
              "other")
"""

_HEALTH = """
    def _publish_stall(op):
        inc("health.stalls")
        instant("health::stall", op=op)
"""

_FLIGHT_TUNE = """
    FROZEN = {
        ("obs", "ledger"): "off",
        ("obs", "watchdog"): "off",
    }
"""


def test_flight_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/obs/ledger.py": _LEDGER,
        PKG + "/obs/health.py": _HEALTH,
        PKG + "/tune/cache.py": _FLIGHT_TUNE,
        PKG + "/linalg/ooc.py": """
            def instrument_driver(op):
                return lambda f: f

            @instrument_driver("potrf_ooc")
            def potrf_ooc(a):
                for k in range(3):
                    heartbeat("potrf_ooc", k, 3)
                    with frame("stage"):
                        pass
                return a
        """,
        PKG + "/dist/shard_ooc.py": """
            def instrument_driver(op):
                return lambda f: f

            @instrument_driver("shard_potrf_ooc")
            def shard_potrf_ooc(a, grid):
                for k in range(3):
                    heartbeat("shard_potrf_ooc", k, 3)
                    credit("bcast_wait", 0.0)
                return a
        """,
        PKG + "/batch/queue.py": """
            def dispatch(_ledger):
                _ledger.append("batch.dispatch", 0,
                               phases={"stage": 0.0, "factor": 0.0})
        """,
    })
    assert _only(repo, "flight-recorder").findings == []


def test_flight_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/obs/ledger.py": _LEDGER,
        PKG + "/obs/health.py": """
            def _publish_stall(op):
                inc("health.stals")       # typo'd counter
                instant("health::stall", op=op)
        """,
        PKG + "/tune/cache.py": """
            FROZEN = {("obs", "ledger"): "off"}
        """,
        PKG + "/linalg/ooc.py": """
            def instrument_driver(op):
                return lambda f: f

            @instrument_driver("potrf_ooc")
            def potrf_ooc(a):
                for k in range(3):          # no heartbeat: SL601
                    with frame("stag"):     # typo: SL602
                        pass
                return a
        """,
        PKG + "/dist/shard_ooc.py": "",
        PKG + "/batch/queue.py": """
            def dispatch(_ledger):
                _ledger.append("batch.dispatch", 0,
                               phases={"staeg": 0.0})
        """,
    })
    res = _only(repo, "flight-recorder")
    assert _codes(res.findings) == ["SL601", "SL602", "SL602", "SL603",
                                    "SL603"]
    msgs = _msgs(res)
    assert "'potrf_ooc' publishes no heartbeat" in msgs
    assert "'stag'" in msgs and "'staeg'" in msgs
    assert "watchdog" in msgs and "health.stalls" in msgs


# -- sched-graph (SL701/SL702/SL703) --------------------------------------

_SITES = """
    SITES = {"h2d": "uploads", "step": "panel loops"}
"""

_GRAPH = """
    NODE_KINDS = ("stage", "factor", "update", "fused_update")
    PHASE_OF_KIND = {
        "stage": "stage", "factor": "factor", "update": "update",
        "fused_update": "update",
    }
    FAULT_SITE_OF_KIND = {
        "stage": "h2d", "factor": "step", "update": None,
        "fused_update": None,
    }
"""


def test_sched_graph_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/obs/ledger.py": _LEDGER,
        PKG + "/resil/faults.py": _SITES,
        PKG + "/sched/graph.py": _GRAPH,
        PKG + "/tune/cache.py": """
            FROZEN = {("ooc", "scheduler"): "walk"}
        """,
        PKG + "/core/methods.py": """
            def resolve_scheduler(n, dtype):
                return _resolve("ooc", "scheduler", n=n, dtype=dtype)
        """,
    })
    assert _only(repo, "sched-graph").findings == []


def test_sched_graph_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/obs/ledger.py": _LEDGER,
        PKG + "/resil/faults.py": _SITES,
        PKG + "/sched/graph.py": """
            NODE_KINDS = ("stage", "factor", "update")
            PHASE_OF_KIND = {"stage": "stag", "factor": "factor",
                             "update": "update"}
            FAULT_SITE_OF_KIND = {"stage": "h2dd", "factor": None}
        """,
        PKG + "/tune/cache.py": "FROZEN = {}\n",
        PKG + "/core/methods.py": "",
    })
    res = _only(repo, "sched-graph")
    assert _codes(res.findings) == ["SL701", "SL702", "SL702", "SL703",
                                    "SL703"]
    msgs = _msgs(res)
    assert "'stag'" in msgs and "'h2dd'" in msgs
    assert "no literal ('ooc', 'scheduler') key read anywhere in " \
        "%s/" % PKG in msgs


# -- reqtrace-ctx (SL801/SL802/SL803) -------------------------------------

_TRACE_TUNE = """
    FROZEN = {
        ("obs", "reqtrace"): "off",
        ("serve", "metrics"): "off",
    }
"""

_TRACE_GATES = """
    def reqtrace_enabled():
        return resolve("obs", "reqtrace") == "on"

    def metrics_enabled():
        return resolve("serve", "metrics") == "on"

    def commit(sp):
        sample("serve.latency_s", sp.t1 - sp.t0)
"""


def test_reqtrace_ctx_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/tune/cache.py": _TRACE_TUNE,
        PKG + "/obs/reqtrace.py": _TRACE_GATES,
        PKG + "/serve/admission.py": """
            def admit(t, op):
                tid = current_trace_id()
                record_escalation("serve_shed", tenant=t, op=op,
                                  trace=tid)
                inc("serve.shed")
        """,
        PKG + "/obs/health.py": """
            def _publish_stall(op):
                record_escalation("watchdog_stall", op=op)  # not serve
        """,
    })
    assert _only(repo, "reqtrace-ctx").findings == []


def test_reqtrace_ctx_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/tune/cache.py": """
            FROZEN = {("obs", "reqtrace"): "off"}
        """,
        PKG + "/obs/reqtrace.py": """
            def reqtrace_enabled():
                return resolve("obs", "reqtrace") == "on"
        """,
        PKG + "/serve/admission.py": """
            def admit(t, op):
                record_escalation("serve_shed", tenant=t, op=op)
                inc("serve.shed")
        """,
    })
    res = _only(repo, "reqtrace-ctx")
    assert _codes(res.findings) == ["SL801", "SL801", "SL802", "SL803",
                                    "SL803"]
    msgs = _msgs(res)
    assert "'serve_shed'" in msgs and "'serve.shed'" in msgs
    assert "('serve', 'metrics')" in msgs
    by = {f.code: f for f in res.findings}
    assert by["SL802"].path == PKG + "/obs/series.py"


# -- elastic-mesh (SL901/SL902/SL903) -------------------------------------

_ELASTIC_TUNE = """
    FROZEN = {
        ("mesh", "ownership"): "static",
        ("mesh", "remap_every"): 4,
        ("mesh", "remap_threshold"): 1.25,
        ("mesh", "throughput_alpha"): 0.4,
    }
"""

_ELASTIC = """
    class ElasticSchedule(CyclicSchedule):
        def __init__(self, nt, grid, owners=None):
            self.owners = list(owners or [])
            for o in self.owners:
                if not 0 <= o < self.nranks:
                    raise ValueError("bad owner")

        def owner_flat(self, k):
            return self.owners[k]

        def owner_coords(self, k):
            f = self.owners[k]
            return f // self.q, f % self.q

        def remap(self, boundary, owners):
            owners = list(owners)
            if owners[:boundary] != self.owners[:boundary]:
                raise ValueError("relabel of a factored panel")
            return ElasticSchedule(self.nt, self.grid, owners)


    def knobs(n, dt):
        return (_resolve("mesh", "ownership", n=n, dtype=dt),
                _resolve("mesh", "remap_every", n=n, dtype=dt),
                _resolve("mesh", "remap_threshold", n=n, dtype=dt),
                _resolve("mesh", "throughput_alpha", n=n, dtype=dt))
"""


def test_elastic_mesh_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/dist/elastic.py": _ELASTIC,
        PKG + "/tune/cache.py": _ELASTIC_TUNE,
    })
    assert _only(repo, "elastic-mesh").findings == []


def test_elastic_mesh_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/dist/elastic.py": _ELASTIC.replace(
            "f = self.owners[k]\n", "f = k % self.nranks\n").replace(
            "if owners[:boundary] != self.owners[:boundary]:",
            "if len(owners) != self.nt:"),
        PKG + "/tune/cache.py": _ELASTIC_TUNE.replace(
            '("mesh", "ownership"): "static",', ""),
    })
    res = _only(repo, "elastic-mesh")
    assert _codes(res.findings) == ["SL901", "SL902", "SL903"]
    msgs = _msgs(res)
    assert "owner_coords() does not read the owners table" in msgs
    assert "owners[:boundary]" in msgs
    assert "('mesh', 'ownership') missing" in msgs


# -- visit-fuse (SL1001/SL1002/SL1003) ------------------------------------

_FUSE_TUNE = """
    FROZEN = {("ooc", "visit_fuse"): "per_panel"}
"""

_FUSE_READER = """
    def resolve_visit_fuse(n, dtype):
        return _resolve("ooc", "visit_fuse", n=n, dtype=dtype)
"""

#: the port's shape: one body for both precisions, `lo` carried down
_FUSE_OOC = """
    def _lo(x, lo, hi):
        return x if lo is None else x.to(lo).to(hi)

    def _qr_visit(S, Pj, tauj, j0, trans=True, lo=None):
        return S - Pj @ _lo(S, lo, S.dtype)

    def _fused_strips(Sp, Lp, count, w, lo):
        return Sp - Lp @ _lo(Sp, lo, Sp.dtype)

    def _lu_visit_fused(S, Lcat, g, count, w, lo=None):
        out = S.clone()
        out[g] = _fused_strips(S[g], Lcat[g], count, w, lo)
        return out

    def _qr_visit_fused(S, Pcat, taus, j0s, w, lo=None):
        for i, j0 in enumerate(j0s):
            S = _qr_visit(S, Pcat, taus[i], j0, lo=lo)
        return S

    def geqrf_ooc(S, P, t, full, w, lo):
        return _qr_visit_fused(S, P, t, [j * w for j in full], w, lo)

    def getrf_ooc(S, L, g, full, w, lo):
        return _lu_visit_fused(S, L, g, len(full), w, lo=lo)
"""


def test_visit_fuse_clean(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/sched/graph.py": _GRAPH,
        PKG + "/tune/cache.py": _FUSE_TUNE,
        PKG + "/core/methods.py": _FUSE_READER,
        PKG + "/linalg/ooc.py": _FUSE_OOC,
        PKG + "/dist/shard_ooc.py": """
            from ..linalg import ooc

            def visit(S, L, g, n, w, lo):
                return ooc._lu_visit_fused(S, L, g, n, w, lo)
        """,
    })
    assert _only(repo, "visit-fuse").findings == []


def test_visit_fuse_catches_all_three(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/sched/graph.py": """
            NODE_KINDS = ("stage", "update")
            PHASE_OF_KIND = {"stage": "stage", "update": "update",
                             "fused_update": "factor"}
            FAULT_SITE_OF_KIND = {"stage": "h2d", "update": None}
        """,
        PKG + "/tune/cache.py": """
            FROZEN = {("ooc", "scheduler"): "walk"}
        """,
        PKG + "/linalg/ooc.py": _FUSE_OOC + """
    def _fused_sweep_chol(Ss, Pk, k0):     # takes no lo
        return Ss
""",
    })
    res = _only(repo, "visit-fuse")
    assert _codes(res.findings) == ["SL1001", "SL1001", "SL1001",
                                    "SL1002", "SL1002", "SL1003"]
    msgs = _msgs(res)
    assert "fused_update" in msgs
    assert "('ooc', 'visit_fuse')" in msgs
    assert "'_fused_sweep_chol' takes no `lo` parameter" in msgs


@pytest.mark.parametrize("old,new,where", [
    # the driver's call of a fused kernel drops lo
    ("_qr_visit_fused(S, P, t, [j * w for j in full], w, lo)",
     "_qr_visit_fused(S, P, t, [j * w for j in full], w)",
     "call of fused kernel '_qr_visit_fused' drops `lo`"),
    # ... or hands it a literal None
    ("_lu_visit_fused(S, L, g, len(full), w, lo=lo)",
     "_lu_visit_fused(S, L, g, len(full), w, lo=None)",
     "call of fused kernel '_lu_visit_fused' drops `lo`"),
    # inside the route: the fused kernel's helper loses lo
    ("_fused_strips(S[g], Lcat[g], count, w, lo)",
     "_fused_strips(S[g], Lcat[g], count, w, None)",
     "_lu_visit_fused() calls _fused_strips() without its `lo`"),
    ("S = _qr_visit(S, Pcat, taus[i], j0, lo=lo)",
     "S = _qr_visit(S, Pcat, taus[i], j0)",
     "_qr_visit_fused() calls _qr_visit() without its `lo`"),
    # two helpers down the route
    ("return Sp - Lp @ _lo(Sp, lo, Sp.dtype)",
     "return Sp - Lp @ Sp",
     None),
    ("return Sp - Lp @ _lo(Sp, lo, Sp.dtype)",
     "return Sp - Lp @ _lo(Sp, None, Sp.dtype)",
     "_fused_strips() calls _lo() without its `lo`"),
])
def test_visit_fuse_catches_a_call_that_drops_lo(tmp_path, old, new, where):
    """SL1003 in the port's form: every call of the fused route passes
    `lo` on (a helper that simply does not take one is no finding)."""
    assert old in _FUSE_OOC
    repo = _write(tmp_path, {
        PKG + "/sched/graph.py": _GRAPH,
        PKG + "/tune/cache.py": _FUSE_TUNE,
        PKG + "/core/methods.py": _FUSE_READER,
        PKG + "/linalg/ooc.py": _FUSE_OOC.replace(old, new),
    })
    res = _only(repo, "visit-fuse")
    if where is None:
        assert res.findings == []
        return
    assert _codes(res.findings) == ["SL1003"]
    assert where in res.findings[0].message
    assert res.findings[0].path == PKG + "/linalg/ooc.py"
    assert res.findings[0].line > 0


def test_visit_fuse_sees_a_dropped_lo_in_another_module(tmp_path):
    repo = _write(tmp_path, {
        PKG + "/sched/graph.py": _GRAPH,
        PKG + "/tune/cache.py": _FUSE_TUNE,
        PKG + "/core/methods.py": _FUSE_READER,
        PKG + "/linalg/ooc.py": _FUSE_OOC,
        PKG + "/dist/shard_ooc.py": """
            from ..linalg import ooc

            def visit(S, L, g, n, w, lo):
                return ooc._lu_visit_fused(S, L, g, n, w)
        """,
    })
    res = _only(repo, "visit-fuse")
    assert [(f.code, f.path) for f in res.findings] \
        == [("SL1003", PKG + "/dist/shard_ooc.py")]


# -- baseline + CLI -------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    repo = _write(tmp_path, {PKG + "/linalg/stream.py": _STAGER % "pass"})
    res = _only(repo, "lock-discipline")
    bl = tmp_path / "baseline.json"
    core.write_baseline(str(bl), res.findings)
    assert json.loads(bl.read_text())["entries"]
    res2 = _only(repo, "lock-discipline", baseline=str(bl))
    assert res2.findings == [] and len(res2.baselined) == 1
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"code": "SL301", "path": PKG + "/linalg/stream.py"}]}))
    res3 = _only(repo, "lock-discipline", baseline=str(bl))
    assert res3.findings == [] and len(res3.baselined) == 1


def test_run_only_selector():
    assert list(core.run(repo=REPO, only="SL202").timings) \
        == ["tune-keys"]
    assert list(core.run(repo=REPO, only="SL3").timings) \
        == ["lock-discipline"]
    with pytest.raises(ValueError):
        core.run(repo=REPO, only="nope")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "tools.slate_lint_torch", *args],
        cwd=REPO, capture_output=True, text=True, env=env)


def test_cli_clean_list_only_and_obs_doc(tmp_path):
    out = _cli()
    assert out.returncode == 0, out.stdout + out.stderr
    assert "slate_lint_torch: ok (14 analyzers, 4 exempted, " \
        "0 baselined)" in out.stdout
    out = _cli("--list")
    assert out.returncode == 0
    assert len(out.stdout.splitlines()) == 14
    assert "SL1001/SL1002/SL1003" in out.stdout
    out = _cli("--only", "SL3")
    assert out.returncode == 0 and "(1 analyzers" in out.stdout
    out = _cli("--obs-doc", "-")
    assert out.returncode == 0
    assert out.stdout == generate_reference(REPO)
    repo = _write(tmp_path, {PKG + "/linalg/stream.py": _STAGER % "pass"})
    out = _cli("--repo", repo, "--only", "lock-discipline", "--timings")
    assert out.returncode == 1
    assert "SL301" in out.stdout and "timing lock-discipline" in out.stdout

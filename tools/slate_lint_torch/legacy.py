"""The driver, kernel, ladder, lookahead and precision contracts
(SL101-SL106), in the port's form.

  SL101/SL102  every REQUIRED-map driver keeps its @instrument_driver
               hook, and so does every public ``*_batched`` and
               ``shard_*_ooc`` driver ("unobservable" problems are
               SL101, map losses and missing files SL102)
  SL103        every public kernel entry of ops/kernels.py that
               dispatches a ``_*_launch`` wrapper (the port's
               counterpart of a ``_*_pallas`` kernel) is in
               KERNEL_REGISTRY with an eligibility gate it consults
               and a tune op with a FROZEN row
  SL104        the escalation ladder stays observable, wired, tunable
  SL105        the sharded stream routes ``lookahead`` and publishes
               the broadcast-wait span and counter
  SL106        the mixed-precision drivers resolve ``precision``
               through the tune arbitration — in their own body, or
               by handing it to a helper of the same module that does
               (the shard drivers' ``_Setup``); cast counters and the
               refine span are published
"""

from __future__ import annotations

import ast
import os

from .astutil import (assigned_literal, call_name, calls_in, const_str,
                      frozen_keys, names_in, parse, py_files, str_consts)
from .core import Finding, PKG, pkg_path, register

#: module path -> instrument_driver op names that must stay decorated
REQUIRED = {
    pkg_path("linalg/chol.py"): [
        "potrf", "posv", "posv_mixed", "posv_mixed_gmres"],
    pkg_path("linalg/lu.py"): [
        "getrf", "getrf_tntpiv", "gesv", "gesv_mixed",
        "gesv_mixed_gmres", "gesv_rbt"],
    pkg_path("linalg/qr.py"): ["geqrf", "gels", "gels_tsqr"],
    pkg_path("linalg/eig.py"): ["heev", "hegv", "steqr2", "stedc"],
    pkg_path("linalg/svd.py"): ["svd"],
    pkg_path("batch/drivers.py"): [
        "potrf_batched", "getrf_batched", "geqrf_batched",
        "posv_batched", "gesv_batched", "gels_batched",
        "heev_batched", "potrs_batched", "getrs_batched",
        "ragged_dispatch"],
    pkg_path("dist/shard_ooc.py"): [
        "shard_potrf_ooc", "shard_geqrf_ooc", "shard_getrf_ooc"],
    pkg_path("dist/steqr2.py"): ["steqr2_dist"],
    pkg_path("dist/stedc.py"): ["stedc_dist"],
    pkg_path("linalg/ooc.py"): [
        "potrf_ooc", "potrs_ooc", "posv_ooc", "getrf_ooc",
        "getrf_tntpiv_ooc", "getrs_ooc", "gesv_ooc", "geqrf_ooc",
        "unmqr_ooc", "gels_ooc", "gemm_ooc"],
}

#: relative paths of the kernel module and the tune table (SL103)
KERNELS_PATH = pkg_path("ops/kernels.py")
TUNE_CACHE_PATH = pkg_path("tune/cache.py")

#: SL104 paths and the tunables the resil layer must keep FROZEN
RESIL_GUARD_PATH = pkg_path("resil/guard.py")
RESIL_FROZEN_ROWS = (("resil", "max_retries"),
                     ("resil", "backoff_us"),
                     ("resil", "ckpt_every"))

#: SL105 path and contract literals
SHARD_OOC_PATH = pkg_path("dist/shard_ooc.py")
SHARD_WAIT_SPAN = "shard::bcast_wait"
SHARD_WAIT_COUNTER = "ooc.shard.bcast_wait_seconds"
SHARD_LOOKAHEAD_ROW = ("ooc", "shard_lookahead")

#: SL106 contract: drivers that must carry + resolve the precision
#: mode, the names that resolve it, the modules holding the
#: cast/refine observability literals, and the FROZEN row
PRECISION_DRIVERS = {
    pkg_path("linalg/ooc.py"): [
        "potrf_ooc", "potrs_ooc", "posv_ooc", "getrf_ooc",
        "getrf_tntpiv_ooc", "getrs_ooc", "gesv_ooc", "geqrf_ooc"],
    pkg_path("dist/shard_ooc.py"): [
        "shard_potrf_ooc", "shard_geqrf_ooc", "shard_getrf_ooc"],
}
PRECISION_RESOLVERS = ("_resolve_precision", "MethodPrecision")
CAST_COUNTER_PATH = pkg_path("linalg/stream.py")
CAST_COUNTERS = ("ooc.cast_demote_bytes", "ooc.cast_promote_bytes")
REFINE_SPAN_PATH = pkg_path("linalg/refine.py")
REFINE_SPAN = "ooc::refine"
PRECISION_ROW = ("ooc", "precision")

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _top_defs(tree, kinds=_DEFS) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, kinds)}


def _decorated_ops(tree) -> dict:
    """function name -> instrument_driver op string (or None when a
    function has no instrument_driver decorator)."""
    out = {}
    for node in tree.body:
        if not isinstance(node, _DEFS):
            continue
        op = None
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and isinstance(
                    dec.func, ast.Name) \
                    and dec.func.id == "instrument_driver" \
                    and dec.args \
                    and isinstance(dec.args[0], ast.Constant):
                op = dec.args[0].value
        out[node.name] = op
    return out


def _escalation_literals(tree) -> set:
    """String constants passed to escalate()/record_escalation()
    calls anywhere in `tree` — the rung names the module wires."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and call_name(node) in ("escalate", "record_escalation"):
            out |= {s for s in map(const_str, node.args) if s is not None}
    return out


# -- SL101/SL102: driver instrumentation hooks ---------------------------

def check_required(repo: str, required=None) -> list:
    """The REQUIRED map stays decorated; every public batch
    ``*_batched`` and sharded-OOC ``shard_*_ooc`` driver carries the
    hook."""
    required = REQUIRED if required is None else required
    problems = []
    for rel, ops in sorted(required.items()):
        tree = parse(os.path.join(repo, rel))
        if tree is None:
            problems.append(f"{rel}: file missing (REQUIRED map stale?)")
            continue
        found = _decorated_ops(tree)
        decorated = {op for op in found.values() if op}
        for op in ops:
            if op not in decorated:
                problems.append(
                    f"{rel}: driver {op!r} lost its "
                    f"@instrument_driver hook")
        if rel.endswith("batch/drivers.py"):
            for name, op in sorted(found.items()):
                if name.endswith("_batched") \
                        and not name.startswith("_") and op is None:
                    problems.append(
                        f"{rel}: public batch driver {name!r} is not "
                        f"@instrument_driver'd — batch drivers must "
                        f"not ship unobservable")
        if rel.endswith("dist/shard_ooc.py"):
            # every public sharded-OOC driver (shard_*_ooc) must carry
            # the hook — the per-host trace merge keys on their spans
            for name, op in sorted(found.items()):
                if name.startswith("shard_") and name.endswith("_ooc") \
                        and op is None:
                    problems.append(
                        f"{rel}: public sharded-OOC driver {name!r} "
                        f"is not @instrument_driver'd — shard_ooc "
                        f"drivers must not ship unobservable")
    return problems


# -- SL103: kernel arbitration registry ----------------------------------

def _is_launch(name: str) -> bool:
    """A kernel launch wrapper of the kernel module (``_*_launch``)."""
    return name.startswith("_") and name.endswith("_launch")


def check_kernel_registry(repo: str) -> list:
    """The kernel arbitration contract (module doc)."""
    problems = []
    tree = parse(os.path.join(repo, KERNELS_PATH))
    if tree is None:
        return ["%s: file missing" % KERNELS_PATH]
    registry = assigned_literal(os.path.join(repo, KERNELS_PATH),
                                "KERNEL_REGISTRY")
    if not isinstance(registry, dict) or not registry:
        return ["%s: KERNEL_REGISTRY literal missing or not a plain "
                "dict" % KERNELS_PATH]
    funcs = _top_defs(tree)
    frozen = {k[0] for k in frozen_keys(os.path.join(repo,
                                                     TUNE_CACHE_PATH))}
    # every public function that dispatches a launch wrapper is a
    # registered entry point
    for name, node in sorted(funcs.items()):
        if name.startswith("_") or name in registry:
            continue
        if any(_is_launch(c) for c in calls_in(node)):
            problems.append(
                "%s: public kernel entry %r dispatches a kernel launch "
                "wrapper but is not in KERNEL_REGISTRY — every kernel "
                "needs an eligibility gate and a tune-cache key"
                % (KERNELS_PATH, name))
    for entry, spec in sorted(registry.items()):
        if not (isinstance(spec, tuple) and len(spec) == 2):
            problems.append("%s: KERNEL_REGISTRY[%r] must be "
                            "(gate, tune_op)" % (KERNELS_PATH, entry))
            continue
        gate, tune_op = spec
        if entry not in funcs:
            problems.append("%s: registered kernel entry %r does not "
                            "exist" % (KERNELS_PATH, entry))
            continue
        if gate not in funcs:
            problems.append("%s: eligibility gate %r (for %r) does "
                            "not exist" % (KERNELS_PATH, gate, entry))
        elif gate not in names_in(funcs[entry]) \
                and gate not in calls_in(funcs[entry]):
            # the entry must consult the gate; a shared
            # *_reject_reason helper the gate calls also satisfies the
            # contract when the entry calls that helper
            if not (calls_in(funcs[gate]) & calls_in(funcs[entry])):
                problems.append(
                    "%s: kernel entry %r never consults its "
                    "registered gate %r" % (KERNELS_PATH, entry, gate))
        if tune_op not in frozen:
            problems.append(
                "%s: kernel entry %r registers tune op %r with no "
                "FROZEN row in %s — arbitration needs a shipped "
                "default" % (KERNELS_PATH, entry, tune_op,
                             TUNE_CACHE_PATH))
    return problems


# -- SL104: resil escalation-ladder contract -----------------------------

def check_resil_contract(repo: str) -> list:
    """The escalation-ladder observability contract."""
    problems = []
    gpath = os.path.join(repo, RESIL_GUARD_PATH)
    tree = parse(gpath)
    if tree is None:
        return ["%s: file missing" % RESIL_GUARD_PATH]
    ladder = assigned_literal(gpath, "ESCALATIONS")
    if not isinstance(ladder, dict) or not ladder:
        return ["%s: ESCALATIONS literal missing or not a plain dict"
                % RESIL_GUARD_PATH]
    for rung, counter in sorted(ladder.items()):
        if not (isinstance(counter, str)
                and counter.startswith("resil.")):
            problems.append(
                "%s: ESCALATIONS[%r] counter %r must be resil.-"
                "prefixed (the obs namespace the report keys on)"
                % (RESIL_GUARD_PATH, rung, counter))
    rec = _top_defs(tree).get("record_escalation")
    if rec is None:
        problems.append("%s: record_escalation funnel missing"
                        % RESIL_GUARD_PATH)
    else:
        calls = calls_in(rec)
        if "instant" not in calls or "inc" not in calls:
            problems.append(
                "%s: record_escalation must publish an obs instant "
                "AND increment a metrics counter (found calls: %s)"
                % (RESIL_GUARD_PATH, sorted(calls)))
    # every rung wired into a driver module (outside resil/)
    wired = set()
    for path in py_files(os.path.join(repo, PKG)):
        if os.path.basename(os.path.dirname(path)) == "resil":
            continue
        t = parse(path)
        if t is not None:
            wired |= _escalation_literals(t)
    for rung in sorted(ladder):
        if rung not in wired:
            problems.append(
                "%s: ladder rung %r is not wired into any driver "
                "module (no escalate/record_escalation call names it)"
                % (RESIL_GUARD_PATH, rung))
    keys = frozen_keys(os.path.join(repo, TUNE_CACHE_PATH))
    for row in RESIL_FROZEN_ROWS:
        if row not in keys:
            problems.append(
                "%s: FROZEN row %r missing from %s — the resil "
                "knobs must ship tuned defaults"
                % (RESIL_GUARD_PATH, row, TUNE_CACHE_PATH))
    return problems


# -- SL105: sharded-OOC lookahead contract -------------------------------

def check_shard_lookahead(repo: str) -> list:
    """The lookahead observability/tunability contract."""
    problems = []
    tree = parse(os.path.join(repo, SHARD_OOC_PATH))
    if tree is None:
        return ["%s: file missing" % SHARD_OOC_PATH]
    for name, node in _top_defs(tree).items():
        if not (name.startswith("shard_") and name.endswith("_ooc")):
            continue
        args = {a.arg for a in node.args.args + node.args.kwonlyargs}
        if "lookahead" not in args:
            problems.append(
                "%s: sharded-OOC driver %r has no `lookahead` "
                "parameter — every shard driver must route the "
                "broadcast-pipeline depth" % (SHARD_OOC_PATH, name))
    consts = str_consts(tree)
    if SHARD_WAIT_SPAN not in consts:
        problems.append(
            "%s: broadcast-wait span %r is not published — the "
            "lookahead's overlap fraction must stay attributable"
            % (SHARD_OOC_PATH, SHARD_WAIT_SPAN))
    if SHARD_WAIT_COUNTER not in consts:
        problems.append(
            "%s: counter %r is not published — the report keys the "
            "per-depth broadcast-wait wall on it"
            % (SHARD_OOC_PATH, SHARD_WAIT_COUNTER))
    if SHARD_LOOKAHEAD_ROW not in frozen_keys(
            os.path.join(repo, TUNE_CACHE_PATH)):
        problems.append(
            "%s: FROZEN row %r missing from %s — the synchronous "
            "depth-0 default must ship in the tune table"
            % (SHARD_OOC_PATH, SHARD_LOOKAHEAD_ROW, TUNE_CACHE_PATH))
    return problems


# -- SL106: mixed-precision streaming contract ---------------------------

def _resolves(node) -> bool:
    return bool(set(PRECISION_RESOLVERS)
                & (names_in(node) | calls_in(node)))


def _body(helper):
    """What runs when `helper` is called: a function's body, or a
    class's ``__init__`` (the class itself when it has none)."""
    if isinstance(helper, ast.ClassDef):
        return _top_defs(helper).get("__init__", helper)
    return helper


def _hands_on(node, helpers: dict, seen=frozenset()) -> bool:
    """Whether `node` passes its ``precision`` (the bare name, as an
    argument or keyword value) to a helper of the module — a function,
    or a class whose construction runs it — that resolves it, itself
    or by handing it on again."""
    for call in ast.walk(node):
        if not isinstance(call, ast.Call) \
                or not isinstance(call.func, ast.Name):
            continue
        passed = list(call.args) + [k.value for k in call.keywords]
        if not any(isinstance(a, ast.Name) and a.id == "precision"
                   for a in passed):
            continue
        name = call.func.id
        if name not in helpers or name in seen:
            continue
        body = _body(helpers[name])
        if _resolves(body) or _hands_on(body, helpers, seen | {name}):
            return True
    return False


def check_precision_contract(repo: str, precision_drivers=None) -> list:
    """The mixed-precision streaming contract (module doc)."""
    precision_drivers = PRECISION_DRIVERS if precision_drivers is None \
        else precision_drivers
    problems = []
    for rel, drivers in sorted(precision_drivers.items()):
        tree = parse(os.path.join(repo, rel))
        if tree is None:
            problems.append("%s: file missing (PRECISION_DRIVERS "
                            "stale?)" % rel)
            continue
        funcs = _top_defs(tree)
        helpers = _top_defs(tree, _DEFS + (ast.ClassDef,))
        for name in drivers:
            node = funcs.get(name)
            if node is None:
                problems.append(
                    "%s: mixed-path driver %r does not exist "
                    "(PRECISION_DRIVERS stale?)" % (rel, name))
                continue
            args = {a.arg for a in node.args.args
                    + node.args.kwonlyargs}
            if "precision" not in args:
                problems.append(
                    "%s: driver %r has no `precision` parameter — "
                    "every mixed-path OOC driver must route the "
                    "precision mode" % (rel, name))
                continue
            if not _resolves(node) \
                    and not _hands_on(node, helpers, frozenset({name})):
                problems.append(
                    "%s: driver %r never resolves its `precision` "
                    "parameter through the tune arbitration "
                    "(_resolve_precision / MethodPrecision), nor hands "
                    "it to a helper of its module that does"
                    % (rel, name))
    for path, lits, why in (
            (CAST_COUNTER_PATH, CAST_COUNTERS,
             "cast counter %r is not published — the report must "
             "attribute how much of the H2D saving the casts give "
             "back"),
            (REFINE_SPAN_PATH, (REFINE_SPAN,),
             "refinement span %r is not published — the mixed "
             "solves' correction wall must stay attributable")):
        tree = parse(os.path.join(repo, path))
        if tree is None:
            problems.append("%s: file missing" % path)
            continue
        consts = str_consts(tree)
        problems.extend("%s: %s" % (path, why % lit)
                        for lit in lits if lit not in consts)
    if PRECISION_ROW not in frozen_keys(os.path.join(repo,
                                                     TUNE_CACHE_PATH)):
        problems.append(
            "FROZEN row %r missing from %s — the f32 cold-route "
            "default must ship in the tune table"
            % (PRECISION_ROW, TUNE_CACHE_PATH))
    return problems


# -- analyzer registrations ----------------------------------------------

def _as_findings(problems, code_of) -> list:
    out = []
    for msg in problems:
        head = msg.split(":", 1)[0]
        path = head if head.endswith(".py") else ""
        out.append(Finding(code_of(msg), path, 0, msg))
    return out


@register("instrumented", ("SL101", "SL102"),
          "every public batch/shard driver and every REQUIRED-map "
          "driver keeps its @instrument_driver hook")
def _a_instrumented(repo):
    return _as_findings(
        check_required(repo),
        lambda m: "SL101" if "unobservable" in m else "SL102")


@register("kernel-registry", ("SL103",),
          "every kernel entry that dispatches a launch wrapper is "
          "registered with an eligibility gate and a FROZEN tune row")
def _a_kernel_registry(repo):
    return _as_findings(check_kernel_registry(repo), lambda m: "SL103")


@register("resil-contract", ("SL104",),
          "the escalation ladder stays observable, wired, and "
          "tunable")
def _a_resil(repo):
    return _as_findings(check_resil_contract(repo), lambda m: "SL104")


@register("shard-lookahead", ("SL105",),
          "sharded-OOC drivers route lookahead and publish the "
          "broadcast-wait span/counter")
def _a_shard(repo):
    return _as_findings(check_shard_lookahead(repo), lambda m: "SL105")


@register("precision", ("SL106",),
          "mixed-precision drivers resolve `precision` through tune "
          "arbitration (themselves or through a helper of their "
          "module); cast counters + refine span published")
def _a_precision(repo):
    return _as_findings(check_precision_contract(repo),
                        lambda m: "SL106")

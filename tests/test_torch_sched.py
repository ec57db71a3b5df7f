"""slate_tpu_torch.sched against the JAX package's on the CPU: the graph's
validation messages, the executor's order and slot hooks, the deadlock
check and the kind tables, equal to the reference's; then the port's
streams on the graph route: bitwise the walk (potrf_ooc, geqrf_ooc,
getrf_tntpiv_ooc, at budget 0 and under eviction), its issue counters,
the same fault log across schedulers and fuse routes, crash and resume,
the fused visits, and the watchdog's heartbeats."""

import json

import numpy as np
import pytest

from slate_tpu.core.exceptions import SlateError as JSlateError
from slate_tpu.sched import graph as jgraph
from slate_tpu.sched import runtime as jruntime

from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.core.methods import MethodScheduler, str2method
from slate_tpu_torch.linalg import ooc
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import health, ledger, metrics
from slate_tpu_torch.resil import faults, guard
import slate_tpu_torch.sched as tsched
from slate_tpu_torch.sched import (FAULT_SITE_OF_KIND, NODE_KINDS,
                                   PHASE_OF_KIND, TaskGraph, execute,
                                   policies)
from slate_tpu_torch.sched import graph as tgraph

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.default_rng(17)


@pytest.fixture(autouse=True)
def clean():
    faults.clear()
    guard.reset_counts()
    yield
    faults.clear()
    guard.reset_counts()
    health.reset()
    obs_events.disable()
    obs_events.clear()
    metrics.reset()
    ledger.reset()


@pytest.fixture
def obs_on():
    obs_events.enable()
    obs_events.clear()
    metrics.reset()
    yield
    obs_events.disable()


def _spd(rng, n, dtype=np.float64):
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T / n + 4.0 * np.eye(n, dtype=dtype)


# -- graphs against the reference's -------------------------------------------

def _bad_graphs(mod):
    """The three rejected constructions, built in package `mod`."""
    def unknown():
        mod.TaskGraph("t").add("frobnicate", lambda: None, key=(0,))

    def cycle():
        g = mod.TaskGraph("t")
        a = g.add("stage", lambda: None, key=(0,))
        b = g.add("factor", lambda: None, key=(1,), deps=[a])
        g.add_edge(b, a)
        g.validate()

    def orphan():
        g = mod.TaskGraph("t")
        a = g.add("stage", lambda: None, key=(0,))
        g.add("factor", lambda: None, key=(1,), deps=[a])
        g.add("writeback", lambda: None, key=(2,))
        g.validate()

    return {"unknown kind": unknown, "cycle": cycle, "orphan": orphan}


@pytest.mark.parametrize("case", ["unknown kind", "cycle", "orphan"])
def test_graph_rejections_match_reference(case):
    with pytest.raises(JSlateError) as je:
        _bad_graphs(jgraph)[case]()
    with pytest.raises(SlateError) as te:
        _bad_graphs(tgraph)[case]()
    assert str(te.value) == str(je.value)
    assert case.split()[0] in str(te.value)


def test_graph_single_node_is_valid():
    g = TaskGraph("t")
    g.add("stage", lambda: None, key=(0,))
    g.validate()


def _ordered_run(mod, run):
    """One graph whose dependencies override priority, built and run in
    package `mod`: the order of execution and the slot hooks."""
    order, begins, ends = [], [], []
    g = mod.TaskGraph("t")
    late = g.add("factor", lambda: order.append("f9"), key=(9, 0))
    g.add("update", lambda: order.append("u0"), key=(0, 1), deps=[late])
    a = g.add("stage", lambda: order.append("s1"), key=(1, 0))
    g.add("writeback", lambda: order.append("w2"), key=(1, 2), deps=[a])
    b = g.add("stage", lambda: order.append("s4"), key=(4, 0),
              deps=[a])
    g.add("writeback", lambda: order.append("w4"), key=(4, 1), deps=[b])
    run(g, op="t", nt=10, begin_step=begins.append,
        end_step=ends.append)
    return order, begins, ends


def test_execute_order_and_slot_hooks_match_reference():
    got = _ordered_run(tgraph, execute)
    ref = _ordered_run(jgraph, jruntime.execute)
    assert got == ref
    assert got[0] == ["s1", "w2", "s4", "w4", "f9", "u0"]
    assert got[1] == got[2] == [1, 4, 9, 0]


def test_execute_detects_deadlock():
    g = TaskGraph("t")
    a = g.add("stage", lambda: None, key=(0,))
    b = g.add("factor", lambda: None, key=(1,), deps=[a])
    g.add_edge(b, a)
    with pytest.raises(SlateError):
        execute(g, op="t")


def test_kind_tables_equal_reference():
    assert NODE_KINDS == jgraph.NODE_KINDS
    assert PHASE_OF_KIND == jgraph.PHASE_OF_KIND
    assert FAULT_SITE_OF_KIND == jgraph.FAULT_SITE_OF_KIND
    assert set(PHASE_OF_KIND.values()) <= set(ledger.PHASES)
    assert {s for s in FAULT_SITE_OF_KIND.values()
            if s is not None} <= set(faults.SITES)


SHARDED_CASES = [dict(depth=d, epoch=e, fused=f, segmented=seg)
                 for d in (0, 1, 2) for e in (0, 2) for f in (False, True)
                 for seg in (False, True)]


@pytest.mark.parametrize("case", SHARDED_CASES,
                         ids=lambda c: "d%(depth)d-e%(epoch)d-f%(fused)d-"
                         "s%(segmented)d" % c)
def test_sharded_stream_graph_matches_reference(case):
    """The exported sharded_stream builds the reference's graph: the
    same nodes (kind, panel, step, owner, key) and edges, for every
    depth, a resume epoch, fused sweeps and a segment of the elastic
    route, from one rank's schedule on a 2 x 2 grid."""
    import torch
    from slate_tpu.sched import policies as jpol
    from slate_tpu_torch.core.enums import GridOrder
    from slate_tpu_torch.dist.shard_ooc import CyclicSchedule
    from slate_tpu_torch.parallel.mesh import ProcessGrid
    assert "sharded_stream" in tsched.__all__
    grid = ProcessGrid(2, 2, GridOrder.Col, range(4), 1,
                       torch.device("cpu"), None)
    sched = CyclicSchedule(10, grid)
    noop = (lambda *a: None)
    kw = dict(sched=sched, bc=None, st=None, depth=case["depth"],
              epoch=case["epoch"], factor_panels=list(range(8)),
              tail_panels=[8, 9], payload_shape=noop,
              make_payload=noop, complete=noop, replay=noop, apply=noop,
              tail=noop, fused_apply=noop if case["fused"] else None)
    if case["segmented"]:
        kw.update(applied_through=lambda p: min(p, 3), trailing_to=10)

    def shape(g):
        return [(n.kind, n.panel, n.step, n.owner, n.key,
                 [d.seq for d in n.deps]) for n in g.nodes]

    got = policies.sharded_stream("shard_potrf_ooc", **kw)
    want = jpol.sharded_stream("shard_potrf_ooc", **kw)
    got.validate()
    assert shape(got) == shape(want)
    assert got.counts() == want.counts()


# -- arbitration --------------------------------------------------------------

def test_frozen_scheduler_is_walk():
    assert MethodScheduler.resolve(1024, np.float32) \
        is MethodScheduler.Walk
    assert not ooc._resolve_scheduler(None, 1024, np.float32)
    assert ooc._resolve_scheduler("graph", 1024, np.float32)
    assert str2method("scheduler", "GRAPH") is MethodScheduler.Graph


# -- the graph route against the walk -----------------------------------------

def _run(op, rng, **kw):
    if op == "potrf":
        return (ooc.potrf_ooc(_spd(rng, 160), panel_cols=32,
                              device=CPU, **kw),)
    g = rng.standard_normal((160, 160))
    if op == "geqrf":
        return ooc.geqrf_ooc(g, panel_cols=32, device=CPU, **kw)
    return ooc.getrf_tntpiv_ooc(g, panel_cols=32, device=CPU, **kw)


@pytest.mark.parametrize("budget", [0, int(1.5 * 160 * 32 * 8)])
@pytest.mark.parametrize("op", ["potrf", "geqrf", "getrf_tntpiv"])
def test_graph_bitwise_walk(op, budget):
    walk = _run(op, np.random.default_rng(5), cache_budget_bytes=budget)
    graph = _run(op, np.random.default_rng(5), cache_budget_bytes=budget,
                 scheduler="graph")
    for x, y in zip(walk, graph):
        np.testing.assert_array_equal(x, y)


def test_graph_issue_counters(rng, obs_on):
    ooc.potrf_ooc(_spd(rng, 96), panel_cols=32, scheduler="graph",
                  device=CPU)
    c = metrics.snapshot()["counters"]
    assert c.get("sched.graphs") == 1
    # nt = 3: 3 stage + 3 update (0 + 1 + 2) + 3 factor + 3 writeback
    assert c.get("sched.nodes_issued") == 12
    assert c.get("sched.issue_overhead_seconds", 0) >= 0


PLAN = [{"site": "h2d", "match": {"buf": "A"}, "times": 2, "prob": 0.9},
        {"site": "d2h", "match": {"buf": "L", "idx": 1}, "times": 1},
        {"site": "step", "match": {"op": "potrf_ooc"}, "times": 3,
         "prob": 0.5, "kind": "slow", "slow_s": 0.0}]


@pytest.mark.parametrize("route", [{"scheduler": "graph"},
                                   {"visit_fuse": "fused"}])
def test_fault_log_identical_across_routes(rng, route):
    """One seeded plan over h2d, d2h and step: the same injection log,
    retries and factor on the walk and on the other route."""
    a = _spd(rng, 160)

    def run(**kw):
        guard.reset_counts()
        plan = faults.install(faults.FaultPlan(PLAN, seed=11))
        L = ooc.potrf_ooc(a, panel_cols=32, device=CPU, **kw)
        faults.clear()
        return L, plan.log(), guard.counts()

    Lw, logw, cw = run()
    Lr, logr, cr = run(**route)
    assert logw == logr
    assert {e["site"] for e in logw} == {"h2d", "d2h", "step"}
    assert cw == cr and cw.get("resil.retries", 0) >= 2
    if "scheduler" in route:
        np.testing.assert_array_equal(Lw, Lr)
    else:
        assert np.abs(Lw - Lr).max() <= 1e-12


# -- crash and resume ---------------------------------------------------------

@pytest.mark.parametrize("op,crash,resume", [
    ("potrf", {"scheduler": "graph"}, {"scheduler": "graph"}),
    ("getrf_tntpiv", {}, {"scheduler": "graph"}),
    ("geqrf", {}, {"visit_fuse": "fused"}),
])
def test_crash_resume_bitwise(op, crash, resume, tmp_path):
    """A step fault at panel 3 with a checkpoint every panel; the
    resumed stream lands bitwise on the uninterrupted factor."""
    ref = _run(op, np.random.default_rng(9))
    name = {"potrf": "potrf_ooc", "geqrf": "geqrf_ooc",
            "getrf_tntpiv": "getrf_tntpiv_ooc"}[op]
    faults.install(faults.FaultPlan(
        [{"site": "step", "match": {"op": name, "step": 3},
          "times": 1}]))
    with pytest.raises(faults.InjectedFault):
        _run(op, np.random.default_rng(9), ckpt_path=str(tmp_path),
             ckpt_every=1, **crash)
    faults.clear()
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["epoch"] == 3
    got = _run(op, np.random.default_rng(9), ckpt_path=str(tmp_path),
               ckpt_every=1, **resume)
    for x, y in zip(ref, got):
        np.testing.assert_array_equal(x, y)
    assert guard.counts()["resil.ckpt_commits"] >= 2


# -- fused visits -------------------------------------------------------------

def test_fused_visits_against_per_panel(obs_on):
    """potrf fused within 1e-12 (one reassociated product), geqrf fused
    bitwise (ordered applies), getrf fused with identical pivots; the
    fused-visit counters."""
    a = _spd(np.random.default_rng(3), 160)
    g = np.random.default_rng(4).standard_normal((160, 160))
    L0 = ooc.potrf_ooc(a, panel_cols=32, device=CPU)
    L1 = ooc.potrf_ooc(a, panel_cols=32, visit_fuse="fused", device=CPU)
    assert np.abs(L0 - L1).max() <= 1e-12
    q0, t0 = ooc.geqrf_ooc(g, panel_cols=32, device=CPU)
    q1, t1 = ooc.geqrf_ooc(g, panel_cols=32, visit_fuse="fused",
                           device=CPU)
    np.testing.assert_array_equal(q0, q1)
    np.testing.assert_array_equal(t0, t1)
    l0, p0 = ooc.getrf_tntpiv_ooc(g, panel_cols=32, device=CPU)
    l1, p1 = ooc.getrf_tntpiv_ooc(g, panel_cols=32, visit_fuse="fused",
                                  device=CPU)
    np.testing.assert_array_equal(p0, p1)
    assert np.abs(l0 - l1).max() <= 1e-10
    c = metrics.snapshot()["counters"]
    # nt = 5: panels 2, 3, 4 fuse 2 + 3 + 4 visits, in each of 3 drivers
    assert c["ooc.visits_fused"] == 27
    assert c["ooc.visit_dispatches_saved"] == 18


def test_fused_getrf_is_tournament_only(rng):
    g = rng.standard_normal((96, 96))
    with pytest.raises(SlateError, match="tournament-only"):
        ooc.getrf_ooc(g, panel_cols=32, pivot="partial",
                      visit_fuse="fused", device=CPU)


# -- heartbeats ---------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["walk", "graph"])
def test_heartbeats_a_panel_and_completion(rng, scheduler):
    """With the watchdog on, each stream beats once a panel plus the
    completion beat: nt + 1 (nt = 3 here)."""
    a = _spd(rng, 96)
    g = rng.standard_normal((96, 96))
    health.enable(min_budget_s=60.0)
    try:
        for op, call in (
                ("potrf_ooc", lambda: ooc.potrf_ooc(
                    a, panel_cols=32, scheduler=scheduler, device=CPU)),
                ("geqrf_ooc", lambda: ooc.geqrf_ooc(
                    g, panel_cols=32, scheduler=scheduler, device=CPU)),
                ("getrf_tntpiv_ooc", lambda: ooc.getrf_tntpiv_ooc(
                    g, panel_cols=32, scheduler=scheduler, device=CPU))):
            before = health.stats()["heartbeats"]
            call()
            st = health.stats()
            assert st["heartbeats"] - before == 4, op
            assert st["ops"][op]["step"] == 3
    finally:
        health.disable()
    assert not health.thread_alive()

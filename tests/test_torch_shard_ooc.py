"""The port's sharded out-of-core stream (slate_tpu_torch/dist/shard_ooc.py)
against its single-engine stream and the JAX package's on the CPU: one
launch of four gloo ranks (testing.multiproc, the worker bodies in
testing.shard_checks, suite "shard") runs every check on the 2 x 2,
1 x 4 and 4 x 1 grids; this process computes the reference's
``shard_*_ooc`` on ``slate_tpu.make_grid(p, q,
devices=jax.devices()[:4])`` from the same seeded inputs. Twins of
tests/test_shard_ooc.py and of the shard tests of test_sched.py,
test_resil.py, test_flight.py, test_precision_ooc.py and
test_visit_fuse.py. Every rank's factor is bitwise its single-engine
stream's and rank 0's; the factor agrees with the reference to the
tolerance of test_torch_ooc.py (f64 1e-12, f32 1e-5 of the largest
entry), pivots bitwise."""

import threading

import jax
import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.dist import shard_ooc as jso

import slate_tpu_torch as st
from slate_tpu_torch.core.enums import GridOrder
from slate_tpu_torch.core.methods import MethodOOC
from slate_tpu_torch.dist import shard_ooc as so
from slate_tpu_torch.linalg import ooc
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import metrics
from slate_tpu_torch.parallel.mesh import ProcessGrid
from slate_tpu_torch.resil import faults, guard
from slate_tpu_torch.testing import grid_checks as gc
from slate_tpu_torch.testing import multiproc as mp
from slate_tpu_torch.testing import shard_checks as sc

GRIDS = ["%dx%d" % g for g in gc.GRIDS]
X = sc.inputs("shard")
W = sc.W
CPU = "cpu"
ROUTES = ("cold_stream", "floor_stream", "tuned_sharded",
          "explicit_stream", "string_sharded", "posv",
          "getrf_auto_pivot", "gesv", "partial_raises", "gels")


class _Launch:
    """The suite's one launch, in a thread so the JAX reference computes
    meanwhile."""

    def __init__(self, suite, outdir, n=4):
        self.res, self.exc = None, None
        self.thread = threading.Thread(target=self._run,
                                       args=(suite, outdir, n))
        self.thread.start()

    def _run(self, suite, outdir, n):
        try:
            procs, outs = mp.launch(
                "slate_tpu_torch.testing.shard_checks", n,
                extra_args=[suite], outdir=outdir, timeout=240,
                env={"SLATE_TPU_TORCH_TUNE_CACHE": outdir + "/tune"})
            mp.assert_success(procs, outs)
            self.res = gc.load(outs)
        except BaseException as e:       # re-raised in the test thread
            self.exc = e

    def result(self):
        self.thread.join()
        if self.exc is not None:
            raise self.exc
        return self.res


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    return _Launch("shard", str(tmp_path_factory.mktemp("shard")))


def _jgrid(name):
    p, q = (int(v) for v in name.split("x"))
    return jst.make_grid(p, q, devices=jax.devices()[:4])


def _reference(g):
    out = {"l": np.asarray(jso.shard_potrf_ooc(
        X["spd"], g, panel_cols=W, cache_budget_bytes=0)),
        "l_bf16": np.asarray(jso.shard_potrf_ooc(
            X["spd32"], g, panel_cols=W, cache_budget_bytes=64 * 160 * W
            * 8, precision="bf16"))}
    for shape in ("sq", "wide", "tall"):
        qr, tau = jso.shard_geqrf_ooc(X[shape], g, panel_cols=W,
                                      cache_budget_bytes=0)
        out[shape + "_qr"], out[shape + "_tau"] = (np.asarray(qr),
                                                   np.asarray(tau))
    for shape in ("lu", "wide", "tall", "sq100"):
        lu, piv = jso.shard_getrf_ooc(X[shape], g, panel_cols=W,
                                      cache_budget_bytes=0)
        out[shape + "_lu"], out[shape + "_piv"] = (np.asarray(lu),
                                                   np.asarray(piv))
    return out


@pytest.fixture(scope="module")
def ref(launch):
    return {name: _reference(_jgrid(name)) for name in GRIDS}


@pytest.fixture(scope="module")
def ranks(ref, launch):
    return launch.result()


def _close(got, want, dtype=np.float64):
    tol = 1e-12 if np.dtype(dtype) == np.float64 else 1e-5
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


def _rec(ranks, name, check):
    return [r["%s.%s" % (name, check)] for r in ranks]


def _same_shas(recs):
    for r in recs[1:]:
        for k, v in recs[0].items():
            if k.startswith("sha") or k == "shas":
                assert r[k] == v, k


# -- the schedule, in this process ------------------------------------------

def _pgrid(p, q, index=0):
    return ProcessGrid(p, q, GridOrder.Col, range(p * q), index,
                       torch.device(CPU), None)


@pytest.mark.parametrize("p,q", [(2, 2), (1, 4), (4, 1), (2, 4)])
def test_schedule_walk_matches_reference(p, q):
    """owner_coords / owner_flat are the reference's walk; each rank's
    update order is the reference's restricted to the panels it owns,
    and the ranks' staged bytes add up to the reference's one-process
    prediction at every depth."""
    nt, n, w = 16, 500, 32
    jref = jso.CyclicSchedule(nt, jst.make_grid(
        p, q, devices=jax.devices()[:p * q]))
    heights = {k: n - k * w for k in range(nt)}
    for d in (0, 1, 2, 5):
        total = 0
        for idx in range(p * q):
            s = so.CyclicSchedule(nt, _pgrid(p, q, idx))
            for k in range(nt):
                assert s.owner_coords(k) == jref.owner_coords(k)
                assert s.owner_flat(k) == jref.owner_flat(k)
                for e in (0, 3):
                    assert s.update_order(k, d, e) == [
                        j for j in jref.update_order(k, d, e)
                        if jref.owner_flat(j) == idx]
            assert s.my_panels() == [k for k in range(nt)
                                     if jref.owner_flat(k) == idx]
            total += s.staged_bytes(heights, w, n - (nt - 1) * w, 8,
                                    depth=d)
        assert total == jref.staged_bytes(heights, w, n - (nt - 1) * w,
                                          8, depth=d)


def test_method_ooc_resolve_gate():
    assert MethodOOC.resolve(1024, 4, 8, np.float64) is MethodOOC.Stream
    assert st.str2method("ooc", "sharded") is MethodOOC.Sharded


# -- the drivers on the grids ------------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
def test_potrf_bitwise_single_engine_and_rank0(ranks, name):
    """Budget 0, a spilling budget, lookahead 1 and 2, the graph route,
    fused sweeps and fan-in 4: every rank's factor is its own
    single-engine potrf_ooc's, and rank 0's."""
    recs = _rec(ranks, name, "potrf")
    for r in recs:
        assert all(r["same"].values()), r["same"]
    _same_shas(recs)


@pytest.mark.parametrize("name", GRIDS)
def test_potrf_matches_reference(ranks, ref, name):
    _close(ranks[0][name + ".potrf"]["l"], ref[name]["l"])


@pytest.mark.parametrize("name", GRIDS)
def test_potrf_staging_exact_and_broadcast_counted(ranks, name):
    """Eviction-free: each rank stages exactly its schedule's
    prediction (at depth 0 and 1, on the walk and the graph), one frame
    a panel over the tree (2 rounds on four ranks), no spill, one wait
    span and one step_obs instant a panel whose h2d deltas sum to the
    run's, one overlap record."""
    n, nt = 160, 5
    for r in _rec(ranks, name, "potrf"):
        for run, c in r["counts"].items():
            assert c["h2d"] == c["expect"] > 0, run
            assert c["bcast_panels"] == nt
            assert c["bcast_bytes"] == n * n * 8
            assert c["permutes"] == c["permutes_expected"] == 2 * nt
            assert c["spills"] == 0 and c["wait_spans"] == nt
            assert c["step_obs"] == nt and c["step_obs_h2d"] == c["h2d"]
            assert c["overlap_instants"] == 1 and c["bitwise"]


@pytest.mark.parametrize("name", GRIDS)
def test_lookahead_issues_frames_ahead(ranks, name):
    """Depth 0 issues nothing ahead; depth 1 (walk and graph) issues
    nt - 1 frames ahead, their in-flight wall at least the wait."""
    for r in _rec(ranks, name, "potrf"):
        c = r["counts"]
        assert c["big"]["bcast_ahead"] == 0 and c["big"]["graphs"] == 0
        for run in ("big_d1", "big_graph_d1"):
            assert c[run]["bcast_ahead"] == 4
            assert c[run]["inflight_s"] >= c[run]["wait_s"] > 0
        assert c["big_graph_d1"]["graphs"] == 1


@pytest.mark.parametrize("name", GRIDS)
def test_crash_resume_bitwise(ranks, name):
    """A step fault at panel 3: depth 0 commits epoch 3, depth 1 epoch 2
    (the in-flight panel 3 is not durable); both resume bitwise. A
    resume at epoch nt - 1 stages only the replayed frames and the one
    live panel's write-through touches."""
    for r in _rec(ranks, name, "potrf"):
        res = r["resume"]
        assert res["d0"] == {"raised": ["step", 3], "epoch": 3,
                             "bitwise": True}
        assert res["d1"] == {"raised": ["step", 3], "epoch": 2,
                             "bitwise": True}
        assert res["tail"]["h2d"] == res["tail"]["expect"]
        assert res["tail"]["bitwise"]


@pytest.mark.parametrize("name", GRIDS)
def test_ppermute_fault_retried_bitwise(ranks, name):
    for r in _rec(ranks, name, "potrf"):
        assert r["retry"] == {"fired": 1, "retries": 1, "bitwise": True}


@pytest.mark.parametrize("name", GRIDS)
def test_bf16_frames_half_the_bytes(ranks, ref, name):
    """The cold route is bitwise explicit "f32"; bf16 frames carry half
    the bytes (casts counted), depth 1 is bitwise depth 0, and the
    factor is the same on every rank at bf16-update accuracy."""
    recs = _rec(ranks, name, "potrf")
    for r in recs:
        pr = r["precision"]
        assert pr["f32_bitwise"] and pr["stream_bitwise"]
        assert pr["bytes"][1] * 2 == pr["bytes"][0]
        assert pr["bf16_casts"] > 0 and pr["bf16_d1_bitwise"]
        assert 0 < pr["bf16_err"] < 5e-2
    _same_shas(recs)
    np.testing.assert_allclose(recs[0]["l_bf16"], ref[name]["l_bf16"],
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("shape", ("sq", "wide", "tall"))
@pytest.mark.parametrize("name", GRIDS)
def test_geqrf_bitwise_and_matches_reference(ranks, ref, name, shape):
    """Square, m < n (the tail panels broadcast after the factor loop)
    and tall: bitwise the single engine at depths 0-2, on the graph, fused
    and cached; packed factor and taus within the reference's."""
    recs = _rec(ranks, name, "geqrf")
    for r in recs:
        assert all(v for k, v in r["same"].items()
                   if k.startswith(shape + ".")), r["same"]
        assert r["shas"] == recs[0]["shas"]
    _close(recs[0][shape + "_qr"], ref[name][shape + "_qr"])
    _close(recs[0][shape + "_tau"], ref[name][shape + "_tau"])


@pytest.mark.parametrize("name", GRIDS)
def test_geqrf_crash_resume_bitwise(ranks, name):
    for r in _rec(ranks, name, "geqrf"):
        assert r["resume"] == {"raised": ["step", 2], "bitwise": True}


@pytest.mark.parametrize("shape", ("lu", "wide", "tall", "sq100"))
@pytest.mark.parametrize("name", GRIDS)
def test_getrf_bitwise_pivots_and_reference(ranks, ref, name, shape):
    """Tournament LU, cross-panel pivots, m < n, tall and ragged:
    bitwise the single-engine getrf_tntpiv_ooc (factor and ipiv) at
    depths 0-2, spilling, graph and fused; pivots bitwise the
    reference's, the factor within it."""
    recs = _rec(ranks, name, "getrf")
    for r in recs:
        assert all(v for k, v in r["same"].items()
                   if k.startswith(shape + ".")), r["same"]
        assert r["shas"] == recs[0]["shas"]
    assert np.array_equal(recs[0][shape + "_piv"],
                          ref[name][shape + "_piv"])
    _close(recs[0][shape + "_lu"], ref[name][shape + "_lu"])


@pytest.mark.parametrize("name", GRIDS)
def test_getrf_staging_exact_and_pivot_row(ranks, name):
    """Full-height staging exactly the schedule's; each frame carries
    one extra row (the pivot selection); no invalidation."""
    for r in _rec(ranks, name, "getrf"):
        c = r["counts"]
        assert c["h2d"] == c["expect"] > 0
        assert c["bcast_bytes"] == c["bcast_expect"]
        assert c["invalidations"] == 0 and c["bitwise"]


@pytest.mark.parametrize("name", GRIDS)
def test_getrf_bf16_pivot_pair(ranks, name):
    """bf16 frames carry the selection as a byte-split pair: a valid
    factorization at bf16-update residual, the same on every rank."""
    recs = _rec(ranks, name, "getrf")
    for r in recs:
        assert r["bf16"]["resid"] < 5e-2
        assert r["bf16"]["sha"] == recs[0]["bf16"]["sha"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", GRIDS)
def test_drivers_route_through_method_ooc(ranks, name, route):
    """potrf_ooc / posv_ooc / getrf_ooc / gesv_ooc / gels_ooc with the
    grid: a cold cache keeps the stream (no frame), so does a tuned
    "sharded" below shard_min_panels; past it, and with an explicit or
    string Sharded, the sharded stream, bitwise; explicit Stream wins;
    pivot "auto" takes the tournament; partial + Sharded raises."""
    for r in _rec(ranks, name, "routing"):
        assert r[route] is True


def test_exchange_host_staging_same_bits_and_counts(ranks):
    """exchange()'s host copy (forced on CPU tensors): the tree
    all-reduce and ring_shift give the direct path's bits and
    collective counts, and its bytes are counted (none directly)."""
    for r in [x["2x2.exchange"] for x in ranks]:
        assert r["same"] and r["counts_equal"]
        assert r["direct_staged"] == 0
        assert r["staged_bytes"] == r["staged_expect"] > 0


# -- one rank, in this process -----------------------------------------------

def _spd(n, dtype=np.float64, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T / n + 4.0 * np.eye(n, dtype=dtype)


def test_any_non_processgrid_raises():
    a = _spd(64)
    for fn in (so.shard_potrf_ooc, so.shard_geqrf_ooc,
               so.shard_getrf_ooc):
        for grid in (object(), None):
            with pytest.raises(TypeError, match="ProcessGrid"):
                fn(a, grid, panel_cols=32)


def test_one_rank_grid_is_the_stream():
    """make_grid(1, 1) needs no process group: each driver is bitwise
    its single-engine stream, whose frames are the identity."""
    g = st.single_device_grid(CPU)
    a = _spd(96)
    assert np.array_equal(so.shard_potrf_ooc(a, g, panel_cols=32),
                          ooc.potrf_ooc(a, 32, device=CPU))
    x = np.random.default_rng(1).standard_normal((96, 96))
    for r, t in ((so.shard_geqrf_ooc(x, g, panel_cols=32),
                  ooc.geqrf_ooc(x, 32, device=CPU)),
                 (so.shard_getrf_ooc(x, g, panel_cols=32),
                  ooc.getrf_tntpiv_ooc(x, 32, device=CPU))):
        assert all(np.array_equal(u, v) for u, v in zip(r, t))


def test_lookahead_cold_route_synchronous(monkeypatch):
    """FROZEN ooc/shard_lookahead 0 issues nothing ahead; a tuned 1
    issues nt - 1 frames ahead, bitwise, and the schedule instant
    carries the depth."""
    from slate_tpu_torch.tune import cache as tcache
    g = st.single_device_grid(CPU)
    a = _spd(128)
    assert tcache.FROZEN[("ooc", "shard_lookahead")] == 0
    obs_events.enable()
    try:
        metrics.reset()
        L0 = so.shard_potrf_ooc(a, g, panel_cols=32)
        assert int(metrics.snapshot()["counters"].get(
            "ooc.shard.bcast_ahead", 0)) == 0
        monkeypatch.setitem(tcache.FROZEN, ("ooc", "shard_lookahead"), 1)
        metrics.reset()
        obs_events.clear()
        L1 = so.shard_potrf_ooc(a, g, panel_cols=32)
        assert int(metrics.snapshot()["counters"][
            "ooc.shard.bcast_ahead"]) == 3
        assert np.array_equal(L0, L1)
        sched = [e for e in obs_events.events()
                 if e.name == "shard::schedule"]
        assert sched and sched[-1].args["lookahead"] == 1
    finally:
        obs_events.disable()
        obs_events.clear()
        metrics.reset()


def test_step_faults_fire_in_the_same_order_across_routes():
    """A step plan that skips five checks dies at the same step with the
    same log on the walk and the graph (depth 2), and a fused sweep
    fires each member's check at the same step as the per-panel
    route."""
    g = st.single_device_grid(CPU)
    a = _spd(160)

    def run(**kw):
        plan = faults.install(faults.FaultPlan(
            [{"site": "step", "match": {"op": "shard_potrf_ooc"},
              "after": 5, "times": 1}]))
        try:
            so.shard_potrf_ooc(a, g, panel_cols=16, lookahead=2, **kw)
            raised = None
        except faults.InjectedFault as e:
            raised = (e.site, e.ctx.get("step"), e.occurrence)
        finally:
            faults.clear()
        return raised, plan.log()

    walk = run(scheduler="walk")
    assert walk[0] == ("step", 5, 5)
    assert walk == run(scheduler="graph") == run(visit_fuse="fused")


def test_escalation_gated_to_one_rank():
    """On a grid of more ranks a transient failure propagates (one rank
    rerouting alone would desert its peers' collective); on one rank
    the shard_to_stream rung runs the single-engine stream."""
    def boom():
        raise faults.InjectedFault("ppermute", 0, 0, {})

    guard.reset_counts()
    with pytest.raises(faults.InjectedFault):
        ooc._shard_escalate(boom, lambda: "fallback", "potrf_ooc",
                            _pgrid(1, 2))
    assert guard.counts() == {}
    assert ooc._shard_escalate(boom, lambda: "fallback", "potrf_ooc",
                               _pgrid(1, 1)) == "fallback"
    assert guard.counts()["resil.fallback.shard_to_stream"] == 1
    guard.reset_counts()


def test_shard_route_escalates_to_stream():
    """A sharded route that keeps failing past the retry budget steps
    down to the stream on one rank, with the rung counted and
    published."""
    g = st.single_device_grid(CPU)
    a = _spd(96)
    L0 = ooc.potrf_ooc(a, 32, device=CPU)
    guard.reset_counts()
    obs_events.enable()
    try:
        faults.install(faults.FaultPlan(
            [{"site": "ppermute", "match": {"op": "shard_bcast"},
              "times": 999}]))
        L1 = ooc.potrf_ooc(a, 32, grid=g, method=MethodOOC.Sharded,
                           device=CPU)
        faults.clear()
        c = guard.counts()
        assert c["resil.fallback.shard_to_stream"] == 1
        assert c["resil.fallbacks"] == 1
        assert np.array_equal(L0, L1)
        ev = [e for e in obs_events.events()
              if e.name == "resil::fallback"]
        assert ev and ev[0].args["rung"] == "shard_to_stream"
    finally:
        faults.clear()
        obs_events.disable()
        obs_events.clear()
        guard.reset_counts()


def test_shard_drivers_instrumented_and_ledger_off_is_silent():
    """The drivers carry instrument_driver; with the flight recorder off
    a sharded run leaves no record (the flight tests' off state)."""
    from slate_tpu_torch.obs import ledger
    g = st.single_device_grid(CPU)
    a = _spd(96)
    x = np.random.default_rng(2).standard_normal((96, 96))
    ledger.reset()
    obs_events.enable()
    try:
        so.shard_potrf_ooc(a, g, panel_cols=32)
        so.shard_geqrf_ooc(x, g, panel_cols=32)
        so.shard_getrf_ooc(x, g, panel_cols=32)
        drv = st.obs.snapshot()["drivers"]
        for op in ("shard_potrf_ooc", "shard_geqrf_ooc",
                   "shard_getrf_ooc"):
            assert op in drv, op
        assert ledger.records() == []
    finally:
        obs_events.disable()
        obs_events.clear()
        metrics.reset()


def test_flight_recorder_steps_a_sharded_run():
    """Ledger on: one record a panel plus the drain record, the
    broadcast wait credited to its phase."""
    from slate_tpu_torch.obs import ledger
    g = st.single_device_grid(CPU)
    a = _spd(128)
    ledger.reset()
    ledger.enable()
    try:
        so.shard_potrf_ooc(a, g, panel_cols=32)
        recs = [r for r in ledger.records() if r.op == "shard_potrf_ooc"]
    finally:
        ledger.disable()
        ledger.reset()
    assert [r.step for r in recs] == [0, 1, 2, 3, 4]
    assert all("bcast_wait" in r.phases for r in recs[:4])

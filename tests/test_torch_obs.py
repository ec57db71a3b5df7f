"""slate_tpu_torch's obs/ (the extended event bus, metrics, the flight
recorder, request traces, series, the watchdog, the Perfetto export,
xprof and the report) on the CPU: against the JAX package where the
two share semantics (quantile sketches, the Prometheus text, the trace
export's structure and host namespacing, counter deltas), then the
port's own wiring (the queue's ledger records, spans and batch.*
metrics, the driver hook, the watchdog thread).

The watchdog test stops and joins its monitor thread in teardown, and
waits at most about a second for a stall."""

import importlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from slate_tpu.obs import events as jevents
from slate_tpu.obs import export as jexport
from slate_tpu.obs import ledger as jledger
from slate_tpu.obs import metrics as jmetrics
from slate_tpu.obs import series as jseries

import slate_tpu_torch as st
from slate_tpu_torch import batch, obs
from slate_tpu_torch.obs import (events, export, health, ledger, metrics,
                                 reqtrace, series, xprof)
from slate_tpu_torch.resil import guard


def _reset_all():
    for mod in (ledger, reqtrace, series, jledger, jseries):
        mod.reset()
    health.reset()
    for ev, met in ((events, metrics), (jevents, jmetrics)):
        ev.disable()
        ev.clear()
        met.reset()
    xprof.clear_analyses()
    guard.reset_counts()


@pytest.fixture(autouse=True)
def clean():
    _reset_all()
    yield
    _reset_all()
    assert not health.thread_alive()


# -- the bus ------------------------------------------------------------------

def test_bus_kinds_ring_and_drain(monkeypatch):
    import collections
    events.publish("x")                          # off: nothing
    assert events.count() == 0
    events.enable()
    events.counter("queue.depth", 3)
    events.instant("mark", cat="trace", k=1)
    with events.span("work", cat="phase"):
        pass
    evs = events.events()
    assert [e.ph for e in evs] == [events.PH_COUNTER, events.PH_INSTANT,
                                   events.PH_SPAN]
    assert evs[0].args == {"value": 3} and evs[0].cat == "metric"
    assert evs[2].dur >= 0 and evs[2].thread == threading.current_thread().name
    assert [e.name for e in events.drain(("trace",))] == ["mark"]
    assert events.count() == 2
    monkeypatch.setattr(events, "EVENT_CAP", 2)
    monkeypatch.setattr(events, "_events", collections.deque(
        events.events(), maxlen=2))
    events.instant("a")
    events.instant("b")
    assert events.count() == 2 and events.dropped() == 2
    assert [e.name for e in events.drain()] == ["a", "b"]
    assert events.dropped() == 0 and events.count() == 0


def test_driver_hook_counts_calls_and_wall():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)) + 8 * np.eye(64)
    b = rng.standard_normal((64, 2))
    A = st.Matrix(a, mb=32, device="cpu")
    B = st.Matrix(b, mb=32, device="cpu")
    st.gesv(A, B)
    assert metrics.snapshot()["counters"] == {}      # off
    obs.enable()
    st.gesv(A, B)
    snap = metrics.snapshot()
    assert snap["counters"]["driver.gesv.calls"] == 1
    assert snap["counters"]["driver.getrf.calls"] == 1
    assert snap["histograms"]["gesv.wall_seconds"]["count"] == 1
    rep = obs.report()
    assert "driver.gesv.calls" in rep and "gesv" in rep


def test_counters_delta_matches_reference():
    for ev, met in ((events, metrics), (jevents, jmetrics)):
        ev.enable()
    seqs = [[("a", 1), ("b", 2)], [("a", 3)], [], [("c", 1), ("a", 1)]]
    got, ref = [], []
    for seq in seqs:
        for met, out in ((metrics, got), (jmetrics, ref)):
            for k, v in seq:
                met.inc(k, v)
            out.append((met.counters_delta("x"), met.counters_delta("y")))
    assert got == ref
    assert metrics.get_gauge("none", 7) == 7
    metrics.set_gauge("g", 1.5)
    assert metrics.get_gauge("g") == 1.5
    assert metrics.observe_concrete("v", torch.tensor(2.0))
    assert metrics.flag_concrete("f", torch.tensor(True))
    assert not metrics.observe_concrete("w", "not a number")
    snap = metrics.snapshot()
    assert snap["counters"]["f"] == 1 and snap["histograms"]["v"]["max"] == 2


# -- series -------------------------------------------------------------------

def test_quantile_sketch_and_exposition_match_reference():
    rng = np.random.default_rng(1)
    samples = np.exp(rng.normal(-4.0, 1.5, 2000))
    assert series.GAMMA == jseries.GAMMA and series.NBINS == jseries.NBINS
    tsk, jsk = series.QuantileSketch(), jseries.QuantileSketch()
    for v in samples:
        tsk.add(v)
        jsk.add(v)
    assert np.array_equal(tsk.bins, jsk.bins)
    for q in (0.5, 0.95, 0.99):
        assert tsk.quantile(q) == jsk.quantile(q)
        i = series.bin_index(np.percentile(samples, q * 100))
        assert abs(series.bin_index(tsk.quantile(q)) - i) <= 1
    series.enable()
    jseries.enable()
    for mod in (series, jseries):
        for i, v in enumerate(samples[:300]):
            mod.sample("serve.latency_s", v, tenant="t%d" % (i % 2),
                       op="potrf")
            mod.note_slo("t%d" % (i % 2), v)
    assert series.render_prometheus() == jseries.render_prometheus()
    assert series.snapshot() == jseries.snapshot()
    assert set(series.quantiles("serve.latency_s", "t0", "potrf")) == \
        {"p50", "p95", "p99"}


# -- the Perfetto export ------------------------------------------------------

def publish_same(t):
    """The same events into both buses, from this thread and from one
    worker thread."""
    for ev in (events, jevents):
        ev.publish("gesv", ev.PH_SPAN, t, t + 0.002, cat="driver",
                   args={"shape": "64x64"})
        ev.publish("mark", ev.PH_INSTANT, t + 0.001, cat="trace")
        ev.publish("batch.depth", ev.PH_COUNTER, t + 0.0015,
                   cat="metric", args={"value": 4})
        ev.publish("serve::request", ev.PH_SPAN, t, t + 0.003,
                   cat="serve", args={"trace_id": "abc", "span_id": "s1"})
        ev.publish("batch::flush", ev.PH_SPAN, t + 0.0005, t + 0.0025,
                   cat="serve", args={"trace_ids": ["abc"],
                                      "flush_id": 1})

    def worker():
        for ev in (events, jevents):
            ev.publish("stage", ev.PH_SPAN, t + 0.0002, t + 0.0004,
                       cat="trace")

    th = threading.Thread(target=worker, name="stage-worker")
    th.start()
    th.join()


@pytest.mark.parametrize("host", (None, 2))
def test_chrome_trace_matches_reference(host):
    """The same events (explicit times, the same threads) export to the
    same Trace Event Format object in both packages: kinds, flows, ts,
    and with host= the pid/tid namespacing and name metadata."""
    events.enable()
    jevents.enable()
    publish_same(time.perf_counter())
    got = export.chrome_trace(host=host, include_ledger=False)
    ref = jexport.chrome_trace(host=host, include_ledger=False)
    assert got == ref
    phs = sorted({r["ph"] for r in got["traceEvents"]})
    assert phs == ["C", "M", "X", "f", "i", "s"]
    if host is not None:
        tids = {r["tid"] for r in got["traceEvents"]}
        assert all(tid // export._HOST_TID_STRIDE == host for tid in tids)
        assert {r["pid"] for r in got["traceEvents"]} == {host}


def test_trace_includes_ledger_tracks(tmp_path):
    events.enable()
    ledger.enable()
    jledger.enable()
    for led in (ledger, jledger):
        led.append("batch.dispatch", 0, {"stage": 0.001, "factor": 0.002},
                   meta={"op": "potrf"})
    got = export.chrome_trace()
    ref = jexport.chrome_trace()
    names = sorted(r["name"] for r in got["traceEvents"])
    assert names == sorted(r["name"] for r in ref["traceEvents"]) == \
        ["ledger:batch.dispatch:factor", "ledger:batch.dispatch:stage"]
    path = export.write_trace(str(tmp_path / "run.json"))
    assert json.load(open(path))["traceEvents"] == got["traceEvents"]


# -- the flight recorder ------------------------------------------------------

def test_ledger_frames_sum_to_wall_and_spill(tmp_path):
    assert ledger.recorder("stream") is None          # FROZEN off
    ledger.append("batch.dispatch", 0, {"other": 1.0})
    assert ledger.count() == 0
    ledger.enable()
    with ledger.recorder("stream", nt=2, spill_dir=str(tmp_path)) as rec:
        for k in range(2):
            rec.begin(k)
            with ledger.frame("update"):
                with ledger.frame("stage"):
                    sum(range(2000))
                ledger.credit("cache", 0.0005)
            rec.commit(panel=k)
    recs = ledger.records("stream")
    assert [r.step for r in recs] == [0, 1]
    for r in recs:
        # exhaustive: what no frame claimed lands in "other"
        assert {"update", "stage", "cache"} <= set(r.phases) \
            <= set(ledger.PHASES)
        assert sum(r.phases.values()) >= r.wall - 1e-9
    lines = (tmp_path / "ledger.host0.jsonl").read_text().splitlines()
    assert [json.loads(s)["meta"]["panel"] for s in lines] == [0, 1]
    assert [r.step for r in ledger.tail("c")] == [0, 1]
    assert ledger.tail("c") == []
    att = xprof.attribute_run()
    assert att["records"] == 2 and "kernel" in att["buckets"]


# -- the queue's hooks --------------------------------------------------------

def test_queue_publishes_ledger_spans_and_metrics():
    rng = np.random.default_rng(2)
    sizes = (24, 40, 17, 33)
    spds = []
    for n in sizes:
        x = rng.standard_normal((n, n)).astype(np.float32)
        spds.append((x @ x.T / n + np.eye(n)).astype(np.float32))
    obs.enable()
    ledger.enable()
    reqtrace.enable()
    series.enable()
    with batch.CoalescingQueue(strategy="ragged", device="cpu") as q:
        ts = [q.submit("potrf", a, trace=reqtrace.begin(tenant="t",
                                                        op="potrf"))
              for a in spds]
        q.flush()
        [t.result(timeout=60) for t in ts]
    recs = ledger.records("batch.dispatch")
    assert len(recs) == 1 and recs[0].meta["occupancy"] == 4
    assert recs[0].meta["strategy"] == "ragged"
    assert set(recs[0].phases) == {"stage", "factor"}
    assert len(recs[0].meta["traces"]) == 4
    req = reqtrace.spans(reqtrace.REQUEST_SPAN)
    assert len(req) == 4 and all(s.args["flush_id"] == 1 for s in req)
    assert all({"queue_wait_s", "dispatch_s", "solve_s"} <= set(s.phases)
               for s in req)
    assert len(reqtrace.spans(reqtrace.FLUSH_SPAN)) == 1
    assert len(reqtrace.trace(req[0].trace_id)) == 1
    assert len(ledger.records("serve.request")) == 4
    snap = metrics.snapshot()
    assert snap["counters"]["batch.requests"] == 4
    assert snap["counters"]["batch.dispatches"] == 1
    assert snap["counters"]["batch.ragged_dispatches"] == 1
    assert snap["histograms"]["batch.occupancy"]["max"] == 4
    q50 = series.quantiles("serve.latency_s", "t", "potrf")
    assert q50["p50"] <= q50["p99"]
    tr = export.chrome_trace()
    assert {"s", "f"} <= {r["ph"] for r in tr["traceEvents"]}
    s = obs.snapshot()
    assert s["ledger"]["records"] == 5 and s["serve_series"]["series"]
    assert "critical path" in obs.report()


def test_reqtrace_activation_and_off_state():
    assert reqtrace.begin() is None
    with reqtrace.active(None):
        assert reqtrace.current() is None
    reqtrace.enable()
    root = reqtrace.begin(tenant="a", op="gesv")
    child = root.child("factor")
    with reqtrace.active(root):
        assert reqtrace.current_trace_id() == root.trace_id
        with reqtrace.active(child):
            assert reqtrace.current() is child
        assert reqtrace.current() is root
    assert reqtrace.current() is None
    child.finish()
    root.finish(error=ValueError("x"))
    assert [s.name for s in reqtrace.trace(root.trace_id)] == \
        ["factor", reqtrace.REQUEST_SPAN]
    assert root.args["error"] == "x"
    again = reqtrace.begin(parent={"trace": root.trace_id, "span": "p"})
    assert again.trace_id == root.trace_id and again.parent_id == "p"


# -- the watchdog -------------------------------------------------------------

def test_watchdog_flags_a_stall_and_stops():
    health.heartbeat("stream", 0, 4)              # off: no thread
    assert not health.thread_alive()
    obs.enable()
    health.enable(stall_factor=2.0, min_budget_s=0.05, interval_s=0.01,
                  escalate=True)
    try:
        assert health.thread_alive()
        for k in range(3):
            health.heartbeat("stream", k, 4)
        assert metrics.get_gauge("health.eta_seconds") is not None
        deadline = time.monotonic() + 1.0
        while health.stats()["stalls"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        st_ = health.stats()
        assert st_["stalls"] == 1 and st_["ops"]["stream"]["stalled"]
        assert guard.counts()["resil.fallback.watchdog_stall"] == 1
        ev = events.events(cat="health")
        assert ev and ev[0].args["op"] == "stream"
        health.heartbeat("stream", 3, 4)
        assert not health.stats()["ops"]["stream"]["stalled"]
        health.heartbeat("stream", 4, 4)          # completion beat
    finally:
        health.disable()
    assert not health.thread_alive()


# -- xprof and the report -----------------------------------------------------

def test_xprof_analyze_on_the_cpu():
    a = torch.randn(64, 48, dtype=torch.float64)
    b = torch.randn(48, 32, dtype=torch.float64)
    rec = xprof.analyze("mm", torch.matmul, a, b)
    assert rec["flops"] == 2 * 64 * 48 * 32
    assert rec["peak_bytes"] is None and rec["execute_seconds"] >= 0
    assert rec["collectives"] == xprof.collective_counts("") == \
        dict({k: 0 for k in xprof.COLLECTIVE_KINDS}, total=0)
    assert xprof.collective_counts(
        "all-reduce(x) all-gather-start(y) all-gather-done(y)") \
        ["total"] == 2
    A = st.Matrix(np.eye(64) * 2.0, mb=32, device="cpu")
    B = st.Matrix(np.ones((64, 1)), mb=32, device="cpu")
    rec = obs.analyze("gesv", st.gesv, A, B)
    # the library LU and solves are not counted (module doc)
    assert rec["flops"] >= 0 and "gesv" in xprof.analyses()
    text = obs.report()
    assert "per-call attribution" in text and "gesv" in text


# -- the surface --------------------------------------------------------------

#: public names of the reference's modules the port leaves out on
#: purpose (ROADMAP queue 1, "Left out on purpose"): XLA compile
#: accounting and compiled-program readers
LEFT_OUT = {"obs.metrics": {"install_jax_monitoring", "recompiles",
                            "record_trace", "Tuple"},
            "obs.xprof": {"cost_summary", "lower_compiled",
                          "memory_summary"}}


@pytest.mark.parametrize("sub", (
    "obs", "obs.events", "obs.metrics", "obs.ledger", "obs.export",
    "obs.health", "obs.report", "obs.reqtrace", "obs.series",
    "obs.xprof", "resil", "resil.faults", "resil.guard",
    "resil.checkpoint"))
def test_public_surface_matches_reference(sub):
    ref = importlib.import_module("slate_tpu." + sub)
    port = importlib.import_module("slate_tpu_torch." + sub)
    names = {k for k in dir(ref) if not k.startswith("_")}
    missing = names - {k for k in dir(port) if not k.startswith("_")}
    assert missing == LEFT_OUT.get(sub, set())


def test_obs_resil_spectral_import_no_jax():
    """obs, resil and the spectral D&C import neither jax nor slate_tpu
    (a fresh interpreter)."""
    code = ("import sys\n"
            "import slate_tpu_torch.obs, slate_tpu_torch.resil\n"
            "import slate_tpu_torch.linalg.spectral_dc\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'slate_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

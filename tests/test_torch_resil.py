"""slate_tpu_torch's resil/ (fault plans, the guard's retries and
escalation ladder, panel sentinels, checkpoints) against the JAX
package on the CPU, then the port's wiring: the batch queue's guarded
dispatch and its three fault sites, refine's ``mixed_to_full`` rung,
gesv_rbt's sentinel rung, the bitwise off state, and a non-transient
error that propagates without a retry.

Every test that starts a background flusher closes its queue and joins
the thread in teardown; no test sleeps."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from slate_tpu.resil import checkpoint as jckpt
from slate_tpu.resil import faults as jfaults
from slate_tpu.resil import guard as jguard

import slate_tpu_torch as st
from slate_tpu_torch import batch
from slate_tpu_torch.batch import drivers
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import ledger, metrics, reqtrace, series
from slate_tpu_torch.resil import checkpoint as tckpt
from slate_tpu_torch.resil import faults as tfaults
from slate_tpu_torch.resil import guard as tguard

BUDGET = {"retries": 2, "backoff_us": 0}


@pytest.fixture(autouse=True)
def clean():
    """Both packages' resil state off before and after each test."""
    for f, g in ((tfaults, tguard), (jfaults, jguard)):
        f.clear()
        g.reset_counts()
        g.enable_checks(False)
    yield
    for f, g in ((tfaults, tguard), (jfaults, jguard)):
        f.clear()
        g.reset_counts()
        g.enable_checks(False)
    for mod in (ledger, reqtrace, series):
        mod.reset()
    obs_events.disable()
    obs_events.clear()
    metrics.reset()


# -- fault plans --------------------------------------------------------------

PLAN = {"seed": 5, "faults": [
    {"site": "batch", "match": {"op": "gesv"}, "after": 1, "times": 3,
     "prob": 0.5, "kind": "error"},
    {"site": "batch_submit", "after": 0, "times": 40, "prob": 0.3,
     "kind": "nan"},
    {"site": "flusher", "match": {"busy": True}, "times": 2,
     "kind": "error"},
    {"site": "step", "match": {"host": 0}, "after": 2, "times": 1,
     "kind": "slow", "slow_s": 0.0}]}


def drive(faults_mod, plan):
    """One fixed call sequence through a plan; the injection log."""
    faults_mod.install(plan)
    for i in range(30):
        for site, ctx in (("batch", {"op": "gesv" if i % 2 else "posv"}),
                          ("batch_submit", {"op": "potrf"}),
                          ("flusher", {"busy": i % 3 == 0}),
                          ("step", {"op": "getrf", "step": i})):
            try:
                faults_mod.check(site, **ctx)
            except faults_mod.InjectedFault:
                pass
    faults_mod.clear()
    return plan.log(), plan.fired()


def test_fault_plan_json_round_trip_and_schema():
    plan = tfaults.FaultPlan.from_json(json.dumps(PLAN))
    again = tfaults.FaultPlan.from_json(plan.to_json())
    assert again.to_json() == plan.to_json()
    # the same schema as the reference's: its plan parses the port's JSON
    assert json.loads(jfaults.FaultPlan.from_json(plan.to_json())
                      .to_json()) == json.loads(plan.to_json())
    assert tfaults.SITES == jfaults.SITES
    with pytest.raises(ValueError, match="unknown kind"):
        tfaults.FaultPlan([{"site": "batch", "kind": "melt"}])
    env = tfaults.install_env_var(plan, {"A": "1"})
    assert env["A"] == "1" and env[tfaults.ENV_VAR] == plan.to_json()


def test_same_plan_and_seed_fire_at_the_same_occurrences():
    log_t, fired_t = drive(tfaults, tfaults.FaultPlan.from_json(
        json.dumps(PLAN)))
    log_j, fired_j = drive(jfaults, jfaults.FaultPlan.from_json(
        json.dumps(PLAN)))
    assert fired_t == fired_j > 4
    assert log_t == log_j
    kinds = {r["kind"] for r in log_t}
    assert kinds == {"error", "nan", "slow"}
    for r in range(4):
        assert tfaults.FaultPlan.from_json(json.dumps(PLAN))._roll(r, 7) \
            == jfaults.FaultPlan.from_json(json.dumps(PLAN))._roll(r, 7)


def test_install_from_env(monkeypatch):
    monkeypatch.setenv(tfaults.ENV_VAR, json.dumps(PLAN))
    plan = tfaults.install_from_env()
    assert tfaults.active() is plan and len(plan.rules) == 4
    monkeypatch.delenv(tfaults.ENV_VAR)
    tfaults.clear()
    assert tfaults.install_from_env() is None and tfaults.active() is None


# -- the guard ----------------------------------------------------------------

def guard_sequence(guard, faults):
    """retry / retry_after_failure / escalate / record_escalation on
    the same failures; returns the local counters."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("transfer stalled")
        return calls["n"]

    assert guard.retry(flaky, "h2d", **BUDGET) == 3
    calls["n"] = 0
    with pytest.raises(guard.RetriesExhausted):
        guard.retry(lambda: (_ for _ in ()).throw(
            faults.InjectedFault("batch", 0, 0, {})), "batch", **BUDGET)
    with pytest.raises(ValueError):
        guard.retry(lambda: (_ for _ in ()).throw(ValueError("bug")),
                    "batch", **BUDGET)
    calls["n"] = 1
    assert guard.retry_after_failure(flaky, "batch",
                                     TimeoutError("first"), **BUDGET) == 3
    assert guard.escalate(
        lambda: (_ for _ in ()).throw(ConnectionError("peer")),
        lambda: "fallback", "shard_to_stream") == "fallback"
    with pytest.raises(RuntimeError, match="cuda"):
        guard.escalate(lambda: (_ for _ in ()).throw(
            RuntimeError("cuda launch failed")), lambda: "x",
            "rbt_to_getrf")
    guard.record_escalation("mixed_to_full", kind="ir")
    return guard.counts()


def test_guard_counts_match_reference():
    got = guard_sequence(tguard, tfaults)
    ref = guard_sequence(jguard, jfaults)
    assert got == ref
    assert got["resil.retries"] == 6 and got["resil.fallbacks"] == 2
    assert tguard.TRANSIENT_TYPES[3:] == jguard.TRANSIENT_TYPES[3:] \
        == (TimeoutError, ConnectionError)
    assert [t.__name__ for t in tguard.TRANSIENT_TYPES] == \
        [t.__name__ for t in jguard.TRANSIENT_TYPES]
    assert tguard.ESCALATIONS == jguard.ESCALATIONS


def test_cuda_and_build_errors_are_not_transient():
    for e in (RuntimeError("CUDA error: an illegal memory access"),
              RuntimeError("CUDA kernel build failed"), OSError("ld"),
              torch.cuda.OutOfMemoryError("oom")):
        assert not tguard.is_transient(e)
    assert tguard.is_transient(tguard.RetriesExhausted("batch", 3,
                                                       TimeoutError()))


def sentinel_panels():
    rng = np.random.default_rng(9)
    ok = rng.standard_normal((16, 8))
    nan = ok.copy()
    nan[3, 2] = np.nan
    inf = ok.copy()
    inf[0, 0] = np.inf
    return [(ok, None), (nan, None), (inf, ok), (ok * 1e7, ok),
            (ok * 1e5, ok), (ok.astype(np.float32), ok)]


def test_check_panel_raises_on_the_same_panels():
    import jax.numpy as jnp
    for arr, ref in sentinel_panels():
        outcome = []
        for guard, conv in ((tguard, torch.as_tensor),
                            (jguard, jnp.asarray)):
            guard.check_panel("getrf", 1, conv(arr))     # off: no-op
            guard.enable_checks(True)
            try:
                guard.check_panel("getrf", 1, conv(arr),
                                  None if ref is None else conv(ref))
                outcome.append(None)
            except guard.PanelHealthError as e:
                outcome.append(e.reason.split(" ")[0])
            finally:
                guard.enable_checks(False)
        assert outcome[0] == outcome[1]
    assert tguard.counts()["resil.sentinels"] == \
        jguard.counts()["resil.sentinels"] == 3


# -- checkpoints --------------------------------------------------------------

def test_checkpointer_round_trip(tmp_path):
    a = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    assert tckpt.fingerprint(a) == jckpt.fingerprint(a)
    assert tckpt.maybe_checkpointer(None, "getrf_ooc", a, 16, 3) is None
    assert tckpt.maybe_checkpointer(str(tmp_path / "off"), "getrf_ooc", a,
                                    16, 3) is None      # frozen cadence 0
    path = str(tmp_path / "ck")
    ck = tckpt.maybe_checkpointer(path, "getrf_ooc", a, 16, 3, every=2,
                                  extra_arrays={"piv": ((48,), np.int32)})
    assert ck.epoch == 0 and ck.factor.shape == a.shape
    assert [ck.due(k) for k in range(3)] == [False, True, True]
    ck.factor[:, :32] = a[:, :32]
    ck.array("piv")[:32] = np.arange(32)
    ck.commit(2)
    assert tguard.counts()["resil.ckpt_commits"] == 1
    again = tckpt.maybe_checkpointer(path, "getrf_ooc", a, 16, 3, every=2,
                                     extra_arrays={"piv": ((48,),
                                                           np.int32)})
    assert again.epoch == 2 and not again.complete
    assert np.array_equal(again.factor[:, :32], a[:, :32])
    assert np.array_equal(again.array("piv")[:32], np.arange(32))
    # the reference resumes the port's checkpoint at the same epoch
    ref = jckpt.maybe_checkpointer(path, "getrf_ooc", a, 16, 3, every=2,
                                   extra_arrays={"piv": ((48,), np.int32)})
    assert ref.epoch == 2
    assert again.bytes_on_disk() > a.nbytes
    # another matrix (or driver) starts fresh
    other = tckpt.maybe_checkpointer(path, "getrf_ooc", a + 1, 16, 3,
                                     every=2, extra_arrays={
                                         "piv": ((48,), np.int32)})
    assert other.epoch == 0


# -- the batch queue ----------------------------------------------------------

def serve_problems(seed=0, k=6):
    rng = np.random.default_rng(seed)
    sizes = [24, 40, 17, 33, 40, 9][:k]
    mats, spds, rhss = [], [], []
    for n in sizes:
        x = rng.standard_normal((n, n)).astype(np.float32)
        mats.append(x + np.float32(2 * np.sqrt(n)) * np.eye(n,
                                                            dtype=np.float32))
        spds.append((x @ x.T / n + np.eye(n)).astype(np.float32))
        rhss.append(rng.standard_normal((n, 1)).astype(np.float32))
    return mats, spds, rhss


def run_queue(strategy, reqs, trace=False, **kw):
    """Submit (op, a, b) requests through one queue; CPU results."""
    with batch.CoalescingQueue(strategy=strategy, device="cpu", **kw) as q:
        ts = [q.submit(op, a, b, trace=reqtrace.begin(tenant="t", op=op)
                       if trace else None) for op, a, b in reqs]
        q.flush()
        out = [t.result(timeout=60) for t in ts]
        return out, q.stats()


def requests():
    mats, spds, rhss = serve_problems()
    return [("gesv", a, b) for a, b in zip(mats, rhss)] \
        + [("posv", a, b) for a, b in zip(spds, rhss)] \
        + [("potrf", a, None) for a in spds]


def same(xs, ys):
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


@pytest.mark.parametrize("strategy", ("bucket", "ragged"))
def test_batch_site_fault_is_retried_bitwise(strategy):
    clean, _ = run_queue(strategy, requests())
    plan = tfaults.install(tfaults.FaultPlan(
        [{"site": "batch", "after": 1, "times": 1, "kind": "error"}]))
    faulted, stats = run_queue(strategy, requests())
    assert plan.fired() == 1 and plan.log()[0]["occurrence"] == 1
    assert tguard.counts() == {"resil.retries": 1}
    assert same(faulted, clean)
    assert stats["dispatches"] >= 3


def test_batch_submit_site_fault_resubmitted_bitwise():
    reqs = requests()
    clean, _ = run_queue("ragged", reqs)
    plan = tfaults.install(tfaults.FaultPlan(
        [{"site": "batch_submit", "match": {"op": "posv"}, "after": 2,
          "times": 1, "kind": "error"}]))
    with batch.CoalescingQueue(strategy="ragged", device="cpu") as q:
        ts = [tguard.retry(lambda: q.submit(op, a, b), "batch_submit",
                           op=op, **BUDGET) for op, a, b in reqs]
        out = [t.result(timeout=60) for t in ts]
    assert plan.fired() == 1 and plan.log()[0]["ctx"] == {"op": "posv"}
    assert tguard.counts() == {"resil.retries": 1}
    assert same(out, clean)


def test_flusher_site_fault_kills_the_flusher_then_sync_bitwise():
    """An injected error at the flusher's busy tick kills the background
    flusher: the pending tickets fail with its death error, the death is
    counted, and the queue's synchronous mode serves the resubmitted
    requests bitwise."""
    reqs = requests()
    clean, _ = run_queue("ragged", reqs)
    plan = tfaults.install(tfaults.FaultPlan(
        [{"site": "flusher", "match": {"busy": True}, "kind": "error"}]))
    q = batch.CoalescingQueue(strategy="ragged", device="cpu",
                              background=True, max_batch=1000,
                              max_wait_us=10 ** 7)
    try:
        t0 = q.submit(*reqs[0])
        q._flusher.join(timeout=30)
        assert not q._flusher.is_alive() and plan.fired() == 1
        assert t0.done()
        with pytest.raises(RuntimeError, match="flusher died") as ei:
            t0.result(timeout=1)
        assert isinstance(ei.value.__cause__, tfaults.InjectedFault)
        assert tguard.counts() == {"resil.flusher_deaths": 1}
        out = [q.submit(op, a, b).result(timeout=60) for op, a, b in reqs]
    finally:
        q.close()
    assert not q._flusher.is_alive()
    assert same(out, clean)


def test_non_transient_dispatch_error_propagates_unretried(monkeypatch):
    """A RuntimeError from the dispatch function (what a CUDA or launch
    error raises) fails every co-batched ticket and is never retried,
    with or without a fault plan."""
    _mats, spds, _ = serve_problems()
    calls = []

    def broken(op, stack, rhs=None, **kw):
        calls.append(op)
        raise RuntimeError("ragged_potrf: cudaError_t 700")

    monkeypatch.setattr(drivers, "_dispatch", broken)
    for plan in (None, tfaults.FaultPlan(
            [{"site": "batch", "match": {"op": "gesv"}}])):
        tfaults.install(plan)
        calls.clear()
        with batch.CoalescingQueue(strategy="bucket", device="cpu",
                                   max_batch=64) as q:
            ts = [q.submit("potrf", a) for a in spds[:3]]
            q.flush()
        for t in ts:
            with pytest.raises(RuntimeError, match="cudaError_t 700"):
                t.result(timeout=1)
        # one call a dispatch: nothing was retried
        assert len(calls) == q.stats()["dispatches"] >= 1
        assert tguard.counts() == {}


def test_off_state_is_bitwise_and_records_nothing(monkeypatch):
    """With obs and resil off a flush records nothing and its results
    are bitwise the direct dispatch's (the unguarded path); gesv and
    posv give bitwise the same factors and solutions with everything
    off and with everything on (bus, ledger, traces, series, an armed
    plan that never fires)."""
    mats, spds, rhss = serve_problems()
    sizes = [a.shape[0] for a in spds]
    out, _ = run_queue("ragged", [("potrf", a, None) for a in spds])
    ceil = batch.bucket.ragged_ceiling(
        sizes, blk=st.ops.kernels.ragged_blk(),
        align=batch.bucket.batch_align())
    stack = torch.zeros((len(spds), ceil, ceil))
    for i, a in enumerate(spds):
        stack[i, :a.shape[0], :a.shape[0]] = torch.as_tensor(a)
    direct = drivers.ragged_dispatch(
        "potrf", stack, torch.tensor(sizes, dtype=torch.int32),
        blk=st.ops.kernels.ragged_blk(), donate=True, device="cpu")
    assert all(torch.equal(o, direct[i, :n, :n])
               for i, (o, n) in enumerate(zip(out, sizes)))
    assert ledger.count() == 0 and reqtrace.count() == 0
    assert obs_events.count() == 0 and metrics.snapshot()["counters"] == {}

    def solves():
        a, b = mats[1], rhss[1]
        A = st.Matrix(np.kron(np.eye(4, dtype=np.float32), a), mb=32,
                      device="cpu")
        B = st.Matrix(np.tile(b, (4, 1)), mb=32, device="cpu")
        F, X = st.gesv(A, B)
        S = st.HermitianMatrix(
            st.Uplo.Lower, np.kron(np.eye(4, dtype=np.float32), spds[1]),
            mb=32, device="cpu")
        Fp, Xp = st.posv(S, B)
        q, _ = run_queue("ragged", [("gesv", a, b) for a, b in
                                    zip(mats, rhss)], trace=True)
        return [F.LU.data, F.pivots, X.data, Xp.data] + q

    off = solves()
    assert tguard.counts() == {} and ledger.count() == 0
    obs_events.enable()
    ledger.enable()
    reqtrace.enable()
    series.enable()
    tfaults.install(tfaults.FaultPlan([{"site": "batch",
                                        "match": {"op": "svd"}}]))
    on = solves()
    assert same(on, off)
    assert ledger.records("batch.dispatch") and reqtrace.spans()
    assert metrics.snapshot()["counters"]["driver.gesv.calls"] == 1


# -- the drivers' rungs -------------------------------------------------------

def test_refine_fallback_counts_mixed_to_full():
    rng = np.random.default_rng(3)
    n = 128
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((q1 * np.logspace(0, -6, n)) @ q2.T).astype(np.float32)
    b = rng.standard_normal((n, 1)).astype(np.float32)
    opts = {st.Option.MaxIterations: 0}
    A = st.Matrix(a, mb=32, device="cpu")
    B = st.Matrix(b, mb=32, device="cpu")
    _, _, iters = st.gesv_mixed(A, B, opts)       # obs off: no count
    assert iters < 0 and tguard.counts() == {}
    obs_events.enable()
    _, _, iters = st.gesv_mixed(A, B, opts)
    c = metrics.snapshot()
    assert tguard.counts() == {"resil.fallback.mixed_to_full": 1,
                               "resil.fallbacks": 1}
    assert c["counters"]["refine.ir.calls"] == 1
    assert c["counters"]["refine.ir.fallback"] == 1
    assert c["counters"]["resil.fallback.mixed_to_full"] == 1
    assert c["histograms"]["refine.ir.iters"]["max"] == -iters - 1
    evs = obs_events.events(cat="resil")
    assert [e.name for e in evs] == ["resil::fallback"]
    assert evs[0].args["rung"] == "mixed_to_full"


def test_gesv_rbt_sentinel_rung(monkeypatch):
    """A breakdown of gesv_rbt's no-pivot factor (non-finite solution)
    steps down to partial-pivot gesv with the sentinels on; off, the
    poisoned solution comes back and nothing is counted."""
    rng = np.random.default_rng(4)
    n = 32
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 1))
    A = st.Matrix(a, mb=16, device="cpu")
    B = st.Matrix(b, mb=16, device="cpu")
    orig = tlu.getrf_nopiv

    def poisoned(Am, opts=None):
        F = orig(Am, opts)
        r = F.LU.resolve()
        return F._replace(LU=dataclasses.replace(r, data=r.data * np.nan))

    monkeypatch.setattr(tlu, "getrf_nopiv", poisoned)
    _, X = tlu.gesv_rbt(A, B)
    assert not torch.isfinite(X.data).all() and tguard.counts() == {}
    tguard.enable_checks(True)
    F, X = tlu.gesv_rbt(A, B)
    x = X.to_dense().numpy()[:n]
    assert np.all(np.isfinite(x))
    assert np.allclose(a @ x, b, atol=1e-8)
    assert tguard.counts()["resil.fallback.rbt_to_getrf"] == 1
    _, Xg = st.gesv(A, B)
    assert torch.equal(X.data, Xg.data)
    # a healthy solve passes the sentinel untouched
    monkeypatch.setattr(tlu, "getrf_nopiv", orig)
    tguard.reset_counts()
    _, X = tlu.gesv_rbt(A, B)
    assert tguard.counts() == {}

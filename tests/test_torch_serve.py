"""slate_tpu_torch.serve against the JAX package's serving daemon on the
CPU (the counterpart of tests/test_serve.py and of the Server / RPC
tests of tests/test_reqtrace.py).

Each twin runs the reference's scenario through the port (device="cpu")
and, where the scenario has a result, the same seeded inputs through
the reference: f64 results agree to rtol 1e-10 / atol 1e-12, f32 to
1e-5; decisions, counts, cache stats and escalation / ledger keys are
equal. The port's own contracts (cold route bitwise direct queue use,
cache hits bitwise the fused dispatch) are held bitwise. Every server,
socket and thread is closed in a finally (or a with), and every wait
has a timeout."""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from slate_tpu import obs as jobs
from slate_tpu import serve as jserve
from slate_tpu.batch import drivers as jdrivers
from slate_tpu.batch import queue as jbq
from slate_tpu.obs import events as joe
from slate_tpu.obs import ledger as jledger
from slate_tpu.obs import metrics as jom
from slate_tpu.obs import reqtrace as jreqtrace
from slate_tpu.obs import series as jseries
from slate_tpu.resil import faults as jfaults
from slate_tpu.resil import guard as jguard
from slate_tpu.resil.checkpoint import fingerprint as jfingerprint
from slate_tpu.serve import rpc as jrpc
from slate_tpu.serve.admission import AdmissionController as JAdmission
from slate_tpu.serve.admission import TenantConfig as JTenant
from slate_tpu.serve.cache import FactorCache as JFactorCache
from slate_tpu.serve.server import _apply_pivots as j_apply_pivots
from slate_tpu.tune import cache as jcache

from slate_tpu_torch import obs, serve
from slate_tpu_torch.batch import drivers
from slate_tpu_torch.batch import queue as bq
from slate_tpu_torch.dist import elastic
from slate_tpu_torch.obs import events as oe
from slate_tpu_torch.obs import ledger as oledger
from slate_tpu_torch.obs import metrics as om
from slate_tpu_torch.obs import reqtrace, series
from slate_tpu_torch.resil import faults, guard
from slate_tpu_torch.resil.checkpoint import fingerprint
from slate_tpu_torch.serve import rpc as srpc
from slate_tpu_torch.serve.admission import (ADMIT, DEGRADE, REJECT, SHED,
                                             AdmissionController,
                                             TenantConfig)
from slate_tpu_torch.serve.cache import FactorCache
from slate_tpu_torch.serve.server import _apply_pivots
from slate_tpu_torch.tune import cache as tcache

F64 = dict(rtol=1e-10, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)
T = 60          # seconds: every result() / join() in this file


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    """Isolated tune caches; no process-wide obs / resil state left
    behind by either package."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    yield
    for f, g, o, m, rt, se, le, ev in (
            (faults, guard, obs, om, reqtrace, series, oledger, oe),
            (jfaults, jguard, jobs, jom, jreqtrace, jseries, jledger,
             joe)):
        f.clear()
        g.reset_counts()
        rt.reset()
        se.reset()
        le.reset()
        o.disable()
        ev.clear()
        m.reset()
    tcache.reset_cache()
    jcache.reset_cache()


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T + 2.0 * n * np.eye(n, dtype=dtype)


def _gen(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(dtype)


def _rhs(n, k=2, dtype=np.float64, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, k)).astype(dtype)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _queue(**kw):
    return bq.CoalescingQueue(device="cpu", **kw)


def _server(**kw):
    """The reference tests' Server over a non-background queue."""
    return serve.Server(queue=_queue(background=False), **kw)


def _jserver(**kw):
    return jserve.Server(queue=jbq.CoalescingQueue(background=False),
                         **kw)


def _fused_ref(op, a, b=None):
    """The fused single-dispatch result through a direct port queue."""
    with _queue(background=False) as q:
        t = q.submit(op, a, b)
        q.flush()
        return t.result(timeout=T)


def _jfused(op, a, b=None):
    """The same through the reference's queue (the yardstick)."""
    with jbq.CoalescingQueue(background=False) as q:
        t = q.submit(op, a, b)
        q.flush()
        return _np(t.result(timeout=T))


# -- solve-only drivers (the cache's dispatch target) ---------------------

def test_potrs_batched_bitwise_vs_posv():
    n = 48
    spds = np.stack([_spd(n, seed=s) for s in range(3)])
    rhss = np.stack([_rhs(n, seed=s) for s in range(3)])
    ls = drivers.potrf_batched(spds, device="cpu")
    xs = drivers.potrs_batched(ls, rhss, device="cpu")
    fused = drivers.posv_batched(spds, rhss, device="cpu")
    assert torch.equal(xs, fused)
    np.testing.assert_allclose(
        _np(xs), np.asarray(jdrivers.posv_batched(spds, rhss)), **F64)


def test_getrs_batched_bitwise_vs_gesv():
    n = 48
    mats = np.stack([_gen(n, seed=s) for s in range(3)])
    rhss = np.stack([_rhs(n, seed=s) for s in range(3)])
    lu, piv = drivers.getrf_batched(mats, device="cpu")
    bp = torch.stack([_apply_pivots(torch.from_numpy(rhss[i]), piv[i])
                      for i in range(len(mats))])
    xs = drivers.getrs_batched(lu, bp, device="cpu")
    fused = drivers.gesv_batched(mats, rhss, device="cpu")
    assert torch.equal(xs, fused)
    jlu, jpiv = jdrivers.getrf_batched(mats)
    assert np.array_equal(_np(piv), np.asarray(jpiv))
    # the host gather is the reference's, element for element
    for i in range(len(mats)):
        assert np.array_equal(
            _np(_apply_pivots(torch.from_numpy(rhss[i]), piv[i])),
            j_apply_pivots(rhss[i], np.asarray(jpiv)[i]))
    np.testing.assert_allclose(
        _np(xs), np.asarray(jdrivers.gesv_batched(mats, rhss)), **F64)


def test_solve_only_ragged_strategy_allclose():
    sizes = [24, 40, 56]
    spds = [_spd(n, seed=n) for n in sizes]
    rhss = [_rhs(n, seed=n) for n in sizes]
    ls = [np.linalg.cholesky(a) for a in spds]
    with _queue(background=False, strategy="ragged") as q:
        ts = [q.submit("potrs", l, b) for l, b in zip(ls, rhss)]
        q.flush()
        outs = [_np(t.result(timeout=T)) for t in ts]
    assert q.stats()["ragged_dispatches"] == 1
    for n, o, l, b in zip(sizes, outs, ls, rhss):
        np.testing.assert_allclose(o, _jfused("potrs", l, b), **F64)
        np.testing.assert_allclose(o, np.linalg.solve(l @ l.T, b),
                                   rtol=1e-9, atol=1e-9)


# -- cold route -----------------------------------------------------------

def test_cold_route_bitwise_vs_direct_queue():
    n = 40
    spd, b = _spd(n), _rhs(n)
    srv = serve.Server(cache_mb=0, max_wait_us=100, device="cpu")
    try:
        assert srv.cache is None
        for op, aa, bb in (("posv", spd, b), ("potrf", spd, None),
                           ("gesv", _gen(n), b)):
            out = srv.submit(op, aa, bb).result(timeout=T)
            assert torch.equal(out, _fused_ref(op, aa, bb)), op
            np.testing.assert_allclose(_np(out), _jfused(op, aa, bb),
                                       **F64)
    finally:
        srv.close()


# -- factor cache ---------------------------------------------------------

def _repeat(pkg, op, a, bs, **srv_kw):
    """The reference tests' repeat scenario through `pkg`'s Server:
    one request per rhs in `bs` against the same operator. Returns the
    results, the tickets' cache outcomes, the queue's dispatch counts
    after each request and the cache stats."""
    srv = pkg.Server(cache_mb=16, max_wait_us=100, **srv_kw)
    try:
        outs, cache, disp = [], [], []
        for b in bs:
            t = srv.submit(op, a, b)
            outs.append(_np(t.result(timeout=T)))
            cache.append(t.cache)
            disp.append(srv._queue.stats()["dispatches"])
        return outs, cache, disp, srv.cache.stats()
    finally:
        srv.close()


def test_repeat_posv_hits_cache_and_stays_bitwise():
    n = 40
    spd, b1, b2 = _spd(n), _rhs(n, seed=1), _rhs(n, seed=2)
    outs, cache, disp, stats = _repeat(serve, "posv", spd, [b1, b2],
                                       device="cpu")
    assert cache == ["miss", "hit"]
    # the hit added exactly ONE dispatch (potrs): no refactor
    assert disp[1] == disp[0] + 1
    assert np.array_equal(outs[0], _np(_fused_ref("posv", spd, b1)))
    assert np.array_equal(outs[1], _np(_fused_ref("posv", spd, b2)))
    assert stats["hits"] == 1
    jouts, jcache_, jdisp, jstats = _repeat(jserve, "posv", spd, [b1, b2])
    assert (cache, disp, stats) == (jcache_, jdisp, jstats)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o, j, **F64)


def test_repeat_gesv_hits_cache_and_stays_bitwise():
    n = 40
    a, b1, b2 = _gen(n), _rhs(n, seed=3), _rhs(n, seed=4)
    outs, cache, disp, stats = _repeat(serve, "gesv", a, [b1, b2],
                                       device="cpu")
    assert cache[1] == "hit"
    assert np.array_equal(outs[0], _np(_fused_ref("gesv", a, b1)))
    assert np.array_equal(outs[1], _np(_fused_ref("gesv", a, b2)))
    jouts, jcache_, jdisp, jstats = _repeat(jserve, "gesv", a, [b1, b2])
    assert (cache, disp, stats) == (jcache_, jdisp, jstats)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o, j, **F64)


@pytest.mark.parametrize("op", ["posv", "gesv"])
def test_ragged_repeat_hits_bitwise_fused(op):
    """Under the ragged strategy a hit runs the solve-only ragged stream
    (the ragged getrf's swap targets applied on the host, the reference's
    convention): bitwise the fused ragged dispatch of the same flush."""
    sizes = (24, 40, 56)
    mats = [(_spd if op == "posv" else _gen)(n, seed=n) for n in sizes]
    bs = [[_rhs(n, k=1, seed=n + r) for n in sizes] for r in range(2)]

    def fused(r):
        with _queue(background=False, strategy="ragged") as q:
            ts = [q.submit(op, a, b) for a, b in zip(mats, bs[r])]
            q.flush()
            return [t.result(timeout=T) for t in ts]

    srv = serve.Server(queue=_queue(background=False, strategy="ragged"),
                       cache_mb=16)
    try:
        for r in range(2):
            ts = [srv.submit(op, a, b) for a, b in zip(mats, bs[r])]
            outs = [t.result(timeout=T) for t in ts]
            assert [t.cache for t in ts] == ["miss" if r == 0 else "hit"] \
                * len(sizes)
            for o, f, a, b in zip(outs, fused(r), mats, bs[r]):
                assert torch.equal(o, f)
                np.testing.assert_allclose(_np(o), _jfused(op, a, b),
                                           **F64)
        assert srv._queue.stats()["ragged_dispatches"] >= 3
    finally:
        srv.close()


def test_potrf_hit_served_from_cache_with_zero_dispatches():
    """The reference hands the write-protected cached buffer itself;
    torch has no read-only tensors, so the port hands a clone: writing
    into a returned factor leaves the next hit unchanged."""
    n = 40
    spd = _spd(n)
    srv = serve.Server(cache_mb=16, max_wait_us=100, device="cpu")
    try:
        l1 = srv.submit("potrf", spd).result(timeout=T)
        d0 = srv._queue.stats()["dispatches"]
        t2 = srv.submit("potrf", spd)
        l2 = t2.result(timeout=T)
        assert t2.cache == "hit"
        assert srv._queue.stats()["dispatches"] == d0
        assert torch.equal(l1, l2)
        key = ("chol", fingerprint(torch.from_numpy(spd)))
        assert l2.data_ptr() != srv.cache.peek(key)[0].data_ptr()
        l1[0, 0] = l2[0, 0] = 7.0
        l3 = srv.submit("potrf", spd).result(timeout=T)
        assert torch.equal(l3, _fused_ref("potrf", spd))
        np.testing.assert_allclose(_np(l3), _jfused("potrf", spd), **F64)
        assert srv.cache.stats()["hits"] == 2
    finally:
        srv.close()


def test_getrf_hit_hands_clones():
    n = 32
    a = _gen(n)
    srv = serve.Server(cache_mb=16, max_wait_us=100, device="cpu")
    try:
        lu1, piv1 = srv.submit("getrf", a).result(timeout=T)
        lu2, piv2 = srv.submit("getrf", a).result(timeout=T)
        assert torch.equal(lu1, lu2) and torch.equal(piv1, piv2)
        lu2.zero_()
        piv2.zero_()
        lu3, piv3 = srv.submit("getrf", a).result(timeout=T)
        assert torch.equal(lu3, lu1) and torch.equal(piv3, piv1)
        jlu, jpiv = _jfused("getrf", a)
        assert np.array_equal(_np(piv3), jpiv)
        np.testing.assert_allclose(_np(lu3), jlu, **F64)
    finally:
        srv.close()


def test_cache_families_do_not_collide():
    n = 32
    a = _spd(n)
    b = _rhs(n)
    srv = serve.Server(cache_mb=16, max_wait_us=100, device="cpu")
    try:
        rp = srv.submit("posv", a, b).result(timeout=T)
        rg = srv.submit("gesv", a, b).result(timeout=T)
        assert srv.cache.stats()["entries"] == 2
        assert torch.equal(rp, _fused_ref("posv", a, b))
        assert torch.equal(rg, _fused_ref("gesv", a, b))
        np.testing.assert_allclose(_np(rp), _jfused("posv", a, b), **F64)
        np.testing.assert_allclose(_np(rg), _jfused("gesv", a, b), **F64)
    finally:
        srv.close()


def test_concurrent_misses_share_one_factorization():
    n = 32
    spd = _spd(n)
    bs = [_rhs(n, seed=s) for s in range(6)]
    srv = serve.Server(cache_mb=16, max_wait_us=2000, device="cpu")
    try:
        tickets = [None] * len(bs)

        def go(i):
            tickets[i] = srv.submit("posv", spd, bs[i])

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(bs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
        assert not any(t.is_alive() for t in threads)
        outs = [_np(t.result(timeout=T)) for t in tickets]
        assert srv.cache.stats()["entries"] == 1
        assert srv.stats()["cache"]["misses"] >= 1
        for b, o in zip(bs, outs):
            np.testing.assert_allclose(o, _jfused("posv", spd, b), **F64)
    finally:
        srv.close()


def _lru_script(cache_cls):
    f1 = (np.ones((64, 64)),)                      # 32 KiB each
    c = cache_cls(budget_mb=0.07)                  # fits two, not 3
    log = [c.put(("chol", "a"), f1), c.put(("chol", "b"), f1),
           c.get(("chol", "a")) is not None, c.put(("chol", "c"), f1),
           c.get(("chol", "b")) is None, c.get(("chol", "a")) is not None,
           c.stats()]
    # an entry bigger than the whole budget is refused, evicting nothing
    log += [c.put(("chol", "huge"), (np.ones((512, 512)),)), c.stats()]
    return c, log


def test_factor_cache_lru_eviction_and_oversize():
    c, log = _lru_script(FactorCache)
    assert log[:6] == [0, 0, True, 1, True, True]
    assert log[6]["evictions"] == 1 and log[6]["entries"] == 2
    assert log[7] == 0 and log[8]["entries"] == 2
    _jc, jlog = _lru_script(JFactorCache)
    assert log == jlog
    # put stores a copy: writing into the caller's array later leaves
    # the entry unchanged
    src = np.ones((8, 8))
    c.put(("lu", "x"), (src,))
    src[0, 0] = 7.0
    assert float(c.peek(("lu", "x"))[0][0, 0]) == 1.0


# -- admission ------------------------------------------------------------

def _quota_script(pkg, **kw):
    n = 24
    srv = pkg.Server(cache_mb=0, max_wait_us=10**6,
                     tenants=[pkg.TenantConfig("capped", max_pending=1)],
                     **kw)
    g = guard if pkg is serve else jguard
    g.reset_counts()
    try:
        t1 = srv.submit("potrf", _spd(n), tenant="capped")
        with pytest.raises(pkg.ServeRejected) as ei:
            srv.submit("potrf", _spd(n, seed=1), tenant="capped")
        out = [ei.value.decision, g.counts(), srv.admission.counts()]
        r1 = _np(t1.result(timeout=T))
        r2 = _np(srv.submit("potrf", _spd(n, seed=2),
                            tenant="capped").result(timeout=T))
        return out, (r1, r2)
    finally:
        srv.close()


def test_quota_reject_rides_the_escalation_funnel():
    out, res = _quota_script(serve, device="cpu")
    assert out[0] == REJECT
    assert out[1]["resil.fallback.serve_reject"] == 1
    assert out[2]["reject"] == 1
    jout, jres = _quota_script(jserve)
    assert out == jout
    for r, j in zip(res, jres):
        np.testing.assert_allclose(r, j, **F64)


def _ladder(ctrl_cls, tenant_cls, queue, f64, f32):
    ac = ctrl_cls(queue, shed_eta_s=10, max_queue_age_ms=100)
    tenants = [tenant_cls("bg", priority="batch"), tenant_cls("std"),
               tenant_cls("ui", priority="interactive"),
               tenant_cls("frozen", degradable=False)]
    pressures = [{"eta_s": None, "oldest_age_s": 0.0},
                 {"eta_s": 99.0, "oldest_age_s": 0.0},
                 {"eta_s": None, "oldest_age_s": 0.5},
                 {"eta_s": 99.0, "oldest_age_s": 0.5}]
    return [ac.decide(t, "posv", dt, inflight, p)
            for t in tenants for dt in (f64, f32)
            for inflight in (0, 10**9) for p in pressures]


def test_decision_ladder_on_fabricated_pressure():
    with _queue(background=False) as q:
        ac = AdmissionController(q, shed_eta_s=10, max_queue_age_ms=100)
        batch_t = TenantConfig("bg", priority="batch")
        std = TenantConfig("std")
        inter = TenantConfig("ui", priority="interactive")
        frozen = TenantConfig("frozen", degradable=False)
        calm = {"eta_s": None, "oldest_age_s": 0.0}
        backlog = {"eta_s": 99.0, "oldest_age_s": 0.0}
        aged = {"eta_s": None, "oldest_age_s": 0.5}
        f64, f32 = torch.float64, torch.float32
        assert ac.decide(std, "posv", f64, 0, calm) == ADMIT
        assert ac.decide(batch_t, "posv", f64, 0, backlog) == SHED
        assert ac.decide(std, "posv", f64, 0, backlog) == ADMIT
        assert ac.decide(std, "posv", f64, 0, aged) == DEGRADE
        assert ac.decide(std, "posv", f32, 0, aged) == ADMIT
        assert ac.decide(inter, "posv", f64, 0, aged) == ADMIT
        assert ac.decide(frozen, "posv", f64, 0, aged) == ADMIT
        assert ac.decide(std, "posv", f64, 10**9, calm) == REJECT
        got = _ladder(AdmissionController, TenantConfig, q,
                      torch.float64, torch.float32)
        # numpy dtypes read the same as torch ones
        assert got == _ladder(AdmissionController, TenantConfig, q,
                              np.float64, np.float32)
    with jbq.CoalescingQueue(background=False) as jq:
        assert got == _ladder(JAdmission, JTenant, jq, np.float64,
                              np.float32)


def _shed_script(pkg, o, m, g, **kw):
    n = 24
    o.enable()
    g.reset_counts()
    m.set_gauge("health.eta_seconds", 10**6)
    srv = pkg.Server(cache_mb=0, max_wait_us=10**6,
                     tenants=[pkg.TenantConfig("bg", priority="batch")],
                     **kw)
    try:
        with pytest.raises(pkg.ServeRejected) as ei:
            srv.submit("potrf", _spd(n), tenant="bg")
        out = [ei.value.decision, g.counts(),
               m.snapshot()["counters"]["serve.shed"]]
        r = _np(srv.submit("potrf", _spd(n)).result(timeout=T))
        out.append(m.snapshot()["counters"]["serve.admitted"])
        return out, r
    finally:
        srv.close()
        o.disable()


def test_shed_decision_reads_watchdog_eta_gauge():
    out, r = _shed_script(serve, obs, om, guard, device="cpu")
    assert out[0] == SHED
    assert out[1]["resil.fallback.serve_shed"] == 1
    assert out[2] == 1 and out[3] == 1
    jout, jr = _shed_script(jserve, jobs, jom, jguard)
    assert out == jout
    np.testing.assert_allclose(r, jr, **F64)


def test_degraded_request_served_in_f32():
    n = 24
    guard.reset_counts()
    srv = serve.Server(cache_mb=0, max_wait_us=10**6, max_batch=64,
                       device="cpu")
    srv.admission.max_queue_age_s = 0.05
    try:
        parked = srv.submit("potrf", _spd(n, seed=9))
        time.sleep(0.08)
        t = srv.submit("posv", _spd(n), _rhs(n))
        assert t.decision == DEGRADE
        out = t.result(timeout=T)
        assert out.dtype == torch.float32
        assert guard.counts()["resil.fallback.serve_degrade"] == 1
        parked.result(timeout=T)
    finally:
        srv.close()
    np.testing.assert_allclose(
        _np(out), _jfused("posv", _spd(n).astype(np.float32),
                          _rhs(n).astype(np.float32)), **F32)


def test_escalation_payload_carries_the_remap_mirror():
    """Every non-admit carries the elastic mirror's keys; on one device
    it reads zeros, as the reference's does."""
    assert elastic.remap_records() == {"remaps": 0, "panels_moved": 0,
                                       "shrinks": 0, "last": None}
    payloads = []
    for pkg, o, ev, cat in ((serve, obs, oe, "resil"),
                            (jserve, jobs, joe, "resil")):
        o.enable()
        srv = pkg.Server(cache_mb=0, max_wait_us=10**6,
                         tenants=[pkg.TenantConfig("capped",
                                                   max_pending=0)],
                         **({"device": "cpu"} if pkg is serve else {}))
        try:
            with pytest.raises(pkg.ServeRejected):
                srv.submit("potrf", _spd(8), tenant="capped")
        finally:
            srv.close()
        fb = [e.args for e in ev.events(cat=cat)
              if e.name == "resil::fallback"]
        o.disable()
        payloads.append(fb)
    assert payloads[0] == payloads[1]
    assert payloads[0][0]["mesh_remaps"] == 0


# -- drain / faults -------------------------------------------------------

def _drain_script(pkg, f, g, **kw):
    n = 32
    g.reset_counts()
    srv = pkg.Server(cache_mb=0, max_wait_us=10**6, **kw)
    try:
        f.install(f.FaultPlan([
            {"site": "batch", "match": {"op": "posv"}, "times": 1},
            {"site": "serve_drain", "times": 1},
        ]))
        ts = [srv.submit("posv", _spd(n, seed=s), _rhs(n, seed=s))
              for s in range(3)]
        summary = srv.drain(timeout=120)
        return summary, g.counts(), [_np(t.result(timeout=1))
                                     for t in ts]
    finally:
        f.clear()
        srv.close()


def test_drain_completes_all_tickets_under_injected_fault():
    summary, counts, xs = _drain_script(serve, faults, guard, device="cpu")
    assert summary["drained"] == 3 and summary["failed"] == 0
    assert counts["resil.retries"] >= 2
    jsummary, jcounts, jxs = _drain_script(jserve, jfaults, jguard)
    assert (summary, counts) == (jsummary, jcounts)
    for s, (x, j) in enumerate(zip(xs, jxs)):
        np.testing.assert_allclose(x, j, **F64)
        np.testing.assert_allclose(
            x, np.linalg.solve(_spd(n := 32, seed=s), _rhs(n, seed=s)),
            rtol=1e-9, atol=1e-9)


def test_draining_daemon_rejects_new_submissions():
    srv = serve.Server(cache_mb=0, max_wait_us=100, device="cpu")
    srv.drain(timeout=10)
    with pytest.raises(serve.ServeRejected, match="draining"):
        srv.submit("potrf", _spd(24))
    srv.close()
    with pytest.raises(serve.ServeRejected, match="closed"):
        srv.submit("potrf", _spd(24))


def test_serve_admit_fault_site_fires():
    srv = serve.Server(cache_mb=0, max_wait_us=100, device="cpu")
    try:
        faults.install(faults.FaultPlan([
            {"site": "serve_admit", "match": {"tenant": "evil"},
             "times": 1}]))
        with pytest.raises(faults.InjectedFault):
            srv.submit("potrf", _spd(24), tenant="evil")
        out = srv.submit("potrf", _spd(24)).result(timeout=T)
        np.testing.assert_allclose(_np(out), _jfused("potrf", _spd(24)),
                                   **F64)
    finally:
        srv.close()


def test_serve_cache_fault_site_fires():
    """The serve_cache site fires at the cache lookup, before the
    request is counted as a hit or miss."""
    srv = serve.Server(cache_mb=16, max_wait_us=100, device="cpu")
    try:
        plan = faults.install(faults.FaultPlan([
            {"site": "serve_cache", "match": {"op": "posv"},
             "times": 1}]))
        with pytest.raises(faults.InjectedFault):
            srv.submit("posv", _spd(24), _rhs(24))
        assert plan.fired() == 1
        assert srv.cache.stats()["misses"] == 0
        out = srv.submit("posv", _spd(24), _rhs(24)).result(timeout=T)
        assert torch.equal(out, _fused_ref("posv", _spd(24), _rhs(24)))
    finally:
        faults.clear()
        srv.close()


def test_serve_drain_fault_site_fires_and_is_retried():
    srv = serve.Server(cache_mb=0, max_wait_us=100, device="cpu")
    try:
        plan = faults.install(faults.FaultPlan([
            {"site": "serve_drain", "times": 1}]))
        summary = srv.drain(timeout=10)
        assert plan.fired() == 1
        assert summary == {"drained": 0, "failed": 0, "errors": []}
        assert guard.counts() == {"resil.retries": 1}
    finally:
        faults.clear()
        srv.close()


# -- RPC ------------------------------------------------------------------

def _rpc_script(pkg, rpc_mod, **kw):
    n = 32
    spd, b = _spd(n), _rhs(n)
    srv = pkg.Server(cache_mb=16, max_wait_us=100, **kw)
    rs = rpc_mod.RpcServer(srv)
    cli = rpc_mod.RpcClient(rs.address)
    try:
        out = _np(cli.submit("posv", spd, b))
        out2 = _np(cli.submit("posv", spd, b))
        lu, piv = _np(cli.submit("getrf", _gen(n)))
        stats = cli.stats()
        return (out, out2, lu, piv), {
            "submitted": stats["submitted"],
            "cache": stats["cache"], "admission": stats["admission"]}
    finally:
        cli.close()
        rs.close()
        srv.close()


def test_rpc_round_trip_and_stats():
    n = 32
    res, stats = _rpc_script(serve, srpc, device="cpu")
    out, out2, lu, piv = res
    ref = _np(_fused_ref("posv", _spd(n), _rhs(n)))
    assert np.array_equal(out, ref) and np.array_equal(out2, ref)
    assert lu.shape == (n, n) and piv.shape == (n,)
    assert stats["submitted"] == 3 and stats["cache"]["hits"] == 1
    jres, jstats = _rpc_script(jserve, jrpc)
    assert stats == jstats
    assert np.array_equal(piv, jres[3])
    for r, j in zip(res[:3], jres[:3]):
        np.testing.assert_allclose(r, j, **F64)


def test_rpc_propagates_rejection():
    srv = serve.Server(cache_mb=0, max_wait_us=10**6, device="cpu",
                       tenants=[serve.TenantConfig("capped",
                                                   max_pending=0)])
    rpc = serve.RpcServer(srv)
    cli = serve.RpcClient(rpc.address)
    try:
        with pytest.raises(serve.ServeRejected) as ei:
            cli.submit("potrf", _spd(24), tenant="capped")
        assert ei.value.decision == REJECT
    finally:
        cli.close()
        rpc.close()
        srv.close()


def _capture_request(client_cls, a, b, op="posv"):
    """Send one request from `client_cls` to a loopback listener that
    records the raw bytes of the request frame and answers with a
    zero result: the bytes on the wire, header and payload."""
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    lst.settimeout(T)
    got = {}

    def serve_one():
        conn, _ = lst.accept()
        with conn:
            conn.settimeout(T)

            def read(k):
                buf = b""
                while len(buf) < k:
                    chunk = conn.recv(k - len(buf))
                    if not chunk:
                        raise ConnectionError("peer hung up")
                    buf += chunk
                return buf

            raw = read(4)
            hdr_b = read(struct.unpack(">I", raw)[0])
            hdr = json.loads(hdr_b)
            nbytes = 0
            for dt, sh in ((hdr["dtype"], hdr["shape"]),
                           (hdr.get("rhs_dtype"), hdr.get("rhs_shape"))):
                if sh is not None:
                    size = 2 if dt == "bfloat16" else np.dtype(dt).itemsize
                    nbytes += size * int(np.prod(sh))
            got["bytes"] = raw + hdr_b + read(nbytes)
            rh = json.dumps({"status": "ok", "decision": "admit",
                             "cache": None,
                             "parts": [{"dtype": "<f4", "shape": [1]}]},
                            separators=(",", ":")).encode()
            conn.sendall(struct.pack(">I", len(rh)) + rh
                         + np.zeros(1, np.float32).tobytes())

    th = threading.Thread(target=serve_one, daemon=True)
    th.start()
    cli = client_cls(lst.getsockname())
    try:
        cli.submit(op, a, b)
    finally:
        cli.close()
        th.join(timeout=T)
        lst.close()
    assert not th.is_alive()
    return got["bytes"]


def test_rpc_wire_bytes_match_reference():
    """f32 and f64 requests are byte for byte the reference's frames."""
    for dt in (np.float32, np.float64):
        a, b = _spd(16, dtype=dt), _rhs(16, dtype=dt)
        port = _capture_request(srpc.RpcClient, a, b)
        ref = _capture_request(jrpc.RpcClient, a, b)
        assert port == ref
        assert b'"dtype":"%s"' % np.dtype(dt).str.encode() in port


def test_rpc_bf16_round_trip():
    """bf16 travels as "bfloat16" (bytes through an int16 view) and
    comes back bitwise the in-process Server's result."""
    a = torch.from_numpy(_spd(32, dtype=np.float32)).bfloat16()
    b = torch.from_numpy(_rhs(32, k=1, dtype=np.float32)).bfloat16()
    wire = _capture_request(srpc.RpcClient, a, b)
    assert b'"dtype":"bfloat16"' in wire and b'"rhs_dtype":"bfloat16"' \
        in wire
    payload = wire[-(a.numel() + b.numel()) * 2:]
    assert payload == a.view(torch.int16).numpy().tobytes() \
        + b.view(torch.int16).numpy().tobytes()
    with _server() as srv, srpc.RpcServer(srv) as rs, \
            srpc.RpcClient(rs.address) as cl:
        got = cl.submit("posv", a, b)
        ref = srv.submit("posv", a, b).result(timeout=T)
        lu, piv = cl.submit("getrf", a)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    assert lu.dtype == torch.bfloat16 and piv.dtype == torch.int32


# -- fingerprint (the cache key) -------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.complex64, np.int64, np.float16])
def test_fingerprint_matches_reference(dtype, rng):
    for shape in ((40, 40), (3, 7), (1 << 10, 1 << 8)):
        a = (rng.standard_normal(shape) * 100).astype(dtype)
        assert fingerprint(a) == jfingerprint(a)
        assert fingerprint(torch.from_numpy(a)) == jfingerprint(a)


def test_fingerprint_bf16():
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(0))
    fp = fingerprint(x.bfloat16())
    assert fp.endswith(":64x48:bfloat16")
    # the bytes of the int16 view are hashed: same bits, same key
    i16 = x.bfloat16().view(torch.int16).numpy()
    assert fp.split(":")[0] == jfingerprint(i16).split(":")[0]
    assert fingerprint(x.bfloat16()) != fingerprint(
        (x * 2).bfloat16())


# -- request tracing (tests/test_reqtrace.py's Server / RPC tests) ----------

def test_off_state_records_nothing():
    with _server() as srv:
        t = srv.submit("potrf", _spd(16, dtype=np.float32))
        t.result(timeout=T)
        assert t.span is None
    assert reqtrace.count() == 0
    assert series.snapshot() == {"series": {}, "slo": {}}
    assert series.render_prometheus() == ""


def _headers(monkeypatch, mod, server, client, queue_kw):
    headers = []
    real = mod._send_frame

    def spy(sock, header, payloads=()):
        headers.append(dict(header))
        return real(sock, header, payloads)

    monkeypatch.setattr(mod, "_send_frame", spy)
    srv = server(queue=queue_kw())
    try:
        with mod.RpcServer(srv) as rs, client(rs.address) as cl:
            out = cl.submit("potrf", _spd(16, dtype=np.float32))
            assert tuple(out.shape) == (16, 16)
            assert cl.last_trace is None
    finally:
        srv.close()
    return headers


def test_off_state_rpc_wire_unchanged(monkeypatch):
    """With tracing off neither side adds a header field: the headers
    are the reference's, key for key and value for value."""
    port = _headers(monkeypatch, srpc, serve.Server, srpc.RpcClient,
                    lambda: _queue(background=False))
    ref = _headers(monkeypatch, jrpc, jserve.Server, jrpc.RpcClient,
                   lambda: jbq.CoalescingQueue(background=False))
    assert port and port == ref
    for h in port:
        assert "trace" not in h and "span" not in h


def test_traced_results_bitwise_vs_untraced():
    a = _spd(24, dtype=np.float32, seed=3)
    b = _rhs(24, dtype=np.float32, seed=4)
    with _server() as srv:
        ref_f = srv.submit("potrf", a.copy()).result(timeout=T)
        ref_s = srv.submit("posv", a.copy(), b.copy()).result(timeout=T)
    reqtrace.enable()
    series.enable()
    with _server() as srv:
        got_f = srv.submit("potrf", a.copy()).result(timeout=T)
        got_s = srv.submit("posv", a.copy(), b.copy()).result(timeout=T)
    assert torch.equal(ref_f, got_f) and torch.equal(ref_s, got_s)
    with _server() as srv, srpc.RpcServer(srv) as rs, \
            srpc.RpcClient(rs.address) as cl:
        got_r = cl.submit("posv", a.copy(), b.copy())
    assert torch.equal(ref_s, got_r)
    np.testing.assert_allclose(_np(got_s), _jfused("posv", a, b), **F32)


def test_direct_span_carries_phase_split_and_flush_link():
    reqtrace.enable()
    with _server() as srv:
        t = srv.submit("potrf", _spd(16, dtype=np.float32), tenant="acme")
        t.result(timeout=T)
    sp = t.span
    assert sp is not None and sp.t1 is not None
    assert sp.name == reqtrace.REQUEST_SPAN
    assert sp.tenant == "acme" and sp.op == "potrf"
    for ph in ("admit_s", "queue_wait_s", "dispatch_s", "solve_s"):
        assert sp.phases[ph] >= 0.0
    assert sp.t1 - sp.t0 >= sum(
        sp.phases[p] for p in ("queue_wait_s", "dispatch_s",
                               "solve_s")) - 1e-6
    fid = sp.args["flush_id"]
    flushes = [f for f in reqtrace.spans(reqtrace.FLUSH_SPAN)
               if f.args["flush_id"] == fid]
    assert len(flushes) == 1
    assert sp.trace_id in flushes[0].args["trace_ids"]
    assert flushes[0].args["occupancy"] >= 1


def test_rpc_trace_continuity_one_trace_id():
    reqtrace.enable()
    with _server() as srv, srpc.RpcServer(srv) as rs, \
            srpc.RpcClient(rs.address) as cl:
        cl.submit("potrf", _spd(16, dtype=np.float32), tenant="acme")
        tid = cl.last_trace
    assert tid is not None
    by_name = {s.name: s for s in reqtrace.trace(tid)}
    assert set(by_name) >= {reqtrace.CLIENT_SPAN, reqtrace.REQUEST_SPAN}
    client = by_name[reqtrace.CLIENT_SPAN]
    root = by_name[reqtrace.REQUEST_SPAN]
    assert root.parent_id == client.span_id
    assert root.trace_id == client.trace_id == tid
    fid = root.args["flush_id"]
    flushes = [f for f in reqtrace.spans(reqtrace.FLUSH_SPAN)
               if f.args["flush_id"] == fid]
    assert tid in flushes[0].args["trace_ids"]


def test_cobatched_requests_share_one_flush():
    reqtrace.enable()
    with _server() as srv:
        ts = [srv.submit("potrf", _spd(16, dtype=np.float32, seed=s),
                         tenant="t%d" % s) for s in range(3)]
        for t in ts:
            t.result(timeout=T)
    fids = {t.span.args["flush_id"] for t in ts}
    assert len(fids) == 1
    (fid,) = fids
    fl = [f for f in reqtrace.spans(reqtrace.FLUSH_SPAN)
          if f.args["flush_id"] == fid][0]
    assert sorted(fl.args["trace_ids"]) \
        == sorted(t.span.trace_id for t in ts)
    assert fl.args["occupancy"] == 3


def test_cache_miss_hit_paths_traced():
    reqtrace.enable()
    oe.enable()
    a, b = _spd(16, dtype=np.float32, seed=5), _rhs(16, dtype=np.float32,
                                                    seed=6)
    with _server(cache_mb=16) as srv:
        t1 = srv.submit("posv", a, b, tenant="acme")
        t1.result(timeout=T)
        t2 = srv.submit("posv", a, b, tenant="acme")
        t2.result(timeout=T)
    assert t1.span.args["cache"] == "miss"
    assert t2.span.args["cache"] == "hit"
    kids = [s for s in reqtrace.trace(t1.span.trace_id)
            if s.name == "serve::factor"]
    assert len(kids) == 1
    assert kids[0].parent_id == t1.span.span_id
    assert "flush_id" in kids[0].args
    outcomes = {e.args["trace"]: e.args["outcome"]
                for e in oe.events(cat="serve") if e.name == "serve::cache"}
    assert outcomes[t1.span.trace_id] == "miss"
    assert outcomes[t2.span.trace_id] == "hit"
    ready = [e for e in oe.events(cat="serve")
             if e.name == "serve::factor_ready"]
    assert len(ready) == 1 and ready[0].args["waiters"] == 1


def test_span_closure_feeds_series_and_ledger():
    reqtrace.enable()
    series.enable()
    oledger.enable()
    with _server() as srv:
        t = srv.submit("potrf", _spd(16, dtype=np.float32), tenant="acme")
        t.result(timeout=T)
    q = series.quantiles("serve.latency_s", tenant="acme", op="potrf")
    assert q is not None and q["p50"] > 0.0
    assert series.get("serve.queue_wait_s", tenant="acme",
                      op="potrf") is not None
    recs = oledger.records("serve.request")
    assert len(recs) == 1
    assert recs[0].meta["trace"] == t.span.trace_id
    assert recs[0].meta["tenant"] == "acme"
    assert recs[0].phases["other"] > 0.0
    # one serve.admit record a decision, with the reference's keys
    adm = oledger.records("serve.admit")
    assert len(adm) == 1 and adm[0].meta["decision"] == ADMIT
    jseries.enable()
    jledger.enable()
    with _jserver() as jsrv:
        jsrv.submit("potrf", _spd(16, dtype=np.float32),
                    tenant="acme").result(timeout=T)
    jadm = jledger.records("serve.admit")
    assert sorted(adm[0].meta) == sorted(jadm[0].meta)


def test_error_closes_span():
    reqtrace.enable()
    faults.install(faults.FaultPlan([{"site": "serve_admit", "times": 1}]))
    with _server() as srv:
        with pytest.raises(Exception):
            srv.submit("potrf", _spd(16, dtype=np.float32))
    faults.clear()
    assert all(s.t1 is not None for s in reqtrace.spans())


def _burn_tenant(mod, name, n=20, factor=4.0):
    tgt = mod.slo_target_s()
    for _ in range(n):
        mod.note_slo(name, tgt * factor)


def test_slo_burn_sheds_lowest_priority_with_objective():
    fbs = []
    for se, rt, ev, g, ctrl_cls, tcls, q in (
            (series, reqtrace, oe, guard, AdmissionController,
             TenantConfig, _queue(background=False)),
            (jseries, jreqtrace, joe, jguard, JAdmission, JTenant,
             jbq.CoalescingQueue(background=False))):
        se.enable()
        rt.enable()
        ev.enable()
        _burn_tenant(se, "bulk")
        with q:
            ctrl = ctrl_cls(q, tenants=[tcls("bulk", priority="batch")])
            sp = rt.begin(tenant="bulk", op="potrf")
            with rt.active(sp):
                decision = ctrl.admit(ctrl.tenant("bulk"), "potrf",
                                      np.float32, 0)
        assert decision == SHED
        assert g.counts()["resil.fallback.serve_shed"] == 1
        fb = [e for e in ev.events(cat="resil")
              if e.name == "resil::fallback"]
        assert len(fb) == 1
        args = dict(fb[0].args)
        assert args.pop("trace") == sp.trace_id
        fbs.append(args)
    assert fbs[0] == fbs[1]
    assert fbs[0]["rung"] == "serve_shed"
    assert fbs[0]["objective"].startswith("latency_ms<=")
    assert fbs[0]["burn"] == 1.0


def test_slo_burn_degrades_degradable_f64():
    series.enable()
    oe.enable()
    _burn_tenant(series, "std")
    with _queue(background=False) as q:
        ctrl = AdmissionController(q)
        decision = ctrl.admit(ctrl.tenant("std"), "posv", torch.float64, 0)
    assert decision == DEGRADE
    fb = [e for e in oe.events(cat="resil")
          if e.name == "resil::fallback"]
    assert fb[0].args["rung"] == "serve_degrade"
    assert fb[0].args["objective"].startswith("latency_ms<=")


def test_healthy_burn_admits():
    series.enable()
    series.note_slo("ok", 0.0)
    with _queue(background=False) as q:
        ctrl = AdmissionController(
            q, tenants=[TenantConfig("ok", priority="batch")])
        assert ctrl.admit(ctrl.tenant("ok"), "potrf",
                          torch.float32, 0) == ADMIT


def test_admit_record_carries_slo_pressure():
    metas = []
    for se, le, ctrl_cls, tcls, q in (
            (series, oledger, AdmissionController, TenantConfig,
             _queue(background=False)),
            (jseries, jledger, JAdmission, JTenant,
             jbq.CoalescingQueue(background=False))):
        se.enable()
        le.enable()
        _burn_tenant(se, "bulk")
        with q:
            ctrl = ctrl_cls(q, tenants=[tcls("bulk", priority="batch")])
            ctrl.admit(ctrl.tenant("bulk"), "potrf", np.float32, 0)
        recs = le.records("serve.admit")
        assert recs and recs[-1].meta["decision"] == "shed"
        assert recs[-1].meta["slo_burn"]["burn"] == 1.0
        metas.append(recs[-1].meta)
    assert metas[0] == metas[1]


def test_metrics_rpc_roundtrip():
    reqtrace.enable()
    series.enable()
    with _server() as srv, srpc.RpcServer(srv) as rs, \
            srpc.RpcClient(rs.address) as cl:
        assert "slate_" not in cl.metrics()
        cl.submit("potrf", _spd(16, dtype=np.float32), tenant="acme")
        text = cl.metrics()
    assert '# TYPE slate_serve_latency_s summary' in text
    assert 'slate_serve_latency_s{tenant="acme",op="potrf",' \
        'quantile="0.95"}' in text
    assert 'slate_serve_latency_s_count{tenant="acme",op="potrf"} 1' \
        in text
    assert "slate_serve_slo_burn" in text


def test_metrics_rpc_off_state_empty():
    with _server() as srv, srpc.RpcServer(srv) as rs, \
            srpc.RpcClient(rs.address) as cl:
        assert cl.metrics() == ""


def test_report_serve_section():
    reqtrace.enable()
    series.enable()
    with _server() as srv:
        srv.submit("potrf", _spd(16, dtype=np.float32),
                   tenant="acme").result(timeout=T)
    snap = obs.snapshot()
    key = "serve.latency_s|acme|potrf"
    assert snap["serve_series"]["series"][key]["count"] == 1
    text = obs.report()
    assert "serving latency" in text
    assert "serve.latency_s" in text and "acme" in text


def _phs(trace_obj):
    return {r["ph"] for r in trace_obj["traceEvents"]}


def test_export_flow_events_off_and_on():
    from slate_tpu_torch.obs.export import chrome_trace
    oe.enable()
    with _server() as srv:
        srv.submit("potrf", _spd(16, dtype=np.float32)).result(timeout=T)
    off = chrome_trace()
    assert not ({"s", "f"} & _phs(off))
    oe.clear()
    reqtrace.enable()
    with _server() as srv:
        t = srv.submit("potrf", _spd(16, dtype=np.float32))
        t.result(timeout=T)
    on = chrome_trace()
    flows = [r for r in on["traceEvents"] if r["name"] == "serve.flow"]
    assert {r["ph"] for r in flows} == {"s", "f"}
    tid = t.span.trace_id
    assert any(r["id"] == tid for r in flows if r["ph"] == "s")
    assert any(r["id"] == tid and r.get("bp") == "e"
               for r in flows if r["ph"] == "f")


def test_flush_timestamps_consistent_with_span_event():
    oe.enable()
    reqtrace.enable()
    with _server() as srv:
        t = srv.submit("potrf", _spd(16, dtype=np.float32))
        t.result(timeout=T)
    evs = [e for e in oe.events(cat="serve")
           if e.name == reqtrace.REQUEST_SPAN]
    assert len(evs) == 1
    assert evs[0].args["trace_id"] == t.span.trace_id
    assert evs[0].t0 == t.span.t0 and evs[0].t1 == t.span.t1


def test_concurrent_traced_submits_distinct_traces():
    reqtrace.enable()
    series.enable()
    results = {}

    def worker(i):
        with _server() as srv:
            t = srv.submit("potrf", _spd(16, dtype=np.float32, seed=i),
                           tenant="t%d" % i)
            t.result(timeout=T)
            results[i] = t.span

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=T)
    assert not any(th.is_alive() for th in threads)
    assert len({sp.trace_id for sp in results.values()}) == 4
    for i, sp in results.items():
        assert sp.tenant == "t%d" % i
        assert sp.t1 is not None and "flush_id" in sp.args


# -- the package ---------------------------------------------------------

def test_serve_exports_match_reference():
    assert sorted(serve.__all__) == sorted(jserve.__all__)
    for name in serve.__all__:
        assert hasattr(serve, name)
    assert serve.CACHED_OPS == jserve.CACHED_OPS
    assert (serve.ADMIT, serve.SHED, serve.DEGRADE, serve.REJECT,
            serve.PRIORITIES) == (jserve.ADMIT, jserve.SHED,
                                  jserve.DEGRADE, jserve.REJECT,
                                  jserve.PRIORITIES)


def test_owned_queue_takes_the_device():
    srv = serve.Server(cache_mb=0, device="cpu")
    try:
        assert srv._queue._device == torch.device("cpu")
        assert srv._queue._flusher is not None
    finally:
        srv.close()

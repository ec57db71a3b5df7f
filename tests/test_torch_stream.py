"""slate_tpu_torch.linalg.stream against the JAX package's on the CPU: the
panel cache's victims under lru / mru / fifo on one access trace, its
pinning, over-budget refusals and epoch invalidation, the bf16 host
demotion, and the byte counters of whole streams; then the engine on
its own: the budget contract ("auto" never invents memory off the
card), writebacks into preallocated slices, stash / spill, the stacked
gather, the transfer guard, the stats surface, and a threaded stress
run of its shared counters."""

import sys
import threading

import numpy as np
import pytest
import torch

from slate_tpu.linalg import ooc as jooc
from slate_tpu.linalg import stream as jstream
from slate_tpu.obs import events as jobs
from slate_tpu.obs import metrics as jmetrics

from slate_tpu_torch.linalg import ooc, stream
from slate_tpu_torch.linalg.stream import PanelCache, StreamEngine
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import metrics
from slate_tpu_torch.resil import faults, guard

CPU = "cpu"


@pytest.fixture
def rng():
    return np.random.default_rng(77)


@pytest.fixture
def obs_both():
    """Both packages' event bus and metrics on, reset around the
    test."""
    for ev, me in ((obs_events, metrics), (jobs, jmetrics)):
        ev.enable()
        ev.clear()
        me.reset()
    yield
    for ev, me in ((obs_events, metrics), (jobs, jmetrics)):
        ev.disable()
        ev.clear()
        me.reset()


@pytest.fixture(autouse=True)
def clean():
    faults.clear()
    guard.reset_counts()
    yield
    faults.clear()
    guard.reset_counts()


def _spd(rng, n, dtype=np.float64):
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T / n + 4.0 * np.eye(n, dtype=dtype)


# -- PanelCache against the reference's ---------------------------------------

#: one access trace: (op, panel) with 800-byte panels in a 4-panel budget
TRACE = ([("put", i) for i in range(4)] + [("get", 0), ("get", 1)]
         + [("put", 4), ("get", 2), ("put", 5), ("get", 0), ("put", 6),
            ("get", 3), ("get", 4), ("put", 7), ("put", 1), ("get", 6),
            ("put", 8), ("put", 2), ("get", 8), ("put", 9)])


def _replay(cache, make):
    victims, served = [], []
    cache.on_evict = lambda key, arr: victims.append(key[2])
    for op, i in TRACE:
        key = cache.key("L", i)
        if op == "put":
            served.append(cache.put(key, make()))
        else:
            served.append(cache.get(key) is not None)
    return victims, served, (cache.hits, cache.misses, cache.evictions,
                             cache.resident_bytes)


@pytest.mark.parametrize("policy", ["lru", "mru", "fifo"])
def test_cache_victims_match_reference(policy):
    got = _replay(PanelCache(4 * 800, policy=policy),
                  lambda: torch.zeros(100, dtype=torch.float64))
    ref = _replay(jstream.PanelCache(4 * 800, policy=policy),
                  lambda: np.zeros(100, np.float64))
    assert got == ref
    assert len(got[0]) >= 5


def test_cache_pinning_and_overbudget_match_reference():
    def run(mod, make):
        c = mod.PanelCache(budget_bytes=1000, policy="mru")
        out = [c.put(("L", 0, 0), make(200)),     # alone over budget
               c.put(("L", 0, 1), make(100)),
               c.put(("L", 0, 2), make(100)),     # only pinned victims
               c.get(("L", 0, 1)) is not None]
        return out, c.hits, c.misses, c.evictions
    got = run(stream, lambda k: torch.zeros(k, dtype=torch.float64))
    assert got == run(jstream, lambda k: np.zeros(k, np.float64))
    assert got[0] == [False, True, False, True]


def test_cache_epoch_invalidation():
    c = PanelCache(budget_bytes=10_000, policy="mru")
    k0 = c.key("LU", 0)
    c.put(k0, torch.zeros(100, dtype=torch.float64))
    assert c.get(k0) is not None
    assert c.invalidate("LU") == 1 and c.invalidations == 1
    k1 = c.key("LU", 0)
    assert k1 != k0
    assert c.get(k1) is None
    assert c.resident_bytes == 0 and c.invalidated_bytes == 800


# -- the budget contract ------------------------------------------------------

def test_budget_zero_is_uncached():
    eng = stream.engine_for(256, 32, np.float64, device=CPU)
    try:
        assert not eng.caching and eng.cache.budget == 0
        assert eng.cache.policy == "mru" and eng.prefetch_depth == 1
    finally:
        eng.finish()


def test_auto_budget_never_invents_memory(monkeypatch):
    """Off the card "auto" is 0 (cache off); on it, the free memory
    (plus what the allocator holds unused) at 90% minus the 4-panel
    reserve, clamped at 0."""
    assert stream.auto_budget_bytes(1 << 20, 8192, 4, device=CPU) == 0
    eng = stream.engine_for(64, 16, np.float64, budget_bytes="auto",
                            device=CPU)
    try:
        assert eng.cache.budget == 0 and not eng.caching
    finally:
        eng.finish()
    free = 16 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: 3 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: 1 << 30)
    n, w, item = 1 << 16, 8192, 4
    expect = int((free + (2 << 30)) * stream.AUTO_BUDGET_FRACTION) \
        - stream.RESERVE_PANELS * n * w * item
    assert stream.auto_budget_bytes(n, w, item, device="cuda") == expect
    assert stream.auto_budget_bytes(1 << 22, 1 << 20, 8,
                                    device="cuda") == 0
    with pytest.raises(ValueError, match="auto"):
        stream.engine_for(64, 16, np.float64, budget_bytes="never",
                          device=CPU)


# -- transfers ----------------------------------------------------------------

def test_d2h_into_preallocated_slice(rng):
    x = rng.standard_normal((2304, 6))
    host = np.zeros((2304, 10))
    got = stream._d2h(torch.from_numpy(x), out=host[:, 2:8])
    np.testing.assert_array_equal(host[:, 2:8], x)
    assert got.base is host
    h2 = np.zeros((64, 6))
    stream._d2h(torch.from_numpy(x[:64]), out=h2)
    np.testing.assert_array_equal(h2, x[:64])
    fresh = stream._d2h(torch.from_numpy(x[:5]))
    np.testing.assert_array_equal(fresh, x[:5])


def test_h2d_copies_the_host_rows(rng):
    """On the CPU an upload is a copy: the host factor keeps changing
    under a stream."""
    a = rng.standard_normal((32, 8))
    t = stream._h2d(a[:, 2:6], CPU)
    a[:] = 0
    assert t.is_contiguous() and float(t.abs().sum()) > 0


def test_demote_host_matches_reference_after_upcast(rng, obs_both):
    """bf16 residency: the port's demotion is a CPU torch bf16 tensor
    whose values, upcast, are the reference's ml_dtypes bf16; both
    count the full-precision bytes in."""
    import ml_dtypes
    x = rng.standard_normal((64, 48)).astype(np.float32)[:, 8:40]
    got = stream.demote_host(x, torch.bfloat16)
    ref = jstream.demote_host(x, ml_dtypes.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.astype(np.float32))
    assert metrics.snapshot()["counters"]["ooc.cast_demote_bytes"] \
        == jmetrics.snapshot()["counters"]["ooc.cast_demote_bytes"] \
        == x.nbytes
    dev = stream.demote_dev(torch.from_numpy(x.copy()), torch.bfloat16)
    back = stream.promote_dev(dev, torch.float32)
    np.testing.assert_array_equal(back.numpy(), got.float().numpy())
    assert stream.host_demoter(None)(x) is x


# -- the engine ---------------------------------------------------------------

def test_stash_spills_and_finish_writes_back():
    """A stashed DIRTY panel spills through the writer when evicted,
    a later fetch re-stages it from its host view, and finish() writes
    back the panels still resident; budget 0 writes through."""
    host = np.zeros((8, 16))
    panels = [torch.full((8, 4), float(i + 1), dtype=torch.float64)
              for i in range(4)]
    eng = StreamEngine(budget_bytes=3 * 8 * 4 * 8, device=CPU)
    for i, p in enumerate(panels):
        eng.stash("W", i, p, lambda i=i: host[:, 4 * i:4 * i + 4])
    eng.wait_writes()
    # the fourth stash evicts the one unpinned panel (mru: 0) by a spill
    assert eng.spills == 1 and eng.cache.evictions == 1
    assert (host[:, :4] == 1).all() and (host[:, 4:] == 0).all()
    back = eng.fetch("W", 0, lambda: host[:, :4])
    assert float(back[0, 0]) == 1.0
    eng.finish()
    assert eng.spills == 4
    np.testing.assert_array_equal(host, np.repeat([1., 2., 3., 4.], 4)
                                  [None].repeat(8, 0))
    host2 = np.zeros((8, 4))
    eng = StreamEngine(budget_bytes=0, device=CPU)
    assert not eng.stash("W", 0, panels[1], lambda: host2)
    eng.finish()
    assert (host2 == 2).all() and eng.spills == 0


@pytest.mark.parametrize("budget", [0, 10 * 16 * 4 * 8])
def test_gather_stacked_equals_per_panel_fetches(rng, budget):
    """Hits, a pending prefetch and misses gathered side by side equal
    the panels fetched one at a time, bitwise; one upload for the
    misses."""
    host = rng.standard_normal((16, 20))
    loaders = [(lambda j=j: host[:, 4 * j:4 * j + 4]) for j in range(5)]
    eng = StreamEngine(budget_bytes=budget, device=CPU)
    try:
        if budget:
            eng.fetch("P", 1, loaders[1])          # a resident
        eng.prefetch("P", 3, loaders[3])            # a pending upload
        cat = eng.gather_stacked("P", list(range(5)), loaders)
        np.testing.assert_array_equal(cat.numpy(), host)
        if budget:
            assert eng.cache.hits >= 1
            again = eng.gather_stacked("P", [0, 4], [loaders[0],
                                                     loaders[4]])
            np.testing.assert_array_equal(again.numpy(),
                                          host[:, np.r_[0:4, 16:20]])
    finally:
        eng.finish()


def test_guard_transfer_retries_transient_and_propagates_bugs():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise faults.InjectedFault("h2d", 0, 0, {"buf": "A"})
        return 7

    assert stream._guard_transfer("h2d", flaky, buf="A", idx=0) == 7
    assert guard.counts()["resil.retries"] == 1

    def broken():
        raise ValueError("a bug, not flakiness")

    with pytest.raises(ValueError):
        stream._guard_transfer("h2d", broken, buf="A", idx=0)


def test_h2d_fault_nan_poisons_the_upload_and_d2h_the_host():
    """A ``nan`` rule poisons the transferred payload: the uploaded
    tensor, and the caller's host view in place for a writeback."""
    faults.install(faults.FaultPlan(
        [{"site": "h2d", "match": {"buf": "A"}, "kind": "nan"},
         {"site": "d2h", "match": {"buf": "L"}, "kind": "nan"}]))
    eng = StreamEngine(budget_bytes=0, device=CPU)
    try:
        x = eng.fetch("A", 0, lambda: np.ones((4, 4)), cache=False)
        assert torch.isnan(x).all()
        out = np.ones((4, 4))
        eng.write("L", 0, torch.ones(4, 4, dtype=torch.float64), out)
        eng.wait_writes()
        assert np.isnan(out).all()
    finally:
        eng.finish()


def test_invalidate_drains_a_pending_prefetch():
    host = np.ones((8, 4))
    eng = StreamEngine(budget_bytes=1 << 20, device=CPU)
    try:
        eng.fetch("LU", 0, lambda: host)
        eng.prefetch("LU", 1, lambda: host)
        assert eng.invalidate("LU", cause="lu") == 1
        assert not eng._pending
        assert eng.cache.key("LU", 0)[1] == 1
    finally:
        eng.finish()


def test_engine_threads_stress():
    """Many prefetches, fetches and writebacks with a short switch
    interval: every write lands, and the shared byte counter is the sum
    of the uploads (a lost update would break it)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        host = np.arange(64 * 256, dtype=np.float64).reshape(64, 256)
        out = np.zeros_like(host)
        eng = StreamEngine(budget_bytes=0, prefetch_depth=4, device=CPU)
        done = threading.Event()

        def body():
            for j in range(64):
                for p in range(j + 1, min(j + 5, 64)):
                    eng.prefetch("A", p, lambda p=p: host[:, 4 * p:4 * p + 4],
                                 cache=False)
                x = eng.fetch("A", j, lambda j=j: host[:, 4 * j:4 * j + 4],
                              cache=False)
                eng.write("O", j, x, out[:, 4 * j:4 * j + 4])
            eng.finish()
            done.set()

        t = threading.Thread(target=body)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive() and done.is_set()
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(out, host)
    s = stream.last_stats()
    assert s["uploaded_bytes"] >= host.nbytes
    assert s["writes_issued"] == 64


# -- streams: byte counters against the reference's ---------------------------

def _counters(mod):
    c = mod.snapshot()["counters"]
    return {k: c.get(k, 0) for k in
            ("ooc.h2d_bytes", "ooc.d2h_bytes", "ooc.cache.hits",
             "ooc.cache.misses", "ooc.cache.evictions",
             "ooc.lu_invalidations", "ooc.cast_demote_bytes")}


def _cross_panel_pivots(rng, n):
    """A matrix whose pivot search picks rows of LATER panels at every
    step (growing magnitudes toward the bottom)."""
    return rng.standard_normal((n, n)) * (1.0 + np.arange(n))[:, None]


STREAMS = {
    "potrf.budget0": lambda m, a, g, **k: m.potrf_ooc(
        a, panel_cols=32, cache_budget_bytes=0, **k),
    "potrf.evicting": lambda m, a, g, **k: m.potrf_ooc(
        a, panel_cols=32, cache_budget_bytes=3 * 256 * 32 * 8, **k),
    "getrf.rowswaps": lambda m, a, g, **k: m.getrf_ooc(
        g, panel_cols=32, cache_budget_bytes=64 * 256 * 32 * 8, **k),
    "tntpiv.cached": lambda m, a, g, **k: m.getrf_tntpiv_ooc(
        g, panel_cols=32, cache_budget_bytes=4 * 256 * 32 * 8, **k),
    "potrf.bf16": lambda m, a, g, **k: m.potrf_ooc(
        a.astype(np.float32), panel_cols=32, precision="bf16",
        cache_budget_bytes=3 * 256 * 32 * 4, **k),
}


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_stream_counters_equal_reference(case, obs_both):
    """The same schedule moves the same bytes: H2D and D2H bytes,
    hits, misses, evictions, LU invalidations and demoted bytes equal
    the reference's."""
    rng = np.random.default_rng(8)
    a = _spd(rng, 256)
    g = _cross_panel_pivots(rng, 256)
    STREAMS[case](jooc, a, g)
    STREAMS[case](ooc, a, g, device=CPU)
    got, ref = _counters(metrics), _counters(jmetrics)
    assert got == ref
    assert got["ooc.h2d_bytes"] > 0
    if case == "getrf.rowswaps":
        assert got["ooc.lu_invalidations"] > 0
    if case in ("potrf.evicting", "tntpiv.cached"):
        assert got["ooc.cache.hits"] > 0
    if case == "potrf.bf16":
        assert got["ooc.cast_demote_bytes"] > 0


def test_potrf_cache_cuts_h2d_volume(rng, obs_both):
    """At nt = 8 with a budget of 6 panels the residency cache cuts
    the H2D bytes by >= 40%, bitwise the same factor; the counters the
    stats surface carries."""
    a = _spd(rng, 256)
    L0 = ooc.potrf_ooc(a, panel_cols=32, cache_budget_bytes=0,
                       device=CPU)
    base = metrics.snapshot()["counters"]["ooc.h2d_bytes"]
    metrics.reset()
    L1 = ooc.potrf_ooc(a, panel_cols=32,
                       cache_budget_bytes=6 * 256 * 32 * 8, device=CPU)
    c = metrics.snapshot()["counters"]
    np.testing.assert_array_equal(L0, L1)
    assert c["ooc.h2d_bytes"] <= 0.6 * base
    assert c["ooc.cache.hits"] > 0 and c["ooc.cache.served_bytes"] > 0
    assert c["ooc.prefetch.issued"] > 0
    s = stream.last_stats()
    for key in ("hits", "misses", "evictions", "invalidations",
                "hit_rate", "served_bytes", "prefetch_issued",
                "prefetch_overlap_fraction", "d2h_overlap_fraction",
                "budget_bytes", "policy", "spills"):
        assert key in s, key
    assert s["hits"] > 0

"""The port's layer spans and FGMRES step counter (obs/events.py,
linalg/lu.py, linalg/refine.py) on the CPU at n 256, nb 64: which spans
a solve publishes, their parents and call ids; nothing with obs off,
not even a profiler range; the profiler ranges with obs on; the inner
step count against per-k least squares; and the benchmark's readers of
both (portbench/spans.py). Off the card spans carry no device time;
the card's own check is portbench/tests/test_portbench_spans.py."""

import collections
import json
import math

import pytest
import torch

import slate_tpu_torch as st
from slate_tpu_torch.linalg import refine
from slate_tpu_torch.obs import events, metrics

from portbench import spans as pb_spans
from portbench.registry import Registry

N, NB = 256, 64
NT = N // NB
DRIVERS = ("gesv", "gesv_mixed_gmres")
#: span -> the spans that may enclose it, per driver
PARENTS = {
    "gesv": {
        "gesv": {None}, "gesv::getrf": {"gesv"}, "gesv::getrs": {"gesv"},
        "getrf": {"gesv::getrf"}, "getrs": {"gesv::getrs"},
        "lu::panel": {"getrf"}, "lu::swaps": {"getrf"},
        "lu::update": {"getrf"}, "lu::reorder": {"getrf"},
    },
    "gesv_mixed_gmres": {
        "gesv_mixed_gmres": {None}, "getrf": {"gesv_mixed_gmres"},
        "lu::panel": {"getrf"}, "lu::swaps": {"getrf"},
        "lu::update": {"getrf"},
        "refine::cycle": {"gesv_mixed_gmres"},
        "refine::precond": {"gesv_mixed_gmres", "refine::cycle"},
        "getrs": {"refine::precond"},
    },
}
LAYER_SPANS = ("lu::panel", "lu::swaps", "lu::update", "lu::reorder",
               "getrs", "refine::precond", "refine::cycle")


@pytest.fixture(autouse=True)
def clean():
    events.disable()
    events.clear()
    metrics.reset()
    yield
    events.disable()
    events.clear()
    metrics.reset()


def _system(seed=0, shift=2.0, mb=NB):
    """HPL-MxP's shape of system at order N: a Gaussian matrix plus
    shift * sqrt(N) on the diagonal, one right-hand side."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(N, N, generator=g) + shift * math.sqrt(N) * torch.eye(N)
    b = torch.randn(N, 1, generator=g)
    return (st.Matrix(a, mb=mb, device="cpu"),
            st.Matrix(b, mb=mb, device="cpu"))


def _call(driver, A, B):
    out = getattr(st, driver)(A, B, {st.Option.BlockSize: NB})
    return out[1], (out[2] if len(out) > 2 else None)


@pytest.mark.parametrize("driver", DRIVERS)
def test_spans_parents_and_call_ids(driver):
    A, B = _system()
    events.enable()
    iters = [_call(driver, A, B)[1] for _ in range(2)]
    evs = [e for e in events.events() if e.ph == events.PH_SPAN]
    by_id = {e.sid: e for e in evs}
    assert all(e.sid for e in evs) and len(by_id) == len(evs)
    roots = [e for e in evs if e.name == driver]
    assert len(roots) == 2 and {e.cat for e in roots} == {"driver"}
    assert {e.call for e in evs} == {r.sid for r in roots}
    for e in evs:
        up = by_id[e.parent].name if e.parent else None
        assert up in PARENTS[driver][e.name], (e.name, up)
        root = e
        while root.parent:
            root = by_id[root.parent]
        assert e.call == root.sid
        assert e.device is None                  # no device off the card
        assert (e.cat == "layer") == (e.name in LAYER_SPANS)
    per_call = collections.Counter(e.name for e in evs
                                   if e.call == roots[0].sid)
    assert per_call["lu::panel"] == per_call["lu::swaps"] == NT
    if driver == "gesv":
        assert per_call["lu::update"] == NT - 1
        assert per_call["lu::reorder"] == per_call["getrs"] == 1
    else:
        # lookahead form: a narrow and a wide update a step, the last
        # step's wide one absent
        assert per_call["lu::update"] == 2 * (NT - 1) - 1
        cycles = iters[0] // 30
        assert per_call["refine::cycle"] == cycles
        assert per_call["refine::precond"] == per_call["getrs"] \
            == 1 + 30 * cycles
    assert events.device_seconds() == {}


@pytest.mark.parametrize("driver", DRIVERS)
def test_obs_off_publishes_nothing_and_opens_no_range(driver):
    A, B = _system()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _call(driver, A, B)
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names or "aten::matmul" in names
    assert not [n for n in names if n.startswith(("lu::", "refine::"))
                or n in ("getrs", driver)]
    assert events.count() == 0 and metrics.snapshot()["histograms"] == {}


@pytest.mark.parametrize("driver,panel_op", [
    ("gesv", "aten::linalg_lu_factor_ex"),      # the library route
    ("gesv_mixed_gmres", "aten::argmax"),       # bf16: the column loop
])
def test_panel_ranges_enclose_the_panels_ops(driver, panel_op, tmp_path):
    A, B = _system()
    events.enable()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _call(driver, A, B)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    panels = [e for e in trace if e["name"] == "lu::panel"]
    assert len(panels) == NT
    assert {e["cat"] for e in panels} == {"user_annotation"}

    def inside(op, rng):
        return rng["tid"] == op["tid"] and rng["ts"] <= op["ts"] \
            and op["ts"] + op["dur"] <= rng["ts"] + rng["dur"]

    (getrf,) = [e for e in trace if e["name"] == "getrf"]
    ops = [e for e in trace if e.get("cat") == "cpu_op"
           and e["name"] == panel_op and inside(e, getrf)]
    assert ops
    # every panel range holds panel work, and every op of the panels'
    # route in the factorization lies inside a panel range
    assert all(any(inside(op, p) for op in ops) for p in panels)
    assert all(any(inside(op, p) for p in panels) for op in ops)
    names = {e["name"] for e in trace}
    assert {"lu::swaps", "lu::update", "getrs", driver} <= names


def _rho_lstsq(H, beta):
    """rho_k by a least-squares solve for each k, in float64."""
    H = H.double()
    out = []
    for k in range(1, H.shape[1] + 1):
        rhs = torch.zeros(k + 1, 1, dtype=torch.float64)
        rhs[0] = float(beta)
        Hk = H[:k + 1, :k]
        y = torch.linalg.lstsq(Hk, rhs).solution
        out.append(float(torch.linalg.vector_norm(Hk @ y - rhs)))
    return torch.tensor(out, dtype=torch.float64)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_lsq_residuals_match_per_k_lstsq(dtype, tol):
    g = torch.Generator().manual_seed(3)
    H = torch.triu(torch.randn(31, 30, generator=g, dtype=dtype), -1)
    beta = torch.tensor(2.5, dtype=dtype)
    got = refine.lsq_residuals(H, beta).double()
    want = _rho_lstsq(H, beta)
    assert got.shape == (30,)
    assert torch.allclose(got, want, rtol=0, atol=tol * float(beta))
    assert bool((got[1:] <= got[:-1] + tol).all())     # non-increasing


@pytest.mark.parametrize("mb,shift", [(NB, 2.0), (4, 0.5)])
def test_fgmres_steps_match_a_host_recount(mb, shift, monkeypatch):
    """restart 30 (one cycle) and restart 3 (mb - 1: several cycles)."""
    A, B = _system(seed=1, shift=shift, mb=mb)
    X0, it0 = _call("gesv_mixed_gmres", A, B)
    seen = []
    real = refine.lsq_residuals

    def spy(H, beta):
        seen.append((H.clone(), beta.clone()))
        return real(H, beta)

    monkeypatch.setattr(refine, "lsq_residuals", spy)
    events.enable()
    X1, it1 = _call("gesv_mixed_gmres", A, B)
    assert torch.equal(X0.data, X1.data) and it0 == it1 > 0
    restart = min(30, mb - 1)
    cycles = it1 // restart
    assert len(seen) == cycles
    a = A.to_dense()
    x = X1.to_dense()[:, 0]
    tol = torch.finfo(a.dtype).eps * math.sqrt(N) \
        * float(a.abs().sum(dim=1).max())
    bound = tol * float(torch.linalg.vector_norm(x))
    rho = _rho_lstsq(*seen[-1])
    met = (rho <= bound).nonzero()
    k = int(met[0]) + 1 if len(met) else restart
    h = metrics.snapshot()["histograms"]["refine.fgmres.steps"]
    assert h["count"] == 1
    assert h["total"] == restart * (cycles - 1) + k <= cycles * restart
    if mb == 4:
        assert cycles > 1


def test_portbench_readers_average_over_the_calls(monkeypatch):
    """The readers over a recorded CPU run: its bus stands in for the
    device-time store (each span's host seconds), its counters are the
    program's own."""
    A, B = _system()
    events.enable()
    for _ in range(3):
        _call("gesv", A, B)
    for _ in range(2):
        _call("gesv_mixed_gmres", A, B)
    events.disable()
    assert pb_spans.per_call_ms(("lu::panel",), "gesv") is None  # no card
    evs = [e for e in events.events() if e.ph == events.PH_SPAN]
    host = collections.defaultdict(lambda: [0, 0.0])
    for e in evs:
        host[e.name][0] += 1
        host[e.name][1] += e.dur
    monkeypatch.setattr(events, "device_seconds",
                        lambda: {k: tuple(v) for k, v in host.items()})

    reg = Registry()

    def read(name):
        return reg.module("metrics", name).read(None)

    # the store sums both drivers' panels; each reader divides by its
    # own driver's calls
    panel_s = host["lu::panel"][1]
    assert read("panel_span_ms") == pytest.approx(panel_s / 3 * 1e3)
    assert read("panel_bf16_span_ms") == pytest.approx(panel_s / 2 * 1e3)
    assert read("update_ms") == pytest.approx(
        host["lu::update"][1] / 3 * 1e3)
    assert read("swaps_ms") == pytest.approx(
        (host["lu::swaps"][1] + host["lu::reorder"][1]) / 3 * 1e3)
    assert read("getrs_ms") == pytest.approx(host["getrs"][1] / 3 * 1e3)
    assert read("precond_ms") == pytest.approx(
        host["refine::precond"][1] / 2 * 1e3)
    steps = metrics.snapshot()["histograms"]["refine.fgmres.steps"]
    assert steps["count"] == 2
    assert read("fgmres_steps") == steps["total"] / 2
    assert 1 <= read("fgmres_steps") <= 30
    # a port without the store or the counter reads as nothing
    monkeypatch.delattr(events, "device_seconds")
    assert read("panel_span_ms") is None
    metrics.reset()
    assert read("fgmres_steps") is None


class _StandInEvent:
    """A timing CUDA event off the card: record() stamps the test's
    clock (ms), and the event completes when the test says so."""
    clock = 0.0
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t, self.done = None, False
        self.device = torch.device("cuda", 0)
        _StandInEvent.made.append(self)

    def record(self, stream=None):
        self.t, self.done = _StandInEvent.clock, False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def stand_in_card(monkeypatch):
    _StandInEvent.clock, _StandInEvent.made = 0.0, []
    monkeypatch.setattr(torch.cuda, "Event", _StandInEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(events, "_pools", {})
    return torch.device("cuda", 0)


def _tick(ms):
    _StandInEvent.clock += ms


def test_device_timing_pends_resolves_and_reuses_events(stand_in_card):
    from slate_tpu_torch import obs
    events.enable()
    drv = events.span_begin("solve", "driver", stand_in_card)
    _tick(1.0)
    sp = events.span_begin("lu::panel", "layer")     # the driver's device
    _tick(3.0)
    events.span_end(sp)
    with events.span("solve::phase", cat="phase"):
        _tick(2.0)
    events.span_end(drv)       # outermost: nothing has completed yet
    evs = {e.name: e for e in events.events()}
    assert all(e.device is not None and e.device.seconds is None
               for e in evs.values())
    first = [ev for ev in _StandInEvent.made if ev.t in (1.0, 4.0)]
    for ev in first[:2]:
        ev.done = True
    events.span_end(events.span_begin("tick", "layer", stand_in_card))
    assert evs["lu::panel"].device.seconds == pytest.approx(3e-3)
    assert evs["solve"].device.seconds is None       # stops at the first
    made = len(_StandInEvent.made)
    totals = events.device_seconds()                 # waits for the rest
    assert totals == {"lu::panel": (1, pytest.approx(3e-3)),
                      "solve": (1, pytest.approx(6e-3)),
                      "solve::phase": (1, pytest.approx(2e-3)),
                      "tick": (1, 0.0)}
    assert evs["solve"].device.seconds == pytest.approx(6e-3)
    # resolved events go back to the pool and are recorded again
    events.span_end(events.span_begin("again", "layer", stand_in_card))
    assert len(_StandInEvent.made) == made
    rec = [r for r in obs.chrome_trace(include_ledger=False)
           ["traceEvents"] if r["name"] == "lu::panel"][0]
    assert rec["args"]["device_s"] == pytest.approx(3e-3)
    assert rec["args"]["parent"] == rec["args"]["call"] \
        == evs["solve"].sid
    snap = obs.snapshot()
    assert snap["drivers"]["solve"]["device_seconds"] == pytest.approx(6e-3)
    assert snap["spans"]["lu::panel"]["device_seconds"] \
        == pytest.approx(3e-3)
    assert "device(s)" in obs.report()
    events.clear()
    assert events.device_seconds() == {} and not events._pending


def test_device_timing_drops_past_its_cap(stand_in_card, monkeypatch):
    from slate_tpu_torch import obs
    monkeypatch.setattr(events, "PENDING_CAP", 2)
    events.enable()
    drv = events.span_begin("solve", "driver", stand_in_card)
    for _ in range(3):
        events.span_end(events.span_begin("lu::swaps", "layer"))
    events.span_end(drv)
    assert events.device_dropped() == 2
    assert events.device_seconds() == {"lu::swaps": (1, 0.0),
                                       "solve": (1, 0.0)}
    assert "2 device-timed spans were dropped" in obs.report()

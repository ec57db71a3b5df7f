"""slate_tpu_torch.linalg.ooc against the JAX package's on the CPU: every
streaming driver on the same seeded numpy inputs (f32 to 1e-5, f64 to
1e-12, relative to the result's largest entry; getrf_ooc's and the
one-chunk getrf_tntpiv_ooc's pivots equal), a ragged last panel, a
single panel, rectangles and wide geqrf; the invert route; the bf16
residency refined to f32 accuracy. Then the port's own contracts:
budget 0 bitwise an evicting budget, the prefetch and policy knobs,
stale L panels retired by the row-swap fixups, the step fault log equal
to the reference's, the refinement sentinel, checkpoint meta
mismatches, the tournament / partial rules, and a grid that is not a
ProcessGrid raising."""

import json

import numpy as np
import pytest
import torch

from slate_tpu.linalg import ooc as jooc
from slate_tpu.resil import faults as jfaults

import slate_tpu_torch as st
from slate_tpu_torch.core.exceptions import SlateError
from slate_tpu_torch.core.options import Option
from slate_tpu_torch.linalg import ooc, stream
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import metrics
from slate_tpu_torch.resil import faults, guard

CPU = "cpu"


def _spd(rng, n, dtype=np.float64):
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T / n + 4.0 * np.eye(n, dtype=dtype)


def _inputs():
    """The seeded inputs of every reference case."""
    rng = np.random.default_rng(1234)
    d = {"a300": _spd(rng, 300), "a64": _spd(rng, 64),
         "a160f": _spd(rng, 160, np.float32),
         "g256": rng.standard_normal((256, 256)),
         "gwide": rng.standard_normal((160, 300)),
         "gtall": rng.standard_normal((300, 160)),
         "g160": rng.standard_normal((160, 160)),
         "twide": rng.standard_normal((96, 160)),
         "g192": rng.standard_normal((192, 192)),
         "qwide": rng.standard_normal((160, 300)),
         "ls_a": rng.standard_normal((500, 96)),
         "ls_b": rng.standard_normal((500, 2)),
         "gm_a": rng.standard_normal((333, 96)),
         "gm_b": rng.standard_normal((96, 64)),
         "gm_c": rng.standard_normal((333, 64)),
         "b300": rng.standard_normal((300, 3)),
         "b64": rng.standard_normal((64, 2)),
         "b256": rng.standard_normal((256, 3)),
         "b160": rng.standard_normal((160, 3))}
    d["a96f"] = _spd(rng, 96, np.float32)
    d["g96f"] = (rng.standard_normal((96, 96))
                 + 0.2 * 96 * np.eye(96)).astype(np.float32)
    d["b96f"] = rng.standard_normal((96, 2)).astype(np.float32)
    return d


def _cases(m, x, **kw):
    """Every case through package `m` (the port with device=cpu): name
    -> tuple of numpy results."""
    out = {}
    L = m.potrf_ooc(x["a300"], panel_cols=128, **kw)
    out["potrf.ragged"] = (L,)
    out["potrs.ragged"] = (m.potrs_ooc(L, x["b300"], panel_cols=128,
                                       **kw),)
    L1 = m.potrf_ooc(x["a64"], panel_cols=256, **kw)
    out["potrf.single"] = (L1,)
    out["potrs.single"] = (m.potrs_ooc(L1, x["b64"], panel_cols=256,
                                       **kw),)
    out["potrf.f32"] = (m.potrf_ooc(x["a160f"], panel_cols=32, **kw),)
    lu, piv = m.getrf_ooc(x["g256"], panel_cols=64, **kw)
    out["getrf"] = (lu, piv)
    out["getrs"] = (m.getrs_ooc(lu, piv, x["b256"], panel_cols=64,
                                **kw),)
    out["getrf.wide"] = m.getrf_ooc(x["gwide"], panel_cols=128, **kw)
    out["getrf.tall"] = m.getrf_ooc(x["gtall"], panel_cols=128, **kw)
    lu, piv = m.getrf_tntpiv_ooc(x["g160"], panel_cols=32, chunk=160,
                                 **kw)
    out["tntpiv"] = (lu, piv)
    out["tntpiv.getrs"] = (m.getrs_ooc(lu, piv, x["b160"], panel_cols=32,
                                       **kw),)
    out["tntpiv.wide"] = m.getrf_tntpiv_ooc(x["twide"], panel_cols=32,
                                            chunk=96, **kw)
    qr, tau = m.geqrf_ooc(x["g192"], panel_cols=64, **kw)
    out["geqrf"] = (qr, tau)
    out["unmqr"] = (m.unmqr_ooc(qr, tau, x["b300"][:192], trans=True,
                                panel_cols=64, **kw),)
    out["geqrf.wide"] = m.geqrf_ooc(x["qwide"], panel_cols=128, **kw)
    out["gels"] = (m.gels_ooc(x["ls_a"], x["ls_b"], panel_cols=48,
                              **kw)[1],)
    out["gemm"] = (m.gemm_ooc(2.0, x["gm_a"], x["gm_b"], -0.5, x["gm_c"],
                              row_panel=100, **kw),)
    out["posv.bf16"] = m.posv_ooc(x["a96f"], x["b96f"], panel_cols=32,
                                  precision="bf16", **kw)[1:]
    out["gesv.bf16"] = m.gesv_ooc(x["g96f"], x["b96f"], panel_cols=32,
                                  precision="bf16", **kw)[1:]
    return out


@pytest.fixture(scope="module")
def both():
    """Each reference driver shape run once; the port on the same
    inputs."""
    x = _inputs()
    ref = {k: tuple(np.asarray(v) for v in vs)
           for k, vs in _cases(jooc, x).items()}
    got = _cases(ooc, x, device=CPU)
    return x, ref, got


CASES = ["potrf.ragged", "potrs.ragged", "potrf.single", "potrs.single",
         "potrf.f32", "getrf", "getrs", "getrf.wide", "getrf.tall",
         "tntpiv", "tntpiv.getrs", "tntpiv.wide", "geqrf", "unmqr",
         "geqrf.wide", "gels", "gemm", "posv.bf16", "gesv.bf16"]


def _tol(x):
    return 1e-5 if x.dtype == np.float32 else 1e-12


@pytest.mark.parametrize("case", CASES)
def test_driver_matches_reference(both, case):
    _x, ref, got = both
    assert len(got[case]) == len(ref[case])
    for g, r in zip(got[case], ref[case]):
        assert g.shape == r.shape and g.dtype == r.dtype, case
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r)       # pivots
            continue
        scale = max(float(np.abs(r).max()), 1.0)
        assert float(np.abs(g - r).max()) <= _tol(r) * scale, case


def test_bf16_refined_to_f32_accuracy(both):
    x, _ref, got = both
    for case, a in (("posv.bf16", x["a96f"]), ("gesv.bf16", x["g96f"])):
        X = got[case][0]
        r = np.linalg.norm(a.astype(np.float64) @ X - x["b96f"]) \
            / (np.linalg.norm(a) * np.linalg.norm(X))
        assert r <= 1e-6, (case, r)


def test_factor_identities(both):
    """P A = L U, Q R = A and L L^H = A from the port's own factors."""
    x, _ref, got = both
    lu, piv = got["getrf"]
    perm = ooc._swaps_to_perm(piv, 256)
    L = np.tril(lu, -1) + np.eye(256)
    assert np.abs(x["g256"][perm] - L @ np.triu(lu)).max() < 1e-12 * 256
    L = got["potrf.ragged"][0]
    assert np.abs(x["a300"] - L @ L.T).max() < 1e-12 * 20
    qr, tau = got["geqrf"]
    R = np.triu(qr)
    QR = ooc.unmqr_ooc(qr, tau, R, trans=False, panel_cols=64, device=CPU)
    assert np.abs(QR - x["g192"]).max() < 1e-12 * 20


@pytest.mark.parametrize("op", ["potrf", "getrf"])
def test_invert_route_matches_reference(both, op, monkeypatch):
    """Past OOC_SOLVE_TEMP_CAP the solves invert the diagonal block and
    multiply (forced by a cap of -1: a cap of 0 would leave triangles
    narrower than 128 on the direct solve); the results stay within
    roundoff of the reference's direct route."""
    x, ref, _got = both
    monkeypatch.setattr(ooc, "OOC_SOLVE_TEMP_CAP", -1)
    if op == "potrf":
        L = ooc.potrf_ooc(x["a300"], panel_cols=128, device=CPU)
        X = ooc.potrs_ooc(L, x["b300"], panel_cols=128, device=CPU)
        assert np.abs(L - ref["potrf.ragged"][0]).max() < 1e-10
        assert np.abs(X - ref["potrs.ragged"][0]).max() < 1e-9
    else:
        lu, piv = ooc.getrf_ooc(x["g256"], panel_cols=64, device=CPU)
        X = ooc.getrs_ooc(lu, piv, x["b256"], panel_cols=64, device=CPU)
        np.testing.assert_array_equal(piv, ref["getrf"][1])
        assert np.abs(lu - ref["getrf"][0]).max() < 1e-9
        assert np.abs(X - ref["getrs"][0]).max() < 1e-8


# -- the port's contracts -----------------------------------------------------

N, W = 160, 32
TINY = int(1.5 * N * W * 8)        # ~1.5 panels: evictions
BIG = 64 * N * W * 8


def _budget_run(op, budget, rng_seed=3, **kw):
    rng = np.random.default_rng(rng_seed)
    a = _spd(rng, N)
    g = rng.standard_normal((N, N))
    b = rng.standard_normal((N, 3))
    if op == "potrf":
        return (ooc.potrf_ooc(a, panel_cols=W, cache_budget_bytes=budget,
                              device=CPU, **kw),)
    if op == "potrs":
        L = ooc.potrf_ooc(a, panel_cols=W, device=CPU)
        return (ooc.potrs_ooc(L, b, panel_cols=W,
                              cache_budget_bytes=budget, device=CPU),)
    if op == "getrf":
        return ooc.getrf_ooc(g, panel_cols=W, cache_budget_bytes=budget,
                             device=CPU, **kw)
    if op == "getrs":
        lu, piv = ooc.getrf_ooc(g, panel_cols=W, device=CPU)
        return (ooc.getrs_ooc(lu, piv, b, panel_cols=W,
                              cache_budget_bytes=budget, device=CPU),)
    if op == "getrf_tntpiv":
        return ooc.getrf_tntpiv_ooc(g, panel_cols=W,
                                    cache_budget_bytes=budget,
                                    device=CPU, **kw)
    if op == "geqrf":
        return ooc.geqrf_ooc(g, panel_cols=W, cache_budget_bytes=budget,
                             device=CPU, **kw)
    qr, tau = ooc.geqrf_ooc(g, panel_cols=W, device=CPU)
    return (ooc.unmqr_ooc(qr, tau, b, trans=True, panel_cols=W,
                          cache_budget_bytes=budget, device=CPU),)


@pytest.mark.parametrize("op", ["potrf", "potrs", "getrf", "getrs",
                                "getrf_tntpiv", "geqrf", "unmqr"])
def test_budget_zero_bitwise_evicting_budget(op):
    ref = _budget_run(op, 0)
    for budget in (TINY, BIG):
        for x, y in zip(ref, _budget_run(op, budget)):
            np.testing.assert_array_equal(x, y)


def test_composite_drivers_budget_bitwise():
    rng = np.random.default_rng(5)
    n, w = 128, 32
    budget = 3 * n * w * 8
    a = _spd(rng, n)
    g = rng.standard_normal((n, n)) + 0.2 * n * np.eye(n)
    b = rng.standard_normal((n, 2))
    ta = rng.standard_normal((200, 64))
    tb = rng.standard_normal((200, 2))
    c = rng.standard_normal((200, 5))
    bb = rng.standard_normal((64, 5))

    def run(bud):
        return (ooc.posv_ooc(a, b, panel_cols=w, cache_budget_bytes=bud,
                             device=CPU)[1],
                ooc.gesv_ooc(g, b, panel_cols=w, cache_budget_bytes=bud,
                             device=CPU)[1],
                ooc.gels_ooc(ta, tb, panel_cols=32,
                             cache_budget_bytes=bud, device=CPU)[1],
                ooc.gemm_ooc(1.5, ta, bb, -0.5, c, row_panel=64,
                             cache_budget_bytes=bud, device=CPU))
    for x, y in zip(run(0), run(budget)):
        np.testing.assert_array_equal(x, y)


def test_prefetch_depth_and_policy_knobs_bitwise(monkeypatch):
    from slate_tpu_torch.tune import cache as tcache
    ref = _budget_run("potrf", 3 * N * W * 8)
    monkeypatch.setitem(tcache.FROZEN, ("ooc", "prefetch_depth"), 0)
    for policy in ("lru", "fifo"):
        monkeypatch.setitem(tcache.FROZEN, ("ooc", "cache_policy"),
                            policy)
        np.testing.assert_array_equal(
            ref[0], _budget_run("potrf", 3 * N * W * 8)[0])


def test_rowswap_fixups_retire_stale_panels():
    """Every panel's pivots come from LATER panels, so each fixup
    rewrites written L panels: their cached copies must be retired,
    and the cached factor equals the uncached one and the in-core
    pivots."""
    rng = np.random.default_rng(6)
    n, w = 128, 32
    a = rng.standard_normal((n, n)) * (1.0 + np.arange(n))[:, None]
    lu0, piv0 = ooc.getrf_ooc(a, panel_cols=w, cache_budget_bytes=0,
                              device=CPU)
    lu1, piv1 = ooc.getrf_ooc(a, panel_cols=w,
                              cache_budget_bytes=64 * n * w * 8,
                              device=CPU)
    s = stream.last_stats()
    assert s["invalidations"] > 0 and s["invalidated_bytes"] > 0
    np.testing.assert_array_equal(piv0, piv1)
    np.testing.assert_array_equal(lu0, lu1)
    F = st.getrf(st.Matrix(a, mb=w, device=CPU))
    np.testing.assert_array_equal(piv1, F.pivots.numpy()[:n])
    # the tournament stream never invalidates
    ooc.getrf_tntpiv_ooc(a, panel_cols=w,
                         cache_budget_bytes=64 * n * w * 8, device=CPU)
    assert stream.last_stats()["invalidations"] == 0


def test_step_fault_log_equals_reference():
    """One seeded plan over the ``step`` site fires at the same
    occurrences of the same panels in both packages."""
    rng = np.random.default_rng(7)
    a = _spd(rng, 160)
    g = rng.standard_normal((160, 160))
    rule = [{"site": "step", "times": 6, "prob": 0.5, "kind": "slow",
             "slow_s": 0.0}]
    logs = []
    for fmod, m, kw in ((faults, ooc, {"device": CPU}),
                        (jfaults, jooc, {})):
        plan = fmod.install(fmod.FaultPlan(rule, seed=3))
        m.potrf_ooc(a, panel_cols=32, **kw)
        m.geqrf_ooc(g, panel_cols=32, **kw)
        m.getrf_tntpiv_ooc(g, panel_cols=32, **kw)
        fmod.clear()
        logs.append(plan.log())
    assert logs[0] == logs[1]
    assert len(logs[0]) >= 2
    assert {e.get("ctx", e).get("op") for e in logs[0]} <= {
        "potrf_ooc", "geqrf_ooc", "getrf_tntpiv_ooc"}


def test_transfer_faults_retried_bitwise():
    """One transient fault each at h2d and d2h under an evicting
    budget: both retried, the factor bitwise the clean run's."""
    ref = _budget_run("potrf", 4 * N * W * 8)
    guard.reset_counts()
    faults.install(faults.FaultPlan(
        [{"site": "h2d", "match": {"buf": "A"}, "after": 1, "times": 1},
         {"site": "d2h", "match": {"buf": "L", "idx": 2}, "times": 1}]))
    got = _budget_run("potrf", 4 * N * W * 8)
    plan = faults.active()
    faults.clear()
    assert sorted(e["site"] for e in plan.log()) == ["d2h", "h2d"]
    assert guard.counts()["resil.retries"] == 2
    np.testing.assert_array_equal(ref[0], got[0])
    guard.reset_counts()


def test_sentinel_escalates_mixed_to_full():
    """With no sweep allowed the refinement cannot converge: the
    ``mixed_to_full`` rung is recorded and the answer is the full
    f32 factor and solve (iters < 0)."""
    rng = np.random.default_rng(8)
    a = _spd(rng, 96, np.float32)
    b = rng.standard_normal((96, 2)).astype(np.float32)
    guard.reset_counts()
    obs_events.enable()
    metrics.reset()
    try:
        L, X = ooc.posv_ooc(a, b, panel_cols=32, precision="bf16",
                            opts={Option.MaxIterations: 0}, device=CPU)
        c = metrics.snapshot()
    finally:
        obs_events.disable()
    assert guard.counts()["resil.fallback.mixed_to_full"] == 1
    assert c["counters"]["refine.ooc.fallback"] == 1
    np.testing.assert_array_equal(
        L, ooc.potrf_ooc(a, panel_cols=32, precision="f32", device=CPU))
    assert np.abs(a @ X - b).max() < 1e-4
    guard.reset_counts()


def test_checkpoint_mode_mismatch_starts_fresh(tmp_path):
    """A checkpoint written under bf16 residency (or partial panels of
    another pivot mode) is not resumed under f32: the stream starts at
    epoch 0 and lands bitwise on the uninterrupted f32 factor."""
    rng = np.random.default_rng(9)
    a = _spd(rng, 160, np.float32)
    ref = ooc.potrf_ooc(a, panel_cols=32, device=CPU)
    faults.install(faults.FaultPlan(
        [{"site": "step", "match": {"op": "potrf_ooc", "step": 3},
          "times": 1}]))
    with pytest.raises(faults.InjectedFault):
        ooc.potrf_ooc(a, panel_cols=32, precision="bf16",
                      ckpt_path=str(tmp_path), ckpt_every=1, device=CPU)
    faults.clear()
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["epoch"] == 3 and meta["precision"] == "bfloat16"
    got = ooc.potrf_ooc(a, panel_cols=32, ckpt_path=str(tmp_path),
                        ckpt_every=1, device=CPU)
    np.testing.assert_array_equal(ref, got)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["precision"] == "full" and meta["epoch"] == 5


def test_lu_rules():
    """Partial mode rejects a checkpoint; bf16 and the fused sweep are
    tournament-only; bf16 alone routes to the tournament stream."""
    rng = np.random.default_rng(10)
    g = rng.standard_normal((96, 96)).astype(np.float32)
    with pytest.raises(SlateError, match="cannot checkpoint"):
        ooc.getrf_ooc(g, panel_cols=32, ckpt_path="unused", device=CPU)
    with pytest.raises(SlateError, match="tournament-only"):
        ooc.getrf_ooc(g, panel_cols=32, pivot="partial",
                      precision="bf16", device=CPU)
    lu0, p0 = ooc.getrf_ooc(g, panel_cols=32, precision="bf16",
                            device=CPU)
    lu1, p1 = ooc.getrf_tntpiv_ooc(g, panel_cols=32, precision="bf16",
                                   device=CPU)
    np.testing.assert_array_equal(lu0, lu1)
    np.testing.assert_array_equal(p0, p1)


DRIVERS_WITH_GRID = {
    "potrf_ooc": lambda a, b: ooc.potrf_ooc(a, grid=object(), device=CPU),
    "posv_ooc": lambda a, b: ooc.posv_ooc(a, b, grid=object(),
                                          device=CPU),
    "getrf_ooc": lambda a, b: ooc.getrf_ooc(a, grid=object(), device=CPU),
    "gesv_ooc": lambda a, b: ooc.gesv_ooc(a, b, grid=object(),
                                          device=CPU),
    "geqrf_ooc": lambda a, b: ooc.geqrf_ooc(a, grid=object(), device=CPU),
    "gels_ooc": lambda a, b: ooc.gels_ooc(a, b, grid=object(),
                                          device=CPU),
}


@pytest.mark.parametrize("name", sorted(DRIVERS_WITH_GRID))
def test_any_grid_raises_before_a_transfer(name):
    """A grid that is not a parallel.ProcessGrid raises TypeError naming
    the driver, before any transfer."""
    a = _spd(np.random.default_rng(0), 64)
    b = np.ones((64, 1))
    obs_events.enable()
    metrics.reset()
    try:
        with pytest.raises(TypeError, match="ProcessGrid"):
            DRIVERS_WITH_GRID[name](a, b)
        assert "ooc.h2d_bytes" not in metrics.snapshot()["counters"]
    finally:
        obs_events.disable()


def test_drivers_are_public_and_default_to_the_card():
    for name in ("potrf_ooc", "potrs_ooc", "posv_ooc", "getrf_ooc",
                 "getrs_ooc", "gesv_ooc", "getrf_tntpiv_ooc",
                 "geqrf_ooc", "unmqr_ooc", "gels_ooc", "gemm_ooc",
                 "PanelCache", "StreamEngine"):
        assert getattr(st, name) is getattr(st.linalg, name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ooc.potrf_ooc(np.eye(8))


def test_solve_drivers_instrumented():
    rng = np.random.default_rng(11)
    a = _spd(rng, 96)
    b = rng.standard_normal((96, 2))
    obs_events.enable()
    obs_events.clear()
    try:
        ooc.posv_ooc(a, b, panel_cols=32, device=CPU)
        g = rng.standard_normal((96, 96)) + 20 * np.eye(96)
        lu, piv = ooc.getrf_ooc(g, panel_cols=32, device=CPU)
        ooc.getrs_ooc(lu, piv, b, panel_cols=32, device=CPU)
        qr, tau = ooc.geqrf_ooc(g, panel_cols=32, device=CPU)
        ooc.unmqr_ooc(qr, tau, b, panel_cols=32, device=CPU)
        spans = {e.name for e in obs_events.events("driver")}
    finally:
        obs_events.disable()
        obs_events.clear()
    for op in ("posv_ooc", "potrf_ooc", "potrs_ooc", "getrf_ooc",
               "getrs_ooc", "geqrf_ooc", "unmqr_ooc"):
        assert op in spans, op


def test_host_ir_polishes_once_past_the_bound():
    """host_ir stops at the reference's normwise bound after the same
    number of sweeps, then takes one polish sweep (as the in-core
    iterative_refinement of both packages does; the reference's host
    loop does not): one more lo solve, a residual no larger."""
    from slate_tpu.linalg import refine as jrefine
    from slate_tpu_torch.linalg import refine
    rng = np.random.default_rng(12)
    a = _spd(rng, 128, np.float32)
    b = rng.standard_normal((128, 2)).astype(np.float32)
    lo = (a + 1e-3 * rng.standard_normal(a.shape)).astype(np.float32)
    x0 = np.linalg.solve(lo, b).astype(np.float32)

    def counted():
        calls = []

        def solve_lo(r):
            calls.append(1)
            return np.linalg.solve(lo, r).astype(np.float32)
        return solve_lo, calls

    s_t, c_t = counted()
    s_j, c_j = counted()
    xt, it_t = refine.host_ir("posv_ooc", a, b, x0, s_t, None)
    xj, it_j = jrefine.host_ir("posv_ooc", a, b, x0, s_j, None)
    assert it_t == it_j >= 1
    assert len(c_t) == len(c_j) + 1
    rt = np.abs(a.astype(np.float64) @ xt - b).max()
    rj = np.abs(a.astype(np.float64) @ np.asarray(xj) - b).max()
    assert rt <= rj
    # MaxIterations 0: no sweep, no polish, the fallback
    s0, c0 = counted()
    _, it0 = refine.host_ir("posv_ooc", a, b, x0, s0, lambda: x0,
                            opts={Option.MaxIterations: 0})
    assert it0 == -1 and c0 == []
    guard.reset_counts()


def test_herm_operand_matches_reference():
    rng = np.random.default_rng(13)
    a = _spd(rng, 96)
    assert ooc._herm_operand(a) is a
    low = np.tril(a) + np.triu(rng.standard_normal(a.shape), 1)
    np.testing.assert_array_equal(ooc._herm_operand(low),
                                  jooc._herm_operand(low))
    np.testing.assert_array_equal(ooc._herm_operand(low), a)
    c = (rng.standard_normal((64, 64))
         + 1j * rng.standard_normal((64, 64)))
    h = c @ c.conj().T
    assert ooc._herm_operand(h) is h

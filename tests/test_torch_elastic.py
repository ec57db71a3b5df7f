"""The port's elastic mesh (slate_tpu_torch/dist/elastic.py) against the
JAX package's: in this process the twins of tests/test_elastic.py (the
owner table, the planner on the same inputs giving the reference's
plan, the controller's records, shrink_to_fit's rung, the admission
payload after a remap); then one launch of four gloo ranks (suite
"elastic" of testing.shard_checks: uniform and skewed speeds, a measured
straggler, crash and resume across a remap) and one shrink to fit
(four ranks, one killed, then three survivors), covering the reference's
two-process tests at small sizes. Every elastic factor is bitwise the
static one."""

import os
import threading

import jax
import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.dist import elastic as jel
from slate_tpu.dist import shard_ooc as jso

import slate_tpu_torch as st
from slate_tpu_torch.core.enums import GridOrder
from slate_tpu_torch.core.methods import MethodOwnership
from slate_tpu_torch.dist import elastic
from slate_tpu_torch.dist import shard_ooc as so
from slate_tpu_torch.linalg import ooc
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.parallel.mesh import ProcessGrid
from slate_tpu_torch.resil import faults, guard
from slate_tpu_torch.testing import grid_checks as gc
from slate_tpu_torch.testing import multiproc as mp
from slate_tpu_torch.testing import shard_checks as sc

X = sc.inputs("elastic")


@pytest.fixture(autouse=True)
def _clean_state():
    """No speeds, remap records or guard counts leak out."""
    yield
    faults.clear()
    elastic.install_speeds(None)
    elastic.reset_remap_records()
    guard.reset_counts()


def _pgrid(p, q, index=0):
    return ProcessGrid(p, q, GridOrder.Col, range(p * q), index,
                       torch.device("cpu"), None)


# -- the owner table and the planner, in this process ------------------------

@pytest.mark.parametrize("p,q", [(2, 4), (2, 2), (4, 1)])
def test_elastic_schedule_default_is_cyclic(p, q):
    nt = 12
    jcyc = jso.CyclicSchedule(nt, jst.make_grid(
        p, q, devices=jax.devices()[:p * q]))
    for idx in range(p * q):
        g = _pgrid(p, q, idx)
        ela = elastic.ElasticSchedule(nt, g)
        cyc = so.CyclicSchedule(nt, g)
        for k in range(nt):
            assert ela.owner_flat(k) == cyc.owner_flat(k) \
                == jcyc.owner_flat(k)
            assert ela.owner_coords(k) == jcyc.owner_coords(k)
            assert ela.owner_process(k) == cyc.owner_process(k)
        assert ela.my_panels() == cyc.my_panels()


def test_elastic_schedule_validates_table():
    g = _pgrid(2, 4)
    with pytest.raises(ValueError):
        elastic.ElasticSchedule(4, g, owners=[0, 1])
    with pytest.raises(ValueError):
        elastic.ElasticSchedule(4, g, owners=[0, 1, 2, 99])


def test_remap_preserves_factored_prefix():
    s = elastic.ElasticSchedule(8, _pgrid(2, 4))
    moved = list(s.owners)
    moved[5] = (moved[5] + 1) % s.nranks
    s2 = s.remap(4, moved)
    assert s2.owners == moved and s.owners[:4] == s2.owners[:4]
    bad = list(s.owners)
    bad[1] = (bad[1] + 1) % s.nranks
    with pytest.raises(ValueError):
        s.remap(4, bad)


PLANS = {
    "uniform": ([0, 1, 0, 1, 0, 1, 0, 1], 2, [1.0, 1.0], 1.25, None),
    "skew": ([0, 1, 0, 1, 0, 1, 0, 1], 2, [1.0, 0.2], 1.25, None),
    "lost_host": ([0, 1, 0, 1], 1, [1.0, 1.0], 1.25, [0]),
    "quota": ([k % 4 for k in range(16)], 0, [1.0, 1.0, 1.0, 0.1], 1.25,
              None),
    "three_of_four": ([k % 4 for k in range(10)], 3,
                      [1.0, 0.9, 0.5, 1.0], 1.25, [0, 1, 2]),
    "past_end": ([0, 1, 2, 3], 4, [1.0, 0.1, 1.0, 1.0], 1.25, None)}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_remap_matches_reference(case):
    """The same (owners, boundary, speeds, threshold, positions) give
    the reference's plan: the threshold gate, a forced plan off a lost
    position, speed-proportional quotas, nothing past the end."""
    owners, b, speeds, thr, pos = PLANS[case]
    got = elastic.plan_remap(owners, b, speeds, thr, positions=pos)
    assert got == jel.plan_remap(owners, b, speeds, thr, positions=pos)
    if got is not None:
        assert got[:b] == owners[:b]
    if case == "uniform":
        assert got is None
    if case == "quota":
        assert sum(1 for o in got if o == 3) <= 2


def test_throughput_tracker_matches_reference():
    mine, ref = elastic.ThroughputTracker(3, 0.4), \
        jel.ThroughputTracker(3, 0.4)
    for pos, wall in ((0, 0.5), (1, 0.2), (0, 0.1), (0, 0.9), (2, -1.0)):
        mine.observe(pos, wall)
        ref.observe(pos, wall)
    assert mine.walls() == ref.walls()


def test_resolve_ownership_frozen_static():
    assert MethodOwnership.resolve(1024, np.float32) \
        is MethodOwnership.Static
    assert not elastic._resolve_ownership(None, 1024, np.float32)
    assert elastic._resolve_ownership("elastic", 1024, np.float32)
    assert st.str2method("ownership", "ELASTIC") \
        is MethodOwnership.Elastic


def test_controller_remap_records():
    elastic.install_speeds([1.0] * 4 + [0.25] * 4)
    ctrl = elastic.ElasticController("shard_potrf_ooc", _pgrid(2, 4),
                                     nt=8, n=256)
    moved = ctrl.maybe_remap(2)
    assert moved >= 1
    assert ctrl.remaps == 1 and ctrl.panels_moved == moved
    rr = elastic.remap_records()
    assert rr["remaps"] == 1 and rr["panels_moved"] == moved
    assert rr["last"] == {"op": "shard_potrf_ooc", "boundary": 2,
                          "moved": moved}
    elastic.install_speeds([1.0] * 8)
    ctrl2 = elastic.ElasticController("shard_potrf_ooc", _pgrid(2, 4),
                                      nt=8, n=256)
    assert ctrl2.maybe_remap(2) == 0
    elastic.install_speeds([1.0] * 3)
    with pytest.raises(ValueError, match="installed speed vector"):
        ctrl2.maybe_remap(2)


def test_shrink_to_fit_survivor_path():
    def primary():
        raise guard.WorkerLost(1, faults.KILL_EXIT_CODE, tail="dead")

    seen = []

    def survivors(exc):
        seen.append(exc)
        return "resumed"

    assert elastic.shrink_to_fit(primary, survivors,
                                 op="shard_potrf_ooc") == "resumed"
    assert len(seen) == 1 and seen[0].process_id == 1
    assert guard.counts()["resil.fallback.shard_shrink"] == 1
    assert elastic.remap_records()["shrinks"] == 1
    assert elastic.shrink_to_fit(lambda: "ok", survivors, op="x") == "ok"
    assert len(seen) == 1


def test_one_rank_elastic_is_static():
    """One position: the planner has nowhere to move a panel, and the
    elastic route (always the graph) is bitwise the static walk."""
    g = st.single_device_grid("cpu")
    a = X["spd"]
    L0 = so.shard_potrf_ooc(a, g, panel_cols=16, ownership="static")
    L1 = so.shard_potrf_ooc(a, g, panel_cols=16, ownership="elastic")
    assert np.array_equal(L0, L1)
    assert elastic.remap_records()["remaps"] == 0


def test_admission_payload_carries_mesh_churn():
    """After a remap, the admission ladder's escalation payload reads
    the real counts (the mirror the reference attaches)."""
    from slate_tpu_torch.batch import queue as bq
    from slate_tpu_torch.serve.admission import (REJECT,
                                                 AdmissionController,
                                                 TenantConfig)
    elastic.install_speeds([1.0] * 4 + [0.25] * 4)
    ctrl = elastic.ElasticController("shard_potrf_ooc", _pgrid(2, 4),
                                     nt=8, n=256)
    moved = ctrl.maybe_remap(2)
    assert moved >= 1
    obs_events.enable()
    try:
        obs_events.drain()
        with bq.CoalescingQueue(background=False, device="cpu") as q:
            ac = AdmissionController(q)
            assert ac.admit(TenantConfig("quota"), "potrf",
                            torch.float64, 10 ** 9) == REJECT
        evs = [e for e in obs_events.drain()
               if e.name == "resil::fallback"
               and e.args.get("rung") == "serve_reject"]
        assert evs
        args = evs[-1].args
        assert args["mesh_remaps"] == 1
        assert args["mesh_panels_moved"] == moved
        assert args["mesh_shrinks"] == 0
        assert args["mesh_last_remap"] == "shard_potrf_ooc@2+%d" % moved
    finally:
        obs_events.disable()
        obs_events.clear()


# -- four ranks --------------------------------------------------------------

class _Launch:
    def __init__(self, outdir):
        self.res, self.exc = None, None
        self.thread = threading.Thread(target=self._run, args=(outdir,))
        self.thread.start()

    def _run(self, outdir):
        try:
            procs, outs = mp.launch(
                "slate_tpu_torch.testing.shard_checks", 4,
                extra_args=["elastic"], outdir=outdir, timeout=240,
                env={"SLATE_TPU_TORCH_TUNE_CACHE": outdir + "/tune"})
            mp.assert_success(procs, outs)
            self.res = [r["2x2.elastic"] for r in gc.load(outs)]
        except BaseException as e:
            self.exc = e

    def result(self):
        self.thread.join()
        if self.exc is not None:
            raise self.exc
        return self.res


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    return _Launch(str(tmp_path_factory.mktemp("elastic")))


@pytest.fixture(scope="module")
def ref(launch):
    g = jst.make_grid(2, 2, devices=jax.devices()[:4])
    return np.asarray(jso.shard_potrf_ooc(X["spd"], g,
                                          panel_cols=sc.W_ELASTIC,
                                          cache_budget_bytes=0))


@pytest.fixture(scope="module")
def ranks(ref, launch):
    return launch.result()


def test_static_route_bitwise_and_matches_reference(ranks, ref):
    for r in ranks:
        assert r["static"] and r["sha_l"] == ranks[0]["sha_l"]
    scale = float(np.abs(ref).max())
    assert float(np.abs(ranks[0]["l"] - ref).max()) <= 1e-5 * scale


def test_uniform_speeds_never_remap(ranks):
    for r in ranks:
        assert r["uniform"]["bitwise"] and r["uniform"]["fused"]
        assert r["uniform"]["records"]["remaps"] == 0


def test_skewed_speeds_remap_bitwise(ranks):
    """Installed skewed speeds re-own panels at the boundaries (every
    rank the same plan); the factor, fused too, is bitwise static."""
    recs = [r["skew"]["records"] for r in ranks]
    for r in ranks:
        assert r["skew"]["bitwise"] and r["skew"]["fused"]
    assert recs[0]["remaps"] >= 1 and recs[0]["panels_moved"] >= 1
    assert all(x == recs[0] for x in recs)


def test_geqrf_getrf_remap_bitwise(ranks):
    """The QR and LU streams re-owned mid-stream (their tail panels read
    the live owner): bitwise their single-engine twins."""
    for r in ranks:
        assert r["qr_lu"]["geqrf"] and r["qr_lu"]["getrf"]
        assert r["qr_lu"]["records"]["remaps"] >= 1


def test_measured_straggler_remaps_bitwise(ranks):
    """Rank 3 sleeps in every step it owns (a ``slow`` rule scoped to
    host 3 and its own panels): the agreed measured speeds re-own its
    panels, on every rank alike, and the factor stays bitwise."""
    recs = [r["straggler"]["records"] for r in ranks]
    for r in ranks:
        assert r["straggler"]["bitwise"]
    assert recs[0]["remaps"] >= 1 and recs[0]["panels_moved"] >= 1
    assert all(x == recs[0] for x in recs)


def test_crash_resume_across_a_remap(ranks):
    """A step fault after the first re-ownership, then an elastic
    resume: bitwise the static factor."""
    for r in ranks:
        c = r["crash_elastic"]
        assert c["raised"] == ["step", 6] and c["bitwise"]
        assert c["crashed_records"]["remaps"] >= 1


def test_walk_crash_elastic_resume(ranks):
    """The static walk crashes; the resume runs elastic with skewed
    speeds, re-owning the rest over the checkpointed prefix, bitwise."""
    for r in ranks:
        c = r["crash_static"]
        assert c["raised"] == ["step", 5] and c["bitwise"]
        assert c["records"]["remaps"] >= 1


def test_shrink_to_fit_after_a_lost_rank(tmp_path):
    """Rank 3 is killed at panel KILL_STEP (a ``kill`` rule of the step
    site, scoped to host 3) while every rank checkpoints each panel:
    WorkerLost names it, shrink_to_fit records the shard_shrink rung,
    and three survivors resume from their own checkpoints at the agreed
    epoch, bitwise the single-engine factor on every survivor."""
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    env = {"SLATE_TPU_TORCH_TUNE_CACHE": str(tmp_path / "tune")}
    plan = faults.FaultPlan([{
        "site": "step", "match": {"op": "shard_potrf_ooc",
                                  "step": sc.KILL_STEP, "host": 3},
        "times": 1, "kind": "kill"}])
    lost = []

    def primary():
        procs, outs = mp.launch(
            "slate_tpu_torch.testing.shard_checks", 4,
            extra_args=["shrink", "--ckpt", ck], outdir=str(tmp_path),
            timeout=120, death_grace=5.0, lost_on_failure=True,
            env={**env, **faults.install_env_var(plan)})
        mp.assert_success(procs, outs)

    def survivors(exc):
        lost.append(exc)
        procs, outs = mp.launch(
            "slate_tpu_torch.testing.shard_checks", 3,
            extra_args=["survivors", "--ckpt", ck], outdir=str(tmp_path),
            timeout=120, env=env)
        mp.assert_success(procs, outs)
        return [r["1x3.survivors"] for r in gc.load(outs)]

    recs = elastic.shrink_to_fit(primary, survivors, op="shard_potrf_ooc")
    assert len(lost) == 1 and lost[0].process_id == 3
    assert lost[0].returncode == faults.KILL_EXIT_CODE
    assert guard.counts()["resil.fallback.shard_shrink"] == 1
    assert elastic.remap_records()["shrinks"] == 1
    L0 = ooc.potrf_ooc(X["spd"], sc.W_ELASTIC, 0, device="cpu")
    assert np.array_equal(recs[0]["l"], L0)
    for r in recs:
        assert r["resume_epoch"] == sc.KILL_STEP
        assert r["sha_l"] == recs[0]["sha_l"]

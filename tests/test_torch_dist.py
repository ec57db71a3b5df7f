"""The port's distributed core (dist/: the tree engine, grid TSQR, the
distributed stedc and steqr2, the tuning share) and the grid routes of
gels / geqrf / heev / steqr2 built on it, against the JAX package on the
CPU: one launch of four gloo ranks runs suite "dist" of
testing.grid_checks on the 2 x 2, 1 x 4 and 4 x 1 grids (twins of
tests/test_dist.py and the collective counts of tests/test_obs.py).
Every rank's result must be bitwise rank 0's. A second, small launch
kills a worker at start-up through the ``worker`` fault site."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.core.methods import MethodFactor as JMF
from slate_tpu.core.options import Option as JOpt
import slate_tpu_torch as st
from slate_tpu_torch.dist import tree as ttree
from slate_tpu_torch.resil import faults, guard
from slate_tpu_torch.testing import grid_checks as gc
from slate_tpu_torch.testing import multiproc as mp

GRIDS = ["%dx%d" % g for g in gc.GRIDS]
X = gc.inputs("dist")


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    box = {}

    def run():
        try:
            procs, outs = mp.launch(
                "slate_tpu_torch.testing.grid_checks", 4,
                extra_args=["dist"], outdir=d, timeout=240,
                env={"SLATE_TPU_TORCH_TUNE_CACHE": d + "/tune"})
            mp.assert_success(procs, outs)
            box["res"] = gc.load(outs)
        except BaseException as e:       # re-raised in the test thread
            box["exc"] = e

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _jgrid(name):
    p, q = (int(v) for v in name.split("x"))
    return jst.make_grid(p, q, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def ref(launch):
    """The JAX package's grid gels_tsqr and gels, one jit a grid."""
    J = jst.TiledMatrix.from_dense
    out = {}
    for name in GRIDS:
        o = {JOpt.Grid: _jgrid(name), JOpt.MethodFactor: JMF.Tiled}

        def prog(a, b):
            return (jst.gels_tsqr(J(a, 8), J(b, 8), o).data,
                    jst.gels(J(a, 8), J(b, 8), o).data)
        xt, xa = jax.jit(prog)(X["ts"], X["tsb"])
        out[name] = {"gels_tsqr": np.asarray(xt), "gels": np.asarray(xa)}
    return out


@pytest.fixture(scope="module")
def ranks(ref, launch):
    t, box = launch
    t.join()
    if "exc" in box:
        raise box["exc"]
    return box["res"]


def _same_on_every_rank(ranks, tag, skip=()):
    for k, v in ranks[0][tag].items():
        if isinstance(v, np.ndarray) and k not in skip:
            for r in range(1, 4):
                assert np.array_equal(v, ranks[r][tag][k]), (tag, k, r)


def _rows(name, k, rows):
    """Reference device k's row block of a row-sharded result."""
    h = rows // 4
    return slice(k * h, (k + 1) * h)


# -- the tree engine ----------------------------------------------------------

def test_tree_round_schedule_matches_reference():
    from slate_tpu.dist.tree import round_schedule as jrs
    from slate_tpu.dist.tree import schedule_ppermutes as jsp
    assert ttree.round_schedule(8, 2) == [(1, 2), (2, 2), (4, 2)]
    assert ttree.round_schedule(1, 2) == []
    for size in (1, 2, 3, 4, 6, 7, 8, 12):
        for fanin in (2, 3, 4, 8):
            assert ttree.round_schedule(size, fanin) == jrs(size, fanin)
            assert ttree.schedule_ppermutes(size, fanin) == \
                jsp(size, fanin)


@pytest.mark.parametrize("name", GRIDS)
def test_tree_allreduce_matches_psum(ranks, name):
    """The exchange butterfly reduces like a psum at fan-in 2 and 4,
    the same bits on every rank."""
    want = X["tree"].reshape(4, 4, 4).sum(axis=0)
    for fanin in ("f2", "f4"):
        np.testing.assert_allclose(ranks[0][name + ".tree"][fanin], want,
                                   rtol=1e-12)
    _same_on_every_rank(ranks, name + ".tree")


@pytest.mark.parametrize("name", GRIDS)
def test_row_apply_local(ranks, name):
    want = X["rowx"] @ X["rowg"]
    for k in range(4):
        np.testing.assert_allclose(ranks[k][name + ".row_apply"]["y"],
                                   want[_rows(name, k, 24)], rtol=1e-12)


# -- grid TSQR ----------------------------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("fanin", [2, 4])
def test_tsqr_mesh(ranks, name, fanin):
    """Q orthonormal, R upper triangular and the same on every rank,
    Q R = A, at the binary and grouped fan-ins; R is LAPACK's up to
    the signs of its rows."""
    tag = "%s.tsqr%d" % (name, fanin)
    q = np.concatenate([ranks[k][tag]["q"] for k in range(4)])
    r = ranks[0][tag]["r"]
    _same_on_every_rank(ranks, tag, skip=("q",))
    np.testing.assert_allclose(q @ r, X["ts"], atol=1e-12)
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-12)
    assert np.abs(np.tril(r, -1)).max() == 0
    jr = np.linalg.qr(X["ts"], mode="r")
    sgn = np.sign(np.diag(r)) * np.sign(np.diag(jr))
    np.testing.assert_allclose(r, sgn[:, None] * jr, atol=1e-12)


@pytest.mark.parametrize("name", GRIDS)
def test_tsqr_qt_solves_lstsq(ranks, name):
    """R and Q^H B riding the same exchanges give the least-squares
    solution by one triangular solve (104 rows: the row padding)."""
    rec = ranks[0][name + ".tsqr_qt"]
    _same_on_every_rank(ranks, name + ".tsqr_qt")
    x = np.linalg.solve(rec["r"], rec["qtb"])
    np.testing.assert_allclose(
        x, np.linalg.lstsq(X["qt"], X["qtb"], rcond=None)[0], atol=1e-10)


@pytest.mark.parametrize("name", GRIDS)
def test_gels_tsqr_mesh_matches_reference(ranks, ref, name):
    """gels_tsqr on the grid == the reference's grid gels_tsqr, with
    the tree's exchanges counted: exactly schedule_ppermutes(4, 2)
    collective-permutes (obs twin of tests/test_obs.py)."""
    _same_on_every_rank(ranks, name + ".gels_tsqr")
    rec = ranks[0][name + ".gels_tsqr"]
    np.testing.assert_allclose(rec["x"], ref[name]["gels_tsqr"],
                               rtol=1e-9, atol=1e-11)
    assert rec["expected"] == 2
    for k in range(4):
        assert ranks[k][name + ".gels_tsqr"]["counts"][
            "collective-permute"] == 2


@pytest.mark.parametrize("name", GRIDS)
def test_gels_auto_routes_tsqr_on_grid(ranks, ref, name):
    assert st.MethodGels.select(96, 8, on_grid=True) is st.MethodGels.TSQR
    assert st.MethodGels.select(96, 8) is st.MethodGels.CholQR
    assert st.MethodGels.select(96, 48, on_grid=True) is st.MethodGels.QR
    rec = ranks[0][name + ".gels_auto"]
    _same_on_every_rank(ranks, name + ".gels_auto")
    np.testing.assert_allclose(
        rec["x"][:8, :2], np.linalg.lstsq(X["ts"], X["tsb"], rcond=None)[0],
        rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rec["x"], ref[name]["gels"], rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("name", GRIDS)
def test_geqrf_grid_tall_skinny_takes_tree(ranks, name):
    """Tall-skinny geqrf on a grid takes the tree (explicit thin Q), and
    unmqr applies it as the isometry: rows past n exactly zero."""
    rec = ranks[0][name + ".geqrf_ts"]
    _same_on_every_rank(ranks, name + ".geqrf_ts")
    assert rec["explicit_q"] is True
    q, r = rec["q"][:96], np.triu(rec["qr"][:8, :8])
    np.testing.assert_allclose(q @ r, X["ts"], atol=1e-12)
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-12)
    np.testing.assert_allclose(rec["qtb"][:8], q.T @ X["tsb"], atol=1e-12)
    assert np.abs(rec["qtb"][8:]).max() == 0


# -- the distributed eigensolvers ---------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("n", [100, 129])
def test_stedc_dist_matches_single_device(ranks, name, n):
    """The grid stedc == the one-device stedc_solve to reduction-order
    rounding (the reference's claim, tests/test_dist.py; the one-device
    solver is held to the JAX package's in tests/test_torch_stedc.py);
    residual and orthogonality of the vectors."""
    tag = "%s.stedc%d" % (name, n)
    _same_on_every_rank(ranks, tag)
    w2, v2 = ranks[0][tag]["w"], ranks[0][tag]["v"]
    d, e = X["d%d" % n], X["e%d" % n]
    w1, _ = st.stedc_solve(torch.as_tensor(d), torch.as_tensor(e),
                           leaf=16)
    np.testing.assert_allclose(w2, w1.numpy(), rtol=1e-12, atol=1e-13)
    t = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    assert np.abs(t @ v2 - v2 * w2[None, :]).max() < 1e-9
    assert np.abs(v2.T @ v2 - np.eye(n)).max() < 1e-9


@pytest.mark.parametrize("name", GRIDS)
def test_heev_dc_on_mesh(ranks, name):
    rec = ranks[0][name + ".heev_dc"]
    _same_on_every_rank(ranks, name + ".heev_dc")
    a = X["sym64"]
    np.testing.assert_allclose(np.sort(rec["w"]), np.linalg.eigvalsh(a),
                               rtol=1e-9, atol=1e-10)
    v = rec["v"][:64, :64]
    assert np.abs(a @ v - v * rec["w"][None, :]).max() < 1e-8
    assert np.abs(v.T @ v - np.eye(64)).max() < 1e-8


@pytest.mark.parametrize("name", GRIDS)
def test_heev_dc_mesh_report_shows_collectives(ranks, name):
    """xprof.analyze of the grid heev(DC) records its collectives (the
    distributed stedc's gathers and broadcasts) and obs.report shows
    the record (twin of tests/test_obs.py's)."""
    for k in range(4):
        rec = ranks[k][name + ".heev_dc"]
        assert rec["collectives"]["total"] > 0 and rec["report"] is True


@pytest.mark.parametrize("name", GRIDS)
def test_steqr2_dist_bitwise_matches_single(ranks, name):
    """Each rank's rows of Z are BITWISE the one-device steqr2_qr's,
    w too; no collective is scheduled; the eigenvalues are the
    reference's."""
    from slate_tpu.linalg.eig import steqr2_qr as jsteqr2
    wj, _, _ = jsteqr2(jnp.asarray(X["d64"]), jnp.asarray(X["e64"]))
    for k in range(4):
        rec = ranks[k][name + ".steqr2_dist"]
        assert rec["bitwise"] is True and rec["info"] == 0
        assert rec["counts"] == {"all-gather": 0, "all-reduce": 0,
                                 "reduce-scatter": 0,
                                 "collective-permute": 0, "all-to-all": 0}
        np.testing.assert_allclose(rec["w"], np.asarray(wj), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("name", GRIDS)
def test_steqr2_driver_on_mesh_applies_q(ranks, name):
    rec = ranks[0][name + ".steqr2_q"]
    _same_on_every_rank(ranks, name + ".steqr2_q")
    d, e, q0 = X["d48"], X["e48"], X["q48"]
    t = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(rec["w"], np.linalg.eigvalsh(t),
                               rtol=1e-10, atol=1e-12)
    z = q0.T @ rec["v"][:48, :48]
    np.testing.assert_allclose(z @ np.diag(rec["w"]) @ z.T, t, atol=1e-10)


# -- the tuning share and the launcher ----------------------------------------

def test_tuneshare_broadcast_on_grid(ranks):
    """Rank 0's measured entry reaches every rank's cache; rank 0 keeps
    its own (nothing to adopt)."""
    for k in range(4):
        rec = ranks[k]["2x2.tuneshare"]
        assert rec["entry"] == 384
        assert rec["adopted"] == (0 if k == 0 else 1)


DISAGREE = ("gels_tsqr", "geqrf", "gemm", "getrf", "stedc_w", "stedc_v",
            "heev_w", "heev_v")


@pytest.mark.parametrize("what", DISAGREE)
def test_ranks_with_different_tune_entries_agree(ranks, what):
    """Rank 1 alone holds tune entries that would change the tsqr tree,
    the tsqr aspect gate, gemm's route, the stedc leaf, heev's route and
    the rank-1 LU kernel's width; the drivers take grid rank 0's
    choices, so every rank's result is bitwise the run in which no rank
    held an entry."""
    clean = ranks[0]["2x2.disagree"]["clean_" + what]
    for k in range(4):
        rec = ranks[k]["2x2.disagree"]
        assert np.array_equal(rec["clean_" + what], clean)
        assert np.array_equal(rec[what], clean)


def test_tune_cache_merge_keeps_the_better_measurement(tmp_path,
                                                       monkeypatch):
    from slate_tpu_torch.tune import cache as tcache
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    tcache.reset_cache()
    c = tcache.get_cache()
    c.put("getrf", torch.float32, 4096, {"nb": 256},
          meta={"results": [{"seconds": 0.2}]})
    key = next(iter(c.entries()))
    assert c.merge({key: {"nb": 512, "_meta": {"results": [
        {"seconds": 0.3}]}}}) == 0
    assert c.merge({key: {"nb": 128}}) == 0          # no evidence
    assert c.merge({key: {"nb": 1024, "_meta": {"results": [
        {"seconds": 0.1}]}}, "other": {"nb": 64}}) == 2
    assert c.entries()[key]["nb"] == 1024
    tcache.reset_cache()


def test_worker_fault_kill_is_reaped_with_worker_lost():
    """A ``kill`` at the worker site (before the rendezvous) surfaces as
    WorkerLost naming the dead worker and its exit code, within the
    death grace plus a margin, the survivor reaped."""
    plan = faults.FaultPlan([{"site": "worker", "kind": "kill",
                              "match": {"process": 1}}])
    env = faults.install_env_var(plan)
    t0 = time.monotonic()
    with pytest.raises(guard.WorkerLost) as ei:
        mp.launch("slate_tpu_torch.testing.grid_checks", 2,
                  extra_args=["collectives"], env=env, timeout=120,
                  death_grace=2.0)
    assert ei.value.process_id == 1
    assert ei.value.returncode == faults.KILL_EXIT_CODE
    assert time.monotonic() - t0 < 2.0 + 30.0

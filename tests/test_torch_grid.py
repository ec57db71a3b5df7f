"""The port's grid routes against the JAX package's on the CPU: one
launch of four gloo ranks (testing.multiproc, the worker bodies in
testing.grid_checks, suite "grid") runs every check on the 2 x 2, 1 x 4
and 4 x 1 grids; this process computes the reference on
``slate_tpu.make_grid(p, q, devices=jax.devices()[:4])`` from the same
seeded inputs (twins of tests/test_distributed.py and the grid parts of
tests/test_tiles.py::test_grid_funcs). Every rank's result must be
bitwise rank 0's; the tolerances are the reference tests'."""

import threading

import jax
import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.core.methods import MethodFactor as JMF
from slate_tpu.core.methods import MethodGels as JMG
from slate_tpu.core.methods import MethodGemm as JMGemm
from slate_tpu.core.options import Option as JOpt
import slate_tpu_torch as st
from slate_tpu_torch.parallel import sharding as tsh
from slate_tpu_torch.testing import grid_checks as gc
from slate_tpu_torch.testing import multiproc as mp

GRIDS = ["%dx%d" % g for g in gc.GRIDS]
X = gc.inputs("grid")


class _Launch:
    """The suite's one launch, run in a thread so the JAX reference
    computes meanwhile."""

    def __init__(self, suite, outdir):
        self.res, self.exc = None, None
        self.thread = threading.Thread(target=self._run,
                                       args=(suite, outdir))
        self.thread.start()

    def _run(self, suite, outdir):
        try:
            procs, outs = mp.launch(
                "slate_tpu_torch.testing.grid_checks", 4,
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
    return _Launch("grid", str(tmp_path_factory.mktemp("grid")))


def _jgrid(name):
    p, q = (int(v) for v in name.split("x"))
    return jst.make_grid(p, q, devices=jax.devices()[:4])


def _reference(g):
    """The JAX package's grid results for the suite's inputs (one jit
    program a grid)."""
    o = {JOpt.Grid: g, JOpt.MethodFactor: JMF.Tiled}
    J = jst.TiledMatrix.from_dense

    def prog(spd, b, gen, dom, tri, tb, ga, gb, gc_, tall, tallb, sq,
             herm, notspd):
        A = jst.HermitianMatrix(jst.Uplo.Lower, spd, mb=8)
        L, Xp = jst.posv(A, J(b, 8), o)
        F, Xg = jst.gesv(J(gen, 8), J(b, 8), o)
        Fn = jst.getrf_nopiv(J(dom, 8), o)
        Ft = jst.getrf_tntpiv(J(gen, 8), o)
        T = jst.TriangularMatrix(jst.Uplo.Lower, tri, mb=8)
        xt = jst.trsm(jst.Side.Left, 1.0, T, J(tb, 8), o).data
        xr = jst.trsm(jst.Side.Right, 2.0, T.conj_transpose(),
                      J(tb.T, 8), o).data
        c = jst.gemm(1.5, J(ga, 8), J(gb, 8), -0.5, J(gc_, 8), o).data
        cs = jst.gemm(1.0, J(ga, 8), J(gb, 8), 0.0, J(gc_, 8),
                      {**o, JOpt.MethodGemm: JMGemm.Summa}).data
        xg = jst.gels(J(tall, 8), J(tallb, 8), o).data
        xq = jst.gels(J(tall, 8), J(tallb, 8),
                      {**o, JOpt.MethodGels: JMG.QR}).data
        Fq = jst.geqrf(J(sq, 8), o)
        Lb = jst.potrf(jst.HermitianMatrix(jst.Uplo.Lower, spd, mb=8), o)
        Ch = jst.hegst(1, jst.HermitianMatrix(jst.Uplo.Lower, herm, mb=8),
                       Lb, o).to_dense()
        _, info = jst.potrf(jst.HermitianMatrix(jst.Uplo.Lower, notspd,
                                                mb=8), o, return_info=True)
        return dict(posv=Xp.data, posv_l=L.to_dense(), gesv=Xg.data,
                    gesv_lu=F.LU.data, gesv_piv=F.pivots, nopiv=Fn.LU.data,
                    tnt_lu=Ft.LU.data, tnt_piv=Ft.pivots, trsm=xt, trsmr=xr,
                    gemm=c, summa=cs, gels=xg, gels_qr=xq, qr=Fq.QR.data,
                    taus=Fq.taus, hegst=Ch, info=info)

    names = ("spd", "b", "gen", "dom", "tri", "tb", "ga", "gb", "gc",
             "tall", "tallb", "sq", "herm", "notspd")
    out = jax.jit(prog)(*(X[k] for k in names))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ref(launch):
    return {name: _reference(_jgrid(name)) for name in GRIDS}


@pytest.fixture(scope="module")
def ranks(ref, launch):
    return launch.result()


def _same_on_every_rank(ranks, tag):
    """Every rank's tensors of a check are bitwise rank 0's (the counts
    of collectives a rank issued may differ)."""
    for k, v in ranks[0][tag].items():
        if isinstance(v, np.ndarray):
            for r in range(1, len(ranks)):
                assert np.array_equal(v, ranks[r][tag][k],
                                      equal_nan=True), (tag, k, r)


def close(got, want, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# -- in one process: the layout and the grid objects -------------------------

def test_cyclic_tile_order_matches_reference():
    from slate_tpu.parallel import sharding as jsh
    for nt, p in ((6, 2), (8, 4), (7, 3), (5, 1)):
        assert np.array_equal(tsh.cyclic_tile_order(nt, p),
                              jsh.cyclic_tile_order(nt, p))
    assert list(tsh.cyclic_tile_order(6, 2)) == [0, 2, 4, 1, 3, 5]


def test_cyclic_roundtrip_matches_reference(rng):
    from slate_tpu.parallel import sharding as jsh
    a = rng.standard_normal((64, 96))
    for p, q in ((2, 4), (4, 1), (1, 4)):
        c = tsh.to_cyclic(torch.as_tensor(a), 8, 8, p, q)
        assert np.array_equal(c.numpy(), np.asarray(
            jsh.to_cyclic(jax.numpy.asarray(a), 8, 8, p, q)))
        assert np.array_equal(tsh.from_cyclic(c, 8, 8, p, q).numpy(), a)


def test_grid_objects_without_a_process_group():
    """Without a process group only 1 x 1 exists; its collectives are
    the identity; Option.Grid takes ProcessGrids only."""
    with pytest.raises(ValueError, match="process group"):
        st.make_grid(2, 2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        st.make_grid(q=3, ranks=[0, 1, 2, 3], device="cpu")
    g = st.make_grid(1, 1, device="cpu")
    assert (g.p, g.q, g.nprocs, g.coords) == (1, 1, 1, (0, 0))
    x = torch.arange(6.0).reshape(2, 3)
    before = st.collectives.counts()
    assert st.collectives.all_reduce(g, x) is x
    assert st.collectives.counts() == before
    A = st.Matrix(np.eye(8), mb=4, device="cpu")
    with pytest.raises(TypeError, match="ProcessGrid"):
        st.getrf(A, {st.Option.Grid: object()})
    F = st.getrf(A, {st.Option.Grid: st.single_device_grid("cpu")})
    assert torch.equal(F.LU.data, A.data)


# -- the layout on the grids -------------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
def test_distribute_cyclic_matches_reference_shards(ranks, name):
    """Rank k's shard is the bytes reference device k holds after
    distribute_cyclic; undistribute gives the matrix back."""
    from slate_tpu.parallel.sharding import distribute_cyclic as jdc
    g = _jgrid(name)
    D = jdc(jst.TiledMatrix.from_dense(X["cyc"], 8), g)
    shards = {s.device: np.asarray(s.data) for s in
              D.data.addressable_shards}
    for k, dev in enumerate(jax.devices()[:4]):
        rec = ranks[k][name + ".cyclic"]
        assert np.array_equal(rec["shard"], shards[dev]), k
        assert np.array_equal(rec["back"], X["cyc"])


@pytest.mark.parametrize("name", GRIDS)
def test_cyclic_matches_process_2d_grid(ranks, name):
    """Each rank's shard holds exactly the tiles process_2d_grid gives
    its grid position (reference test_cyclic_matches_process_2d_grid)."""
    assert all(ranks[k][name + ".cyclic"]["func_agrees"] for k in range(4))


@pytest.mark.parametrize("name", GRIDS)
def test_gridinfo_and_tile_ranks(ranks, name):
    """Rank k sits at the position of reference device k; gridinfo and
    tile_rank_func agree with the reference's."""
    g = _jgrid(name)
    for k in range(4):
        rec = ranks[k][name + ".cyclic"]
        assert rec["coords"] == [k // g.q, k % g.q]
        assert rec["gridinfo"] == [[i, [i // g.q, i % g.q]]
                                   for i in range(4)]
        tf = g.tile_rank_func()
        assert rec["tile_ranks"] == [[tf((i, j)) for j in range(6)]
                                     for i in range(6)]


# -- the drivers --------------------------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
def test_posv_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".posv"]
    _same_on_every_rank(ranks, name + ".posv")
    close(rec["x"], ref[name]["posv"])
    close(np.tril(rec["l"]), np.tril(ref[name]["posv_l"]))


@pytest.mark.parametrize("name", GRIDS)
def test_gesv_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".gesv"]
    _same_on_every_rank(ranks, name + ".gesv")
    close(rec["x"], ref[name]["gesv"], rtol=1e-9, atol=1e-11)
    close(rec["lu"], ref[name]["gesv_lu"])
    assert np.array_equal(rec["piv"], ref[name]["gesv_piv"])


@pytest.mark.parametrize("name", GRIDS)
def test_grid_gesv_counts_collectives(ranks, name):
    """The grid gesv issues collectives, counted under the reference's
    kinds and read back by obs.xprof.collective_counts."""
    for k in range(4):
        rec = ranks[k][name + ".gesv"]
        assert rec["counts"]["all-reduce"] > 0
        assert rec["counts"]["collective-permute"] == 0
        assert rec["xprof"]["total"] >= rec["counts"]["all-reduce"]


@pytest.mark.parametrize("name", GRIDS)
def test_getrf_nopiv_on_mesh(ranks, ref, name):
    _same_on_every_rank(ranks, name + ".nopiv")
    close(ranks[0][name + ".nopiv"]["lu"], ref[name]["nopiv"])


@pytest.mark.parametrize("name", GRIDS)
def test_getrf_tntpiv_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".tntpiv"]
    _same_on_every_rank(ranks, name + ".tntpiv")
    assert np.array_equal(rec["piv"], ref[name]["tnt_piv"])
    close(rec["lu"], ref[name]["tnt_lu"])


@pytest.mark.parametrize("name", GRIDS)
def test_trsm_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".trsm"]
    _same_on_every_rank(ranks, name + ".trsm")
    x_ref = np.linalg.solve(X["tri"], X["tb"])
    close(rec["x"][:32, :8], x_ref, rtol=1e-9, atol=1e-10)
    close(rec["x"], ref[name]["trsm"])
    close(rec["xr"], ref[name]["trsmr"])


@pytest.mark.parametrize("name", GRIDS)
def test_gemm_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".gemm"]
    _same_on_every_rank(ranks, name + ".gemm")
    want = 1.5 * X["ga"] @ X["gb"] - 0.5 * X["gc"]
    close(rec["c"][:24, :16], want, rtol=1e-12, atol=1e-13)
    close(rec["c"], ref[name]["gemm"], rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", GRIDS)
def test_gemm_summa_method(ranks, ref, name):
    """MethodGemm.Summa on a grid: the explicit schedule's product,
    moved by all-reduces (the masked psum of each step's panel)."""
    rec = ranks[0][name + ".gemm"]
    close(rec["summa"][:24, :16], X["ga"] @ X["gb"], rtol=1e-12,
          atol=1e-13)
    close(rec["summa"], ref[name]["summa"], rtol=1e-12, atol=1e-13)
    assert rec["counts"]["all-reduce"] > 0


@pytest.mark.parametrize("name", GRIDS)
def test_gels_on_mesh(ranks, ref, name):
    rec = ranks[0][name + ".gels"]
    _same_on_every_rank(ranks, name + ".gels")
    x_ref = np.linalg.lstsq(X["tall"], X["tallb"], rcond=None)[0]
    for key, rkey in (("x", "gels"), ("xqr", "gels_qr")):
        close(rec[key][:16, :2], x_ref, rtol=1e-8, atol=1e-10)
        close(rec[key], ref[name][rkey], rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", GRIDS)
def test_geqrf_on_mesh(ranks, ref, name):
    """A square geqrf on a grid keeps the packed Householder contract
    and matches the reference's grid loop."""
    rec = ranks[0][name + ".geqrf"]
    _same_on_every_rank(ranks, name + ".geqrf")
    assert rec["explicit_q"] is False
    close(rec["qr"], ref[name]["qr"])
    close(rec["taus"], ref[name]["taus"])


@pytest.mark.parametrize("name", GRIDS)
def test_hegst_on_mesh(ranks, ref, name):
    _same_on_every_rank(ranks, name + ".hegst")
    close(ranks[0][name + ".hegst"]["c"], ref[name]["hegst"])


@pytest.mark.parametrize("name", GRIDS)
def test_potrf_info_on_mesh(ranks, ref, name):
    for k in range(4):
        assert ranks[k][name + ".potrf_info"]["info"] == \
            int(ref[name]["info"]) > 0


@pytest.mark.parametrize("name", GRIDS)
def test_potrf_cyclic_input(ranks, name):
    """distribute_cyclic in, undistribute out, the same factor as the
    one-device Tiled potrf (reference test_potrf_cyclic_input)."""
    rec = ranks[0][name + ".cyclic_potrf"]
    _same_on_every_rank(ranks, name + ".cyclic_potrf")
    close(np.tril(rec["l"]), np.tril(rec["solo"]))


@pytest.mark.parametrize("name", GRIDS)
def test_heev_on_mesh(ranks, name):
    """heev with a grid in its options: the eigenvalues, the same on
    every rank (reference test_heev_on_mesh)."""
    w = ranks[0][name + ".cyclic_potrf"]["heev_w"]
    close(np.sort(w), np.linalg.eigvalsh(X["herm"]), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("name", GRIDS)
def test_redistribute_onto_grid(ranks, name):
    """redistribute onto a grid copies into B's tiling, the same on
    every rank (reference redistribute's values)."""
    _same_on_every_rank(ranks, name + ".redistribute")
    ref = jst.redistribute(jst.TiledMatrix.from_dense(X["cyc"], 8),
                           jst.TiledMatrix.zeros(64, 64, 16, 8,
                                                 dtype=np.float64))
    assert np.array_equal(ranks[0][name + ".redistribute"]["y"],
                          np.asarray(ref.data))


@pytest.mark.parametrize("op", ["potrf", "getrf", "geqrf"])
@pytest.mark.parametrize("name", GRIDS)
def test_flop_balance(ranks, name, op):
    """Each rank's counted trailing-update FLOPs are below half of the
    solo run's (the same driver on a 1 x 1 grid): the owner-computes
    loop divides the bulk work, as the reference's cost model shows
    (tests/test_distributed.py:210-283)."""
    for k in range(4):
        mine, solo = ranks[k][name + ".balance"]["flops"][op]
        assert 0 < mine < solo / 2, (k, mine, solo)

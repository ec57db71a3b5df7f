"""Worker bodies of the grid runs, shared by the tests and
``chip_smoke.py`` so both run the same code:

    python -m slate_tpu_torch.testing.grid_checks <rank> <rendezvous>
        <ranks> <suite> [--device D] [--backend B]

launched by :func:`testing.multiproc.launch`. The worker joins the
process group, builds the grids of its suite over the world (2 x 2,
1 x 4 and 4 x 1 over four ranks: a square grid alone hides a p / q
mix-up) and runs every check of the suite on each. Each check saves its
tensors as ``.npy`` files in the launch's output directory and emits
one record (:func:`multiproc.emit`) whose fields are those paths and
its scalars; :func:`load` reads them back in the parent.

Suites: ``collectives`` (the explicit collectives on local blocks),
``grid`` (the drivers' grid routes, the 2D block-cyclic layout, the
FLOP balance), ``dist`` (the tree engine, grid TSQR, steqr2 / stedc,
the tuning share, ranks whose tune caches differ) and ``chip`` (posv, gesv and SUMMA at n = 4096, f32,
for ``chip_smoke.py``). The inputs are numpy arrays from fixed seeds
(:func:`inputs`), the same in the parent. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from . import multiproc as mp

GRIDS = ((2, 2), (1, 4), (4, 1))


def _spd(rng, n):
    x = rng.standard_normal((n, n))
    return x @ x.T / n + 4 * np.eye(n)


def inputs(suite: str) -> Dict[str, np.ndarray]:
    """The seeded numpy inputs of a suite (the parent builds the same)."""
    rng = np.random.default_rng(42)
    if suite == "collectives":
        x = {"a16": rng.standard_normal((16, 16)),
             "r8": rng.standard_normal((8, 16)),
             "s32a": rng.standard_normal((32, 32)),
             "s32b": rng.standard_normal((32, 32)),
             "s16a": rng.standard_normal((16, 16)),
             "s16b": rng.standard_normal((16, 16)),
             "reca": rng.standard_normal((16, 8)),
             "recb": rng.standard_normal((8, 12))}
        for k in (7, 5):
            x["rga%d" % k] = rng.standard_normal((16, k))
            x["rgb%d" % k] = rng.standard_normal((k, 8))
        return x
    if suite == "grid":
        n = 32
        return {"spd": _spd(rng, n), "b": rng.standard_normal((n, 4)),
                "gen": rng.standard_normal((n, n)) + 0.1 * n * np.eye(n),
                "dom": rng.standard_normal((n, n)) + n * np.eye(n),
                "tri": np.tril(rng.standard_normal((n, n))) + 4 * np.eye(n),
                "tb": rng.standard_normal((n, 8)),
                "ga": rng.standard_normal((24, 32)),
                "gb": rng.standard_normal((32, 16)),
                "gc": rng.standard_normal((24, 16)),
                "tall": rng.standard_normal((48, 16)),
                "tallb": rng.standard_normal((48, 2)),
                "sq": rng.standard_normal((32, 32)),
                "herm": (lambda h: (h + h.T) / 2)(
                    rng.standard_normal((n, n))),
                "cyc": rng.standard_normal((64, 64)),
                "notspd": _spd(rng, n) - 6 * np.eye(n),
                "bal_spd": _spd(rng, 256).astype(np.float32),
                "bal_gen": (rng.standard_normal((256, 256))
                            + 25.6 * np.eye(256)).astype(np.float32)}
    if suite == "dist":
        return {"tree": rng.standard_normal((16, 4)),
                "rowx": rng.standard_normal((24, 16)),
                "rowg": rng.standard_normal((16, 16)),
                "ts": rng.standard_normal((96, 8)),
                "tsb": rng.standard_normal((96, 2)),
                "qt": rng.standard_normal((104, 8)),
                "qtb": rng.standard_normal((104, 3)),
                "d100": rng.standard_normal(100),
                "e100": rng.standard_normal(99),
                "d129": rng.standard_normal(129),
                "e129": rng.standard_normal(128),
                "sym64": (lambda h: (h + h.T) / 2)(
                    rng.standard_normal((64, 64))),
                "d64": rng.standard_normal(64),
                "e64": rng.standard_normal(63),
                "d48": rng.standard_normal(48),
                "e48": rng.standard_normal(47),
                "q48": np.linalg.qr(rng.standard_normal((48, 48)))[0]}
    if suite == "chip":
        return {}
    raise ValueError("unknown suite %r" % suite)


class _Out:
    """Saves one check's tensors as .npy files and emits their paths."""

    def __init__(self, suite: str, rank: int) -> None:
        self.suite, self.rank = suite, rank
        self.dir = mp.outdir()

    def put(self, tag: str, **items) -> None:
        fields = {}
        for k, v in items.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            if isinstance(v, np.ndarray):
                path = os.path.join(self.dir, "%s.%s.%s.r%d.npy" % (
                    self.suite, tag, k, self.rank))
                np.save(path, v)
                fields[k] = {"npy": path}
            else:
                fields[k] = v
        mp.emit(tag, **fields)


def load(outs: List[str]) -> List[Dict[str, dict]]:
    """Per rank, {tag: {key: array or scalar}} from the workers'
    outputs (the parent side of :class:`_Out`)."""
    ranks = []
    for out in outs:
        recs = mp.results(out)
        for rec in recs.values():
            for k, v in list(rec.items()):
                if isinstance(v, dict) and "npy" in v:
                    rec[k] = np.load(v["npy"])
        ranks.append(recs)
    return ranks


def _t(x: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(x, device=dev)


# -- suites ----------------------------------------------------------------

def _collectives(grid, x, out: _Out, tag: str) -> None:
    from ..parallel import collectives as coll
    from ..parallel.sharding import assemble, local_block
    dev = grid.device

    def lb(name):
        return local_block(grid, _t(x[name], dev))

    c0 = coll.counts()
    out.put(tag + ".row_bcast", y=coll.row_bcast(grid, lb("a16")))
    out.put(tag + ".col_bcast", y=coll.col_bcast(grid, lb("a16")))
    out.put(tag + ".col_reduce", y=coll.col_reduce(grid, lb("a16")))
    out.put(tag + ".row_reduce", y=coll.row_reduce(grid, lb("a16")))
    out.put(tag + ".col_reduce_scatter",
            y=coll.col_reduce_scatter(grid, lb("a16")))
    out.put(tag + ".ring_shift", y=coll.ring_shift(grid, lb("r8"), "q", 1))
    out.put(tag + ".kinds", counts=coll.counts_delta(c0))
    c0 = coll.counts()
    out.put(tag + ".summa", y=coll.summa_gemm(grid, lb("s32a"), lb("s32b")),
            counts=coll.counts_delta(c0))
    out.put(tag + ".summa16",
            y=coll.summa_gemm(grid, lb("s16a"), lb("s16b")))
    out.put(tag + ".summa_rect",
            y=coll.summa_gemm(grid, lb("reca"), lb("recb")),
            bulk=coll.summa_gemm_allgather(grid, lb("reca"), lb("recb")))
    for k in (7, 5):
        a, b = coll.pad_k(grid, _t(x["rga%d" % k], dev),
                          _t(x["rgb%d" % k], dev))
        blk = coll.summa_gemm(grid, local_block(grid, a),
                              local_block(grid, b))
        out.put(tag + ".ragged%d" % k, y=assemble(grid, blk, (16, 8)))


def _solve_opts(grid):
    import slate_tpu_torch as st
    return {st.Option.Grid: grid, st.Option.MethodFactor:
            st.MethodFactor.Tiled}


def _balance(grid, x, out: _Out, tag: str) -> None:
    """Each rank's counted trailing-update FLOPs against the solo run's
    (the same driver on a 1 x 1 grid), reference
    tests/test_distributed.py:210-283."""
    import slate_tpu_torch as st
    from ..parallel import owner
    from ..parallel.mesh import single_device_grid
    dev = grid.device
    calls = {
        "potrf": lambda o: st.potrf(st.HermitianMatrix(
            st.Uplo.Lower, _t(x["bal_spd"], dev), mb=32, device=dev), o),
        "getrf": lambda o: st.getrf(st.Matrix(_t(x["bal_gen"], dev),
                                              mb=32, device=dev), o),
        "geqrf": lambda o: st.geqrf(st.Matrix(_t(x["bal_gen"], dev),
                                              mb=32, device=dev), o)}
    solo = single_device_grid(dev)
    fl = {}
    for name, call in calls.items():
        owner.reset_flops()
        call(_solve_opts(solo))
        s = owner.flops()
        owner.reset_flops()
        call(_solve_opts(grid))
        fl[name] = [owner.flops(), s]
    out.put(tag + ".balance", flops=fl)


def _grid(grid, x, out: _Out, tag: str) -> None:
    import slate_tpu_torch as st
    from ..core.func import process_2d_grid
    from ..parallel import collectives as coll
    from ..parallel.sharding import (cyclic_tile_order, distribute_cyclic,
                                     undistribute)
    dev = grid.device
    o = _solve_opts(grid)
    mat = lambda name, mb=8: st.Matrix(_t(x[name], dev), mb=mb,  # noqa
                                       device=dev)
    A = st.HermitianMatrix(st.Uplo.Lower, _t(x["spd"], dev), mb=8,
                           device=dev)
    B = mat("b")
    L, X = st.posv(A, B, o)
    out.put(tag + ".posv", x=X.data, l=L.to_dense())
    from ..obs import xprof
    c0 = coll.counts()
    F, X = st.gesv(mat("gen"), B, o)
    out.put(tag + ".gesv", x=X.data, lu=F.LU.data, piv=F.pivots,
            counts=coll.counts_delta(c0), xprof=xprof.collective_counts())
    F = st.getrf_nopiv(mat("dom"), o)
    out.put(tag + ".nopiv", lu=F.LU.data)
    F = st.getrf_tntpiv(mat("gen"), o)
    out.put(tag + ".tntpiv", lu=F.LU.data, piv=F.pivots)
    T = st.TriangularMatrix(st.Uplo.Lower, _t(x["tri"], dev), mb=8,
                            device=dev)
    out.put(tag + ".trsm", x=st.trsm(st.Side.Left, 1.0, T, mat("tb"),
                                     o).data,
            xr=st.trsm(st.Side.Right, 2.0, T.conj_transpose(),
                       st.Matrix(_t(x["tb"].T.copy(), dev), mb=8,
                                 device=dev),
                       o).data)
    C = mat("gc")
    c = st.gemm(1.5, mat("ga"), mat("gb"), -0.5, C, o).data
    c0 = coll.counts()
    summa = st.gemm(1.0, mat("ga"), mat("gb"), 0.0, C,
                    {**o, st.Option.MethodGemm: st.MethodGemm.Summa}).data
    out.put(tag + ".gemm", c=c, summa=summa, counts=coll.counts_delta(c0))
    out.put(tag + ".gels", x=st.gels(mat("tall"), mat("tallb"), o).data,
            xqr=st.gels(mat("tall"), mat("tallb"),
                        {**o, st.Option.MethodGels:
                         st.MethodGels.QR}).data)
    Fq = st.geqrf(mat("sq"), o)
    out.put(tag + ".geqrf", qr=Fq.QR.data, taus=Fq.taus,
            explicit_q=Fq.Q is not None)
    Lb = st.potrf(st.HermitianMatrix(st.Uplo.Lower, _t(x["spd"], dev),
                                     mb=8, device=dev), o)
    Ah = st.HermitianMatrix(st.Uplo.Lower, _t(x["herm"], dev), mb=8,
                            device=dev)
    out.put(tag + ".hegst", c=st.hegst(1, Ah, Lb, o).to_dense())
    _, info = st.potrf(st.HermitianMatrix(
        st.Uplo.Lower, _t(x["notspd"], dev), mb=8, device=dev), o,
        return_info=True)
    out.put(tag + ".potrf_info", info=int(info))
    # the 2D block-cyclic layout
    Ac = st.Matrix(_t(x["cyc"], dev), mb=8, device=dev)
    D = distribute_cyclic(Ac, grid)
    back = undistribute(D, grid)
    r, c = grid.coords
    rank_of = process_2d_grid(st.GridOrder.Col, grid.p, grid.q)
    rows, cols = cyclic_tile_order(8, grid.p), cyclic_tile_order(8, grid.q)
    h, w = 8 // grid.p, 8 // grid.q
    agree = all(rank_of((int(rows[r * h + i]), int(cols[c * w + j])))
                == r + c * grid.p for i in range(h) for j in range(w))
    tf = grid.tile_rank_func()
    out.put(tag + ".cyclic", shard=D.data, back=back.data,
            func_agrees=bool(agree), coords=list(grid.coords),
            tile_ranks=[[tf((i, j)) for j in range(6)] for i in range(6)],
            gridinfo=[[k, list(v)] for k, v in
                      sorted(grid.gridinfo()[3].items())])
    Sp = st.HermitianMatrix(st.Uplo.Lower, _t(x["spd"], dev), mb=8,
                            device=dev)
    Ls = st.potrf(Sp, {st.Option.MethodFactor: st.MethodFactor.Tiled})
    Lc = st.potrf(undistribute(distribute_cyclic(Sp, grid), grid), o)
    wh, _ = st.heev(Ah, o)
    out.put(tag + ".cyclic_potrf", l=Lc.to_dense(), solo=Ls.to_dense(),
            heev_w=wh)
    Bt = st.Matrix(torch.zeros((64, 64), dtype=torch.float64, device=dev),
                   mb=16, nb=8, device=dev)
    out.put(tag + ".redistribute", y=st.redistribute(Ac, Bt, o).data)
    _balance(grid, x, out, tag)


def _dist(grid, x, out: _Out, tag: str) -> None:
    import slate_tpu_torch as st
    from .. import dist
    from ..dist import tree
    from ..linalg.eig import steqr2_qr
    from ..obs import xprof
    from ..parallel import collectives as coll
    from ..tune import cache as tcache
    dev = grid.device
    o = _solve_opts(grid)
    xt = _t(x["tree"], dev)
    rows = tree.row_block(grid, 16)
    sums = {}
    for fanin in (2, 4):
        sums["f%d" % fanin] = coll.tree_allreduce(grid, xt[rows],
                                                  fanin=fanin)
    out.put(tag + ".tree", **sums)
    out.put(tag + ".row_apply", y=dist.row_apply(
        grid, lambda xs, g: xs @ g, _t(x["rowx"], dev), _t(x["rowg"], dev)))
    for fanin in (2, 4):
        saved = tcache.FROZEN[("tsqr", "tree_fanin")]
        tcache.FROZEN[("tsqr", "tree_fanin")] = fanin
        try:
            ql, R = dist.tsqr_mesh(grid, _t(x["ts"], dev))
        finally:
            tcache.FROZEN[("tsqr", "tree_fanin")] = saved
        out.put(tag + ".tsqr%d" % fanin, q=ql, r=R)
    R, qtb = dist.tsqr_qt(grid, _t(x["qt"], dev), _t(x["qtb"], dev))
    out.put(tag + ".tsqr_qt", r=R, qtb=qtb)
    A = st.Matrix(_t(x["ts"], dev), mb=8, device=dev)
    B = st.Matrix(_t(x["tsb"], dev), mb=8, device=dev)
    c0 = coll.counts()
    X = st.gels_tsqr(A, B, o)
    out.put(tag + ".gels_tsqr", x=X.data, counts=coll.counts_delta(c0),
            expected=tree.schedule_ppermutes(grid.nprocs, 2))
    out.put(tag + ".gels_auto", x=st.gels(A, B, o).data)
    F = st.geqrf(A, o)
    QtB = st.unmqr(st.Side.Left, F, B, trans=True, opts=o)
    out.put(tag + ".geqrf_ts", q=F.Q.to_dense() if F.Q is not None
            else np.zeros(0), qr=F.QR.data, qtb=QtB.to_dense(),
            explicit_q=F.Q is not None)
    for n in (100, 129):
        w, V = dist.stedc_solve_dist(grid, _t(x["d%d" % n], dev),
                                     _t(x["e%d" % n], dev), leaf=16)
        out.put(tag + ".stedc%d" % n, w=w, v=V)
    Ah = st.HermitianMatrix(st.Uplo.Lower, _t(x["sym64"], dev), mb=8,
                            device=dev)
    od = {**o, st.Option.MethodEig: st.MethodEig.DC}
    w, V = st.heev(Ah, od)
    rec = xprof.analyze("heev_dc_grid", st.heev, Ah, od)
    out.put(tag + ".heev_dc", w=w, v=V.to_dense(),
            collectives=rec["collectives"],
            report="heev_dc_grid" in st.obs.report())
    d, e = _t(x["d64"], dev), _t(x["e64"], dev)
    c0 = coll.counts()
    w2, Zl, info = dist.steqr2_qr_dist(grid, d, e)
    cnt = coll.counts_delta(c0)
    w1, Z1, _ = steqr2_qr(d, e)
    rb = tree.row_block(grid, Z1.shape[0])
    out.put(tag + ".steqr2_dist", w=w2, z=Zl, info=int(info), counts=cnt,
            bitwise=bool(torch.equal(w1, w2) and torch.equal(Z1[rb], Zl)))
    Q = st.Matrix(_t(x["q48"], dev), mb=8, device=dev)
    w, V = st.steqr2(_t(x["d48"], dev), _t(x["e48"], dev), Q, o)
    out.put(tag + ".steqr2_q", w=w, v=V.to_dense())


def _tuneshare(grid, out: _Out, tag: str) -> None:
    """Rank 0's measured entry reaches every rank's cache."""
    from ..dist.tuneshare import share_tuning_table
    from ..tune import cache as tcache
    os.environ["SLATE_TPU_TORCH_TUNE_CACHE"] = os.path.join(
        out.dir, "tune_share.r%d" % grid.rank)
    tcache.reset_cache()
    cache = tcache.get_cache()
    if grid.index == 0:
        cache.put("getrf", torch.float32, 4096, {"nb": 384},
                  meta={"results": [{"seconds": 0.5}]})
    adopted = share_tuning_table(grid)
    out.put(tag + ".tuneshare", adopted=adopted,
            entry=cache.get_param("getrf", "nb", torch.float32, 4096))


def _disagree(grid, x, out: _Out, tag: str) -> None:
    """The grid routes whose loop or collectives a tune entry shapes,
    run with every rank's cache empty, then again with rank 1 alone
    holding entries that would change them (the tsqr fan-in and aspect
    gate, gemm's SUMMA promotion, the stedc leaf, heev's route, the
    rank-1 LU kernel's width): the drivers take grid rank 0's choices,
    so both runs agree on every rank."""
    import slate_tpu_torch as st
    from ..tune import cache as tcache
    dev = grid.device
    o = _solve_opts(grid)
    f64 = torch.float64

    def run():
        A = st.Matrix(_t(x["ts"], dev), mb=8, device=dev)
        B = st.Matrix(_t(x["tsb"], dev), mb=8, device=dev)
        G = st.Matrix(_t(x["rowg"], dev), mb=8, device=dev)
        F = st.geqrf(A, o)
        w, V = st.stedc(_t(x["d100"], dev), _t(x["e100"], dev), None, o)
        wh, Vh = st.heev(st.HermitianMatrix(
            st.Uplo.Lower, _t(x["sym64"], dev), mb=8, device=dev),
            {st.Option.Grid: grid})
        return {"gels_tsqr": st.gels_tsqr(A, B, o).data,
                "geqrf": F.QR.data,
                "gemm": st.gemm(1.0, G, G, 0.0, G,
                                {st.Option.Grid: grid}).data,
                "getrf": st.getrf(G, o).LU.data,
                "stedc_w": w, "stedc_v": V, "heev_w": wh,
                "heev_v": Vh.to_dense()}

    os.environ["SLATE_TPU_TORCH_TUNE_CACHE"] = os.path.join(
        out.dir, "tune_disagree.r%d" % grid.rank)
    tcache.reset_cache()
    clean = run()
    if grid.index == 1:
        cache = tcache.get_cache()
        meta = {"results": [{"seconds": 0.1}]}
        cache.put("tsqr", f64, 8, {"tree_fanin": 4, "panel_aspect": 1000},
                  meta=meta)
        cache.put("gemm", f64, 16, {"method_gemm": "Summa"}, meta=meta)
        cache.put("stedc", f64, 100, {"leaf": 16}, meta=meta)
        cache.put("heev", f64, 64, {"method_eig": "DC"}, meta=meta)
        cache.put("lu_panel", None, None, {"max_w": 8}, meta=meta)
    out.put(tag + ".disagree", **{"clean_" + k: v for k, v in clean.items()},
            **run())


#: order and tile size of suite "chip"
CHIP_N, CHIP_NB = 4096, 512


def chip_run(grid, n: int = CHIP_N) -> dict:
    """posv and gesv at order n, f32, tiles CHIP_NB, 64 right-hand sides,
    on systems made on the grid's device from fixed seeds
    (testing.spd_system, testing.permuted_boosted_system), and SUMMA of
    their two matrices (gathered); each solve with this rank's counted
    trailing-update FLOPs. chip_smoke.py runs it on a 1 x 1 grid and in
    suite "chip" on 2 x 2."""
    import slate_tpu_torch as st
    from ..parallel import owner
    from ..parallel.collectives import summa_gemm
    from ..parallel.sharding import assemble, local_block
    from ..testing import permuted_boosted_system, spd_system
    dev = grid.device
    gen = torch.Generator(dev).manual_seed(7)
    s, b = spd_system(gen, n, 64)
    a, _ = permuted_boosted_system(gen, n, 64)
    o = {st.Option.Grid: grid}
    owner.reset_flops()
    _, X = st.posv(st.HermitianMatrix(st.Uplo.Lower, s, mb=CHIP_NB,
                                      device=dev),
                   st.Matrix(b, mb=CHIP_NB, device=dev), o)
    fp = owner.flops()
    owner.reset_flops()
    F, Y = st.gesv(st.Matrix(a, mb=CHIP_NB, device=dev),
                   st.Matrix(b, mb=CHIP_NB, device=dev), o)
    fg = owner.flops()
    c = summa_gemm(grid, local_block(grid, s), local_block(grid, a))
    return {"posv": X.data, "gesv": Y.data, "piv": F.pivots,
            "summa": assemble(grid, c, (n, n)),
            "flops": {"potrf": fp, "getrf": fg}}


def _chip(grid, out: _Out, tag: str) -> None:
    r = chip_run(grid)
    out.put(tag + ".chip", **r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("rdzv")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("suite")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ..parallel.mesh import make_grid
    out = _Out(args.suite, args.rank)
    x = inputs(args.suite)
    dev = torch.device(args.device)
    if args.suite == "chip":
        grid, _ = mp.startup(args.rank, args.rdzv, args.nprocs, 2, 2,
                             backend=args.backend, device=args.device)
        _chip(grid, out, "2x2")
    else:
        mp.init(args.rank, args.rdzv, args.nprocs, backend=args.backend,
                device=args.device)
        for p, q in GRIDS:
            grid = make_grid(p, q, device=dev)
            tag = "%dx%d" % (p, q)
            {"collectives": _collectives, "grid": _grid,
             "dist": _dist}[args.suite](grid, x, out, tag)
        if args.suite == "dist":
            _tuneshare(make_grid(2, 2, device=dev), out, "2x2")
            _disagree(make_grid(2, 2, device=dev), x, out, "2x2")
    mp.emit("done")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

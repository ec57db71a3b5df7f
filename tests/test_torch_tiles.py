"""Non-uniform tiles of the port against the JAX package: ``from_func``
(from size lists and from ``uniform_blocksize``), ``tile``, ``sub``,
``transpose().resolve()``, ``uniform()``, ``from_jax_state``, and the
drivers on non-uniform operands (the cases of tests/test_tiles.py).

The same seeded numpy inputs (f64) go through both packages on the
CPU; results must agree within 1e-10, and where the JAX driver raises,
the port must raise the same exception class."""

import dataclasses

import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.core import func as jfunc
from slate_tpu.core.tiles import TiledMatrix as JTM

import slate_tpu_torch as st
from slate_tpu_torch.core import func as tfunc
from slate_tpu_torch.core.tiles import TiledMatrix as TTM

TOL = 1e-10
#: tile sizes whose largest does not divide the order, and whose
#: largest does: the padded layout differs from the exact one only in
#: the first
SIZES = ([5, 9, 6, 4], [4, 8, 8, 4])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _both(a, rows, cols=None, **kw):
    """The same non-uniform matrix in both packages; kw are fields set
    afterwards (mtype, uplo, diag, kl, ku) by name."""
    J = JTM.from_func(a, rows, cols)
    T = TTM.from_func(a, rows, cols, device="cpu")
    jkw = {k: getattr(jst, type(v).__name__)[v.name] if hasattr(v, "name")
           else v for k, v in kw.items()}
    return dataclasses.replace(J, **jkw), dataclasses.replace(T, **kw)


def _raises_as(exc, fn, *args, **kw):
    """fn raises an exception of the class `exc` has; a class of the
    JAX package's own matches the port's class of the same name."""
    with pytest.raises(Exception) as got:
        fn(*args, **kw)
    assert type(got.value).__name__ == type(exc).__name__, got.value
    if type(exc).__module__ == "builtins":
        assert type(got.value) is type(exc)


def _geometry(M):
    return (M.m, M.n, M.mb, M.nb, M.mt, M.nt, M.rb, M.cb,
            [M.tileMb(i) for i in range(M.mt)],
            [M.tileNb(j) for j in range(M.nt)])


@pytest.mark.parametrize("rows,cols", [([4, 10, 6], [8, 6]),
                                       ([20], [3, 3, 3, 5]),
                                       ([1] * 20, [14])])
def test_from_func_lists_match_jax(rng, rows, cols):
    a = rng.standard_normal((20, 14))
    J = JTM.from_func(a, rows, cols)
    T = TTM.from_func(a, rows, cols, device="cpu")
    assert _geometry(T) == _geometry(J)
    for i in range(J.mt):
        for j in range(J.nt):
            assert np.array_equal(_np(T.tile(i, j)), np.asarray(J.tile(i, j)))
    assert np.array_equal(T.to_numpy(), J.to_numpy())
    assert np.array_equal(T.to_numpy(), a)


@pytest.mark.parametrize("m,n,bm,bn", [(20, 14, 6, 6), (24, 24, 7, 24),
                                       (9, 31, 4, 10)])
def test_from_func_size_funcs_match_jax(rng, m, n, bm, bn):
    a = rng.standard_normal((m, n))
    J = JTM.from_func(a, jfunc.uniform_blocksize(m, bm),
                      jfunc.uniform_blocksize(n, bn))
    T = TTM.from_func(a, tfunc.uniform_blocksize(m, bm),
                      tfunc.uniform_blocksize(n, bn), device="cpu")
    assert _geometry(T) == _geometry(J)
    assert np.array_equal(T.to_numpy(), a)


def test_from_func_rejects_as_jax(rng):
    a = rng.standard_normal((6, 6))
    for x, args in ((a, ([2, 2], None)), (a, ([3, 0, 3], None)),
                    (a, (lambda i: 0, None)), (np.zeros((0, 3)), ([1],))):
        with pytest.raises(Exception) as je:
            JTM.from_func(x, *args)
        _raises_as(je.value, TTM.from_func, x, *args, device="cpu")


@pytest.mark.parametrize("sizes", SIZES)
def test_sub_transpose_uniform_match_jax(rng, sizes):
    a = rng.standard_normal((24, 24))
    J, T = _both(a, sizes)
    for idx in ((1, 2, 0, 1), (0, 3, 2, 3), (2, 2, 1, 1)):
        Js, Ts = J.sub(*idx), T.sub(*idx)
        assert _geometry(Ts) == _geometry(Js)
        assert np.array_equal(Ts.to_numpy(), Js.to_numpy())
    Jt, Tt = J.transpose().resolve(), T.transpose().resolve()
    assert _geometry(Tt) == _geometry(Jt)
    assert np.array_equal(Tt.to_numpy(), a.T)
    # a transposed view's sub resolves first, boundaries swapped
    assert np.array_equal(T.transpose().sub(0, 1, 1, 2).to_numpy(),
                          J.transpose().sub(0, 1, 1, 2).to_numpy())
    Ju, Tu = J.uniform(), T.uniform()
    assert Tu.rb is None and Tu.cb is None
    assert (Tu.m, Tu.n, Tu.mb, Tu.nb, Tu.mt, Tu.nt) == \
        (Ju.m, Ju.n, Ju.mb, Ju.nb, Ju.mt, Ju.nt)
    assert np.array_equal(_np(Tu.data), np.asarray(Ju.data))
    assert Tu.uniform() is Tu
    # slice re-tiles from element 0, uniformly
    Jl, Tl = J.slice(2, 13, 3, 20), T.slice(2, 13, 3, 20)
    assert (Tl.rb, Tl.mb, Tl.mt) == (Jl.rb, Jl.mb, Jl.mt)
    assert np.array_equal(Tl.to_numpy(), Jl.to_numpy())
    # emptyLike is uniform at the same tile sizes
    Je, Te = J.emptyLike(), T.emptyLike()
    assert (Te.rb, Te.mb, Te.nb, tuple(Te.data.shape)) == \
        (Je.rb, Je.mb, Je.nb, tuple(Je.data.shape))


@pytest.mark.parametrize("sizes", SIZES)
def test_structured_to_dense_matches_jax(rng, sizes):
    a = rng.standard_normal((24, 24))
    for kw in ({"mtype": st.MatrixType.Hermitian, "uplo": st.Uplo.Lower},
               {"mtype": st.MatrixType.Triangular, "uplo": st.Uplo.Upper,
                "diag": st.Diag.Unit},
               {"mtype": st.MatrixType.GeneralBand, "kl": 3, "ku": 5}):
        J, T = _both(a, sizes, **kw)
        assert np.array_equal(T.to_numpy(), J.to_numpy())
        assert np.array_equal(T.transpose().to_numpy(),
                              J.transpose().to_numpy())


@pytest.mark.parametrize("sizes", SIZES)
def test_gemm_and_factors_on_non_uniform_match_jax(rng, sizes):
    """gemm takes non-uniform operands directly; potrf, getrf and gesv
    re-tile at entry (reference test_tiles.py:224)."""
    n = 24
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    JA, TA = _both(a, sizes)
    JB, TB = _both(b, sizes)
    JC, TC = _both(np.zeros((n, n)), sizes)
    Cj, Ct = jst.gemm(1.0, JA, JB, 0.0, JC), st.gemm(1.0, TA, TB, 0.0, TC)
    assert (Ct.rb, Ct.cb) == (Cj.rb, Cj.cb)
    np.testing.assert_allclose(Ct.to_numpy(), Cj.to_numpy(), atol=TOL)
    np.testing.assert_allclose(Ct.to_numpy(), a @ b, atol=TOL)

    spd = a @ a.T / n + 4 * np.eye(n)
    JH, TH = _both(spd, sizes, mtype=st.MatrixType.Hermitian,
                   uplo=st.Uplo.Lower)
    Lj, Lt = jst.potrf(JH), st.potrf(TH)
    np.testing.assert_allclose(np.tril(Lt.to_numpy()),
                               np.tril(Lj.to_numpy()), atol=TOL)

    Fj, Ft = jst.getrf(JA), st.getrf(TA)
    assert np.array_equal(_np(Ft.pivots)[:n], np.asarray(Fj.pivots)[:n])
    np.testing.assert_allclose(Ft.LU.to_numpy(), Fj.LU.to_numpy(),
                               atol=TOL)
    # the factor is the one of the uniform re-tiling
    Fu = st.getrf(TA.uniform())
    assert torch.equal(Ft.pivots, Fu.pivots)
    assert torch.equal(Ft.LU.data, Fu.LU.data)

    rhs = rng.standard_normal((n, 3))
    JX, TX = _both(rhs, sizes, [3])
    (_, Xj), (_, Xt) = jst.gesv(JA, JX), st.gesv(TA, TX)
    np.testing.assert_allclose(Xt.to_numpy(), Xj.to_numpy(), atol=TOL)
    np.testing.assert_allclose(a @ Xt.to_numpy(), rhs, atol=1e-10)


def _dense(x):
    """Every array a driver's result holds, in order."""
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [d for y in x for d in _dense(y)]
    if hasattr(x, "to_numpy"):
        return [x.to_numpy()]
    if dataclasses.is_dataclass(x):
        return [d for f in dataclasses.fields(x)
                for d in _dense(getattr(x, f.name))]
    if isinstance(x, (bool, int, float, str)):
        return [np.asarray(x)]
    return [_np(x)]


def _driver_cases(pkg):
    """Each case takes the package's _Inputs and returns the driver's
    result. The lapack_compat functions take numpy arrays: given a
    non-uniform matrix, both packages raise."""
    from importlib import import_module
    lc = import_module(pkg.__name__ + ".api.lapack_compat")
    S, Norm = pkg.Side, pkg.Norm
    H = {"mtype": pkg.MatrixType.Hermitian, "uplo": pkg.Uplo.Lower}
    L = {"mtype": pkg.MatrixType.Triangular, "uplo": pkg.Uplo.Lower}
    return {
        "trsm": lambda m: pkg.trsm(S.Left, 1.0, m.nu(m.tri, **L), m.B),
        "trsm_right": lambda m: pkg.trsm(
            S.Right, 2.0, m.nu(m.tri, **L), m.nu(m.b.T, [3], m.sizes)),
        "trmm": lambda m: pkg.trmm(S.Left, 1.0, m.nu(m.tri, **L),
                                   m.nu(m.a)),
        "herk": lambda m: pkg.herk(1.0, m.nu(m.a), 0.0,
                                   m.nu(np.zeros_like(m.a), **H)),
        "hemm": lambda m: pkg.hemm(S.Left, 1.0, m.nu(m.spd, **H),
                                   m.nu(m.a), 0.0,
                                   m.nu(np.zeros_like(m.a))),
        "posv": lambda m: pkg.posv(m.nu(m.spd, **H), m.B),
        "potrs": lambda m: pkg.potrs(pkg.potrf(m.nu(m.spd, **H)), m.B),
        # the mixed solves' X only: their low-precision factors part
        # in the last bits, and the butterflies are random
        "posv_mixed": lambda m: pkg.posv_mixed(m.nu(m.spd, **H), m.B)[1],
        "trtri": lambda m: pkg.trtri(m.nu(m.tri, **L)),
        "getrs": lambda m: pkg.getrs(pkg.getrf(m.nu(m.a)), m.B),
        "gesv_nopiv": lambda m: pkg.gesv_nopiv(m.nu(m.dd), m.B),
        "gesv_mixed": lambda m: pkg.gesv_mixed(m.nu(m.a), m.B)[1],
        "gesv_rbt": lambda m: pkg.gesv_rbt(m.nu(m.a), m.B)[1],
        "getri": lambda m: pkg.getri(pkg.getrf(m.nu(m.a))),
        "gecondest": lambda m: pkg.gecondest(Norm.One,
                                             pkg.getrf(m.nu(m.a)), 1.0),
        "getrf_tntpiv": lambda m: pkg.getrf_tntpiv(m.nu(m.a)),
        "geqrf": lambda m: pkg.geqrf(m.nu(m.a)),
        "gelqf": lambda m: pkg.gelqf(m.nu(m.a)),
        "gels": lambda m: pkg.gels(m.nu(m.a), m.B),
        "gels_tall": lambda m: pkg.gels(m.nu(m.tall, m.sizes + [8],
                                             m.sizes),
                                        m.nu(m.btall, m.sizes + [8], [3])),
        "gels_cholqr": lambda m: pkg.gels_cholqr(
            m.nu(m.tall, m.sizes + [8], m.sizes),
            m.nu(m.btall, m.sizes + [8], [3])),
        "norm_fro": lambda m: pkg.norm(Norm.Fro, m.nu(m.a)),
        "norm_one_herm": lambda m: pkg.norm(Norm.One, m.nu(m.herm, **H)),
        "colNorms": lambda m: pkg.colNorms(Norm.Max, m.nu(m.a)),
        "add": lambda m: pkg.add(1.0, m.nu(m.a), 2.0, m.nu(m.herm)),
        "copy": lambda m: pkg.copy(m.nu(m.a), m.nu(np.zeros_like(m.a))),
        "hesv": lambda m: pkg.hesv(m.nu(m.herm, **H), m.B),
        "heev": lambda m: pkg.heev(m.nu(m.herm, **H))[0],
        "svd_vals": lambda m: pkg.svd_vals(m.nu(m.a)),
        "gbsv": lambda m: pkg.gbsv(
            m.nu(m.band, kl=3, ku=3, mtype=pkg.MatrixType.GeneralBand),
            m.B)[1],
        "pbsv": lambda m: pkg.pbsv(
            m.nu(m.spdband, kl=3, ku=3,
                 mtype=pkg.MatrixType.HermitianBand, uplo=pkg.Uplo.Lower),
            m.B)[1],
        "gbmm": lambda m: pkg.gbmm(
            1.0, m.nu(m.band, kl=3, ku=3, mtype=pkg.MatrixType.GeneralBand),
            m.nu(m.a), 0.0, m.nu(np.zeros_like(m.a))),
        "lapack_compat.solve": lambda m: lc.solve(
            m.nu(m.a), m.b),
        "lapack_compat.cho_solve": lambda m: lc.solve(
            m.nu(m.spd, **H), m.b, assume_a="pos"),
        "lapack_compat.lu_factor": lambda m: lc.lu_factor(
            m.nu(m.a)),
    }


class _Inputs:
    """The seeded operands of one size list, wrapped by one package."""

    def __init__(self, pkg, sizes, seed=7):
        rng = np.random.default_rng(seed)
        n = sum(sizes)
        self.sizes = list(sizes)
        self.a = rng.standard_normal((n, n))
        self.b = rng.standard_normal((n, 3))
        self.spd = self.a @ self.a.T / n + 4 * np.eye(n)
        self.herm = (self.a + self.a.T) / 2
        self.tri = np.tril(self.a) + n * np.eye(n)
        self.dd = self.a + n * np.eye(n)
        self.tall = rng.standard_normal((n + 8, n))
        self.btall = rng.standard_normal((n + 8, 3))
        bnd = np.triu(np.tril(self.a, 3), -3)
        self.band = bnd + 4 * np.eye(n)
        self.spdband = (bnd + bnd.T) / 2 + 4 * np.sqrt(n) * np.eye(n)
        self.pkg = pkg
        self.B = self.nu(self.b, self.sizes, [3])

    def nu(self, x, rows=None, cols=None, **kw):
        rows = self.sizes if rows is None else rows
        cols = (rows if x.shape[0] == x.shape[1] else [x.shape[1]]) \
            if cols is None else cols
        if self.pkg is st:
            M = TTM.from_func(x, rows, cols, device="cpu")
        else:
            M = JTM.from_func(x, rows, cols)
            kw = {k: getattr(jst, type(v).__name__)[v.name]
                  if hasattr(v, "name") else v for k, v in kw.items()}
        return dataclasses.replace(M, **kw)


_CASES = sorted(_driver_cases(st))


@pytest.mark.parametrize("sizes", SIZES, ids=("ragged", "even"))
@pytest.mark.parametrize("case", _CASES)
def test_drivers_on_non_uniform_match_jax(case, sizes):
    """Where the JAX driver returns on non-uniform operands, the port
    returns the same within 1e-10 (f64); where it raises, the port
    raises the same class."""
    jm, tm = _Inputs(jst, sizes), _Inputs(st, sizes)
    jcase, tcase = _driver_cases(jst)[case], _driver_cases(st)[case]
    try:
        jr = jcase(jm)
    except Exception as e:          # the port must raise the same class
        _raises_as(e, tcase, tm)
        return
    tr = tcase(tm)
    jd, td = _dense(jr), _dense(tr)
    assert len(td) == len(jd)
    for x, y in zip(td, jd):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype.kind in "iub" or y.dtype.kind in "iub":
            n = min(x.size, y.size)
            assert np.array_equal(x.ravel()[:n], y.ravel()[:n])
            continue
        # padded storage of a factor may differ in shape only by padding
        sl = tuple(slice(0, min(p, q)) for p, q in zip(x.shape, y.shape))
        np.testing.assert_allclose(x[sl], y[sl], atol=TOL, rtol=TOL)


def test_from_jax_state_carries_non_uniform(rng):
    a = rng.standard_normal((20, 14))
    J = JTM.from_func(a, [4, 10, 6], jfunc.uniform_blocksize(14, 5))
    J = dataclasses.replace(J, mtype=jst.MatrixType.Trapezoid,
                            uplo=jst.Uplo.Lower)
    meta = {f: getattr(J, f) for f in ("m", "n", "mb", "nb", "mtype",
                                       "uplo", "op", "diag", "kl", "ku",
                                       "rb", "cb")}
    meta.update(mtype=J.mtype.name, uplo=J.uplo.name, op=J.op.name,
                diag=J.diag.name)
    T = st.from_jax_state({"data": np.asarray(J.data)}, meta, device="cpu")
    for f in dataclasses.fields(T):
        if f.name == "data":
            assert np.array_equal(_np(T.data), np.asarray(J.data))
        elif f.name in ("mtype", "uplo", "op", "diag"):
            assert getattr(T, f.name).name == getattr(J, f.name).name
        else:
            assert getattr(T, f.name) == getattr(J, f.name), f.name
    assert np.array_equal(T.to_numpy(), J.to_numpy())
    assert [T.tileNb(j) for j in range(T.nt)] == [5, 5, 4]

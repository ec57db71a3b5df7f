"""slate_tpu_torch's user surface against the JAX package on the CPU:
every ``api.lapack_compat`` function numpy against numpy (2-D and
stacked, the refusals, the ragged strategy route), the ``simplified``
names resolving to the port's drivers, ``sprint_matrix`` strings equal
to the reference's, ``core.func``'s maps, and ``matgen``: its
deterministic kinds equal to the reference's, its random kinds checked
on structure (SPD, Hermitian, singular values from sigma / cond) and
determinism by seed."""

import inspect

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.api import lapack_compat as jlc
from slate_tpu.api import simplified as jsimp
from slate_tpu.core import func as jfunc
from slate_tpu.matgen import generate as jgen
from slate_tpu.utils import printing as jprint

import slate_tpu_torch as st
from slate_tpu_torch.api import lapack_compat as lc
from slate_tpu_torch.api import simplified as tsimp
from slate_tpu_torch.core import func as tfunc
from slate_tpu_torch.matgen import generate as tgen
from slate_tpu_torch.tune import cache as tcache

CPU = dict(device="cpu")


def close(x, ref, tol):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape and x.dtype == ref.dtype
    assert np.linalg.norm(x - ref) <= tol * max(np.linalg.norm(ref), 1e-300)


# -- lapack_compat ----------------------------------------------------------

def test_cholesky_matches_reference(rng):
    n = 40
    x = rng.standard_normal((n, n))
    a = x @ x.T + n * np.eye(n)
    for lower in (True, False):
        close(lc.cholesky(a, lower=lower, **CPU),
              jlc.cholesky(a, lower=lower), 1e-12)
    close(lc.cholesky(a, lower=True, **CPU), sla.cholesky(a, lower=True),
          1e-12)
    with pytest.raises(np.linalg.LinAlgError):
        lc.cholesky(-a, lower=True, **CPU)


def test_lu_factor_solve_matches_reference(rng):
    n = 36
    a = rng.standard_normal((n, n)) + n * np.eye(n) * 0.1
    b = rng.standard_normal((n, 3))
    lu, piv = lc.lu_factor(a, **CPU)
    jlu, jpiv = jlc.lu_factor(a)
    close(lu, np.asarray(jlu), 1e-12)
    assert np.array_equal(piv, np.asarray(jpiv))
    assert np.array_equal(piv, sla.lu_factor(a)[1])
    for trans in (0, 1, 2):
        close(lc.lu_solve((lu, piv), b, trans=trans, **CPU),
              jlc.lu_solve((jlu, jpiv), b, trans=trans), 1e-12)
    close(lc.lu_solve((lu, piv), b[:, 0], **CPU),
          sla.lu_solve(sla.lu_factor(a), b[:, 0]), 1e-12)


@pytest.mark.parametrize("assume_a", ["gen", "pos", "sym", "her"])
def test_solve_matches_reference(rng, assume_a):
    """solve by assume_a: gesv, posv, and hesv (Aasen) for sym / her."""
    n = 32
    x = rng.standard_normal((n, n))
    a = {"gen": x + n * np.eye(n) * 0.1, "pos": x @ x.T + n * np.eye(n),
         "sym": (x + x.T) / 2, "her": (x + x.T) / 2}[assume_a]
    b = rng.standard_normal(n)
    for lower in (False, True):
        close(lc.solve(a, b, assume_a=assume_a, lower=lower, **CPU),
              jlc.solve(a, b, assume_a=assume_a, lower=lower), 1e-10)
    close(lc.solve(a, b, assume_a=assume_a, **CPU),
          sla.solve(a, b, assume_a="gen"), 1e-10)
    with pytest.raises(NotImplementedError):
        lc.solve(a, b, assume_a="banded", **CPU)


def test_solve_singular_and_not_pd_raise(rng):
    n = 16
    a = np.zeros((n, n))
    with pytest.raises(np.linalg.LinAlgError):
        lc.solve(a, np.ones(n), **CPU)
    with pytest.raises(np.linalg.LinAlgError):
        lc.solve(-np.eye(n), np.ones(n), assume_a="pos", **CPU)
    with pytest.raises(np.linalg.LinAlgError):
        lc.inv(a, **CPU)


def test_solve_triangular_matches_reference(rng):
    n = 28
    t = np.tril(rng.standard_normal((n, n))) + 4 * np.eye(n)
    b = rng.standard_normal((n, 2))
    for trans in (0, 1, 2):
        for unit in (False, True):
            for lower in (True, False):
                tt = t if lower else t.T.copy()
                close(lc.solve_triangular(tt, b, trans=trans, lower=lower,
                                          unit_diagonal=unit, **CPU),
                      jlc.solve_triangular(tt, b, trans=trans, lower=lower,
                                           unit_diagonal=unit), 1e-12)
    close(lc.solve_triangular(t, b[:, 0], lower=True, **CPU),
          sla.solve_triangular(t, b[:, 0], lower=True), 1e-12)


def test_lstsq_eigh_svdvals_inv_match_reference(rng):
    m, n = 60, 20
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x, resid, rank, s = lc.lstsq(a, b, **CPU)
    jx, jresid, _, _ = jlc.lstsq(a, b)
    close(x, np.asarray(jx), 1e-10)
    close(resid, np.asarray(jresid), 1e-10)
    assert rank is None and s is None
    close(x, np.linalg.lstsq(a, b, rcond=None)[0], 1e-10)
    xs = rng.standard_normal((24, 24))
    h = (xs + xs.T) / 2
    for lower in (True, False):
        close(lc.eigh(h, lower=lower, eigvals_only=True, **CPU),
              jlc.eigh(h, lower=lower, eigvals_only=True), 1e-12)
    w, v = lc.eigh(h, **CPU)
    jw, jv = jlc.eigh(h)
    close(w, np.asarray(jw), 1e-12)
    # eigenvectors up to sign (each column's largest entry positive)
    def fix(v):
        idx = np.abs(v).argmax(axis=0)
        return v * np.sign(v[idx, range(v.shape[1])])
    close(fix(v), fix(np.asarray(jv)), 1e-9)
    close(lc.svdvals(xs, **CPU), np.asarray(jlc.svdvals(xs)), 1e-12)
    ai = lc.inv(xs + 24 * np.eye(24), **CPU)
    close(ai, np.asarray(jlc.inv(xs + 24 * np.eye(24))), 1e-12)
    close(ai, np.linalg.inv(xs + 24 * np.eye(24)), 1e-12)


def test_batched_routes_match_reference(rng):
    """Stacked inputs route through the batch layer on both sides."""
    B, n = 4, 20
    xs = rng.standard_normal((B, n, n))
    spd = np.einsum("bij,bkj->bik", xs, xs) + n * np.eye(n)
    gen = xs + n * np.eye(n) * 0.1
    for lower in (True, False):
        close(lc.cholesky(spd, lower=lower, **CPU),
              np.asarray(jlc.cholesky(spd, lower=lower)), 1e-10)
    with pytest.raises(np.linalg.LinAlgError):
        lc.cholesky(-spd, lower=True, **CPU)
    b1 = rng.standard_normal((B, n))
    close(lc.solve(gen, b1, **CPU), np.asarray(jlc.solve(gen, b1)), 1e-10)
    b2 = rng.standard_normal((B, n, 2))
    close(lc.solve(spd, b2, assume_a="pos", **CPU),
          np.asarray(jlc.solve(spd, b2, assume_a="pos")), 1e-10)
    # one element of the stack not positive definite: both raise
    mixed = spd.copy()
    mixed[2, n // 2, n // 2] = -1.0
    for bad in (-spd, mixed):
        for lower in (True, False):
            for f in (lc.solve, jlc.solve):
                kw = CPU if f is lc.solve else {}
                with pytest.raises(np.linalg.LinAlgError):
                    f(bad, b2, assume_a="pos", lower=lower, **kw)
            with pytest.raises(np.linalg.LinAlgError):
                lc.cholesky(bad, lower=lower, **CPU)
    lu, piv = lc.lu_factor(gen, **CPU)
    jlu, jpiv = jlc.lu_factor(gen)
    close(lu, np.asarray(jlu), 1e-10)
    assert np.array_equal(piv, np.asarray(jpiv))
    sym = (xs + np.swapaxes(xs, -1, -2)) / 2
    w, v = lc.eigh(sym, **CPU)
    close(w, np.asarray(jlc.eigh(sym, eigvals_only=True)), 1e-10)
    for i in range(B):
        close(sym[i] @ v[i], v[i] * w[i][None, :], 1e-9)
    close(lc.inv(gen, **CPU), np.asarray(jlc.inv(gen)), 1e-10)
    L4 = lc.cholesky(spd.reshape(2, 2, n, n), lower=True, **CPU)
    assert L4.shape == (2, 2, n, n)


def test_batched_triangle_selection_and_promotion(rng):
    """Only the `lower`-designated triangle is read; mixed a / rhs
    dtypes promote numpy-style."""
    B, n = 3, 16
    xs = rng.standard_normal((B, n, n))
    spd = np.einsum("bij,bkj->bik", xs, xs) + n * np.eye(n)
    junk = rng.standard_normal((B, n, n))
    upper_only = np.triu(spd) + np.tril(junk, -1)
    close(lc.cholesky(upper_only, **CPU)[0], sla.cholesky(upper_only[0]),
          1e-10)
    a = (rng.standard_normal((2, 12, 12)) + 12 * np.eye(12)).astype(
        np.float32)
    x = lc.solve(a, rng.standard_normal((2, 12)), **CPU)
    assert x.dtype == np.float64


def test_batched_2d_only_routes_raise(rng):
    B, n = 2, 8
    xs = rng.standard_normal((B, n, n))
    b = rng.standard_normal((B, n))
    with pytest.raises(ValueError, match="gels_batched"):
        lc.lstsq(xs, b, **CPU)
    with pytest.raises(ValueError, match="solve_triangular"):
        lc.solve_triangular(xs, b, **CPU)
    with pytest.raises(ValueError, match="batched"):
        lc.svdvals(xs, **CPU)
    with pytest.raises(ValueError, match="assume_a"):
        lc.solve(xs, b, assume_a="sym", **CPU)
    with pytest.raises(ValueError, match="batched"):
        lc.lu_solve((xs, np.zeros((B, n), np.int32)), b, **CPU)


def test_batched_routes_under_ragged_strategy(tmp_path, monkeypatch, rng):
    """An earned ``batch/strategy`` = "ragged" tune entry is invisible to
    the shim's signatures while its stacked cholesky / lu_factor / solve
    dispatch through the ragged route (its plain versions on the CPU),
    equal to scipy per element. The reference's ragged route fails on
    this tree (ROADMAP queue 3), so scipy is the reference here."""
    from slate_tpu_torch.batch import drivers
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    tcache.reset_cache()
    calls = []
    real = drivers.ragged_dispatch
    monkeypatch.setattr(drivers, "ragged_dispatch",
                        lambda op, *a, **k: calls.append(op)
                        or real(op, *a, **k))
    try:
        tcache.get_cache().put("batch", None, None, {"strategy": "ragged"})
        B, n = 4, 20
        xs = rng.standard_normal((B, n, n))
        spd = np.einsum("bij,bkj->bik", xs, xs) + n * np.eye(n)
        ls = lc.cholesky(spd, lower=True, **CPU)
        gen = rng.standard_normal((2, 2, n, n)) + 0.2 * n * np.eye(n)
        lus, pivs = lc.lu_factor(gen, **CPU)
        b = rng.standard_normal((2, 2, n))
        x = lc.solve(gen, b, **CPU)
        xp = lc.solve(spd, rng.standard_normal((B, n)), assume_a="pos",
                      lower=True, **CPU)
        assert xp.shape == (B, n)
        assert calls == ["potrf", "getrf", "gesv", "posv"]
        mixed = spd.copy()
        mixed[1, n // 2, n // 2] = -1.0
        with pytest.raises(np.linalg.LinAlgError):
            lc.cholesky(mixed, lower=True, **CPU)
        with pytest.raises(np.linalg.LinAlgError):
            lc.solve(mixed, rng.standard_normal((B, n)), assume_a="pos",
                     lower=True, **CPU)
        for i in range(B):
            close(ls[i], sla.cholesky(spd[i], lower=True), 1e-10)
        for i in range(2):
            for j in range(2):
                ref_lu, ref_piv = sla.lu_factor(gen[i, j])
                close(lus[i, j], ref_lu, 1e-10)
                assert np.array_equal(pivs[i, j], ref_piv)
                close(x[i, j], sla.solve(gen[i, j], b[i, j]), 1e-10)
    finally:
        tcache.reset_cache()


def test_signatures_follow_reference():
    """Every shim function keeps the reference's parameters, in order,
    and adds only `device` at the end."""
    for name in ("cholesky", "lu_factor", "lu_solve", "solve",
                 "solve_triangular", "lstsq", "eigh", "svdvals", "inv"):
        ref = list(inspect.signature(getattr(jlc, name)).parameters)
        got = list(inspect.signature(getattr(lc, name)).parameters)
        assert got == ref + ["device"], name


# -- simplified --------------------------------------------------------------

def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and callable(v)
            and not inspect.ismodule(v) and not isinstance(v, type)}


def test_simplified_names_resolve_to_the_port():
    """Each simplified name of the reference exists in the port and is
    the port's function of the same name in the module of the same
    path."""
    ref, got = _public(jsimp), _public(tsimp)
    assert sorted(ref) == sorted(got)
    for name, fn in ref.items():
        port = got[name]
        assert port.__name__ == fn.__name__, name
        assert port.__module__ == fn.__module__.replace(
            "slate_tpu.", "slate_tpu_torch.", 1), name
        assert port is getattr(__import__(port.__module__,
                                          fromlist=["_"]), port.__name__)
    assert tsimp.band_lu_solve is st.gbsv and tsimp.band_chol_solve is st.pbsv
    assert tsimp.indefinite_solve is st.hesv
    assert st.simplified is tsimp and st.lapack_compat is lc


def test_simplified_band_and_indefinite_solve(rng):
    """The band and indefinite names solve, through the port."""
    n, nb = 48, 8
    a = np.triu(np.tril(rng.standard_normal((n, n)), 2), -2) + 4 * np.eye(n)
    b = rng.standard_normal((n, 2))
    _, X = tsimp.band_lu_solve(st.BandMatrix(2, 2, a, mb=nb, **CPU),
                               st.Matrix(b, mb=nb, **CPU))
    close(a @ X.to_numpy(), b, 1e-12)
    h = (a + a.T) / 2
    _, X = tsimp.indefinite_solve(st.HermitianMatrix(st.Uplo.Lower, h,
                                                     mb=nb, **CPU),
                                  st.Matrix(b, mb=nb, **CPU))
    close(h @ X.to_numpy(), b, 1e-12)


# -- printing ----------------------------------------------------------------

def _print_cases(rng):
    a = rng.standard_normal((13, 11))
    c = (rng.standard_normal((9, 9)) + 1j * rng.standard_normal((9, 9)))
    s = rng.standard_normal((6, 6))
    return [
        (lambda m: m.Matrix(a, mb=4), a),
        (lambda m: m.Matrix(a.astype(np.float32), mb=5), None),
        (lambda m: m.Matrix(c, mb=4), None),
        (lambda m: m.Matrix(a, mb=4).T, None),
        (lambda m: m.TriangularMatrix(m.Uplo.Lower, s, mb=4,
                                      diag=m.Diag.Unit), None),
        (lambda m: m.Matrix(s, mb=4), None),
        (lambda m: m.BandMatrix(2, 1, a, mb=4), None),
    ]


def _make(case, m):
    if m is st:
        import functools
        import types
        ns = types.SimpleNamespace(**{k: getattr(st, k) for k in dir(st)})
        for k in ("Matrix", "TriangularMatrix", "BandMatrix"):
            setattr(ns, k, functools.partial(getattr(st, k), **CPU))
        return case(ns)
    return case(m)


@pytest.mark.parametrize("verbose", [None, 0, 1, 2, 3, 4])
def test_sprint_matrix_matches_reference(rng, verbose):
    for case, _ in _print_cases(rng):
        T, J = _make(case, st), _make(case, jst)
        for kw in ({}, {"edgeitems": 2, "width": 8, "precision": 2}):
            assert st.sprint_matrix("A", T, verbose=verbose, **kw) == \
                jprint.sprint_matrix("A", J, verbose=verbose, **kw)


def test_sprint_matrix_options_and_print(rng, capsys):
    a = rng.standard_normal((12, 12))
    T, J = st.Matrix(a, mb=4, **CPU), jst.Matrix(a, mb=4)
    opts = {st.Option.PrintVerbose: 4, st.Option.PrintPrecision: 3,
            st.Option.PrintWidth: 9, st.Option.PrintEdgeItems: 3}
    jopts = {getattr(jst.Option, k.name): v for k, v in opts.items()}
    assert st.sprint_matrix("B", T, opts=opts) == \
        jprint.sprint_matrix("B", J, opts=jopts)
    st.print_matrix("B", T, verbose=1)
    jst.print_matrix("B", J, verbose=1)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[:2] == out[2:]
    st.print_matrix("B", T, verbose=0)
    assert capsys.readouterr().out == ""


# -- func --------------------------------------------------------------------

def test_func_maps_match_reference():
    for n, nb in ((10, 3), (12, 4), (1, 5)):
        tf, jf = tfunc.uniform_blocksize(n, nb), jfunc.uniform_blocksize(n, nb)
        assert [tf(i) for i in range(-(-n // nb))] == \
            [jf(i) for i in range(-(-n // nb))]
    tiles = [(i, j) for i in range(7) for j in range(5)]
    for order in ("Col", "Row"):
        to, jo = getattr(st.GridOrder, order), getattr(jst.GridOrder, order)
        for p, q in ((2, 3), (3, 1), (1, 1)):
            for tmake, jmake in ((tfunc.process_2d_grid,
                                  jfunc.process_2d_grid),
                                 (tfunc.device_2d_grid,
                                  jfunc.device_2d_grid)):
                tf, jf = tmake(to, p, q), jmake(jo, p, q)
                assert [tf(t) for t in tiles] == [jf(t) for t in tiles]
                assert tfunc.is_2d_cyclic_grid(7, 5, tf)[0]
                assert [tfunc.transpose_grid(tf)(t) for t in tiles] == \
                    [jfunc.transpose_grid(jf)(t) for t in tiles]
                got = tfunc.is_2d_cyclic_grid(7, 5, tf)
                ref = jfunc.is_2d_cyclic_grid(7, 5, jf)
                assert (got[0], got[1].name, got[2:]) == \
                    (ref[0], ref[1].name, ref[2:])
            for tmake, jmake in ((tfunc.process_1d_grid,
                                  jfunc.process_1d_grid),
                                 (tfunc.device_1d_grid,
                                  jfunc.device_1d_grid)):
                tf, jf = tmake(to, p + q), jmake(jo, p + q)
                assert [tf(t) for t in tiles] == [jf(t) for t in tiles]
    assert not tfunc.is_2d_cyclic_grid(4, 4, lambda ij: (ij[0] * ij[1]) % 3)[0]
    assert tfunc.is_2d_cyclic_grid(0, 3, lambda ij: 0)[0]


# -- matgen ------------------------------------------------------------------

DETERMINISTIC = ("zeros ones identity ij jordan jordanT circul fiedler gfpp "
                 "kms riemann ris zielkeNS minij hilb lehmer parter").split()
#: kinds computed through a transcendental function (cos, sin), whose
#: library implementations differ in the last bit
TRANSCENDENTAL = ("chebspec", "orthog")


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_matgen_deterministic_kinds_match_reference(dtype):
    for kind in DETERMINISTIC + list(TRANSCENDENTAL):
        for m, n in ((12, 12), (10, 7), (7, 10)):
            T = tgen.generate_matrix(kind, m, n, mb=8, dtype=dtype, **CPU)
            J = jgen.generate_matrix(kind, m, n, mb=8, dtype=dtype)
            t, j = T.to_numpy(), np.asarray(J.to_dense())
            assert t.dtype == j.dtype and (T.m, T.n, T.mb) == (J.m, J.n, J.mb)
            if kind in TRANSCENDENTAL:
                np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7,
                                           err_msg=kind)
            elif kind == "lehmer" and dtype == "complex128":
                # a complex divide: the libraries round it differently
                np.testing.assert_allclose(t, j, rtol=1e-15, err_msg=kind)
            else:
                assert np.array_equal(t, j, equal_nan=True), kind


def test_matgen_sigma_matches_reference():
    """The deterministic singular-value distributions equal the
    reference's (geo through pow: f32 rounding)."""
    for dist in ("arith", "geo", "cluster0", "cluster1", "rarith", "rgeo",
                 "rcluster0", "rcluster1"):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.float64, jnp.float64)):
            t = tgen._sigma(dist, 9, 1e3, dt, 0, torch.device("cpu"))
            j = jgen._sigma(dist, 9, 1e3, jdt, None)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       err_msg=dist)
    with pytest.raises(ValueError):
        tgen._sigma("specified", 4, 10.0, torch.float32, 0, "cpu")


def test_matgen_random_kinds_structure():
    """The spectral kinds have the spectrum they are built from; the
    random kinds their ranges; every kind and dist materialises."""
    A = tgen.generate_matrix("svd:geo", 40, 40, mb=16, cond=1e3,
                             dtype=np.float64, **CPU)
    s = np.linalg.svd(A.to_numpy(), compute_uv=False)
    assert np.isclose(s[0] / s[-1], 1e3, rtol=1e-6) and np.isclose(s[0], 1)
    sig = np.linspace(3.0, 0.5, 24)
    A = tgen.generate_matrix("svd", 30, 24, sigma=sig, dtype=np.float64,
                             **CPU)
    np.testing.assert_allclose(np.linalg.svd(A.to_numpy(),
                                             compute_uv=False), sig,
                               rtol=1e-12)
    P = tgen.generate_matrix("poev", 24, 24, mb=8, dtype=np.float64, **CPU)
    p = P.to_numpy()
    np.testing.assert_allclose(p, p.T, atol=1e-12)
    assert np.linalg.eigvalsh(p).min() > 0
    H = tgen.generate_matrix("heev:arith", 24, 24, mb=8, cond=10.0,
                             dtype=np.complex128, **CPU).to_numpy()
    np.testing.assert_allclose(H, H.conj().T, atol=1e-12)
    # a complex type's distribution is computed in f32, as the
    # reference's (_sigma takes f64 only for float64)
    w = np.sort(np.abs(np.linalg.eigvalsh(H)))
    np.testing.assert_allclose(w, np.sort(np.linspace(1, 0.1, 24)),
                               rtol=1e-6)
    G = tgen.generate_matrix("geev:cluster0", 16, 16, cond=4.0,
                             dtype=np.float64, **CPU).to_numpy()
    ev = np.sort(np.abs(np.linalg.eigvals(G)))
    np.testing.assert_allclose(ev, [0.25] * 15 + [1.0], rtol=1e-9)
    D = tgen.generate_matrix("diag", 6, 8, sigma=[4, 3, 2, 1, 1, 1],
                             **CPU).to_numpy()
    assert np.array_equal(D, np.eye(6, 8) * [4, 3, 2, 1, 1, 1, 0, 0][:8])
    r = tgen.generate_matrix("rand", 50, 50, **CPU).to_numpy()
    assert r.min() >= 0 and r.max() < 1
    r = tgen.generate_matrix("rands", 50, 50, **CPU).to_numpy()
    assert r.min() >= -1 and r.max() < 1 and r.min() < 0
    assert set(np.unique(tgen.generate_matrix("randb", 20, 20, **CPU)
                         .to_numpy())) <= {0.0, 1.0}
    assert set(np.unique(tgen.generate_matrix("randr", 20, 20, **CPU)
                         .to_numpy())) <= {-1.0, 1.0}
    for kind in tgen.KINDS:
        for dt in (np.float64, np.complex128):
            assert np.isfinite(tgen.generate_matrix(
                kind, 12, 12, mb=8, dtype=dt, **CPU).to_numpy()).all(), kind
    for dist in tgen.DISTS[:-1]:
        assert np.isfinite(tgen.generate_matrix(
            "svd:" + dist, 10, 10, **CPU).to_numpy()).all(), dist
    assert tgen.KINDS == jgen.KINDS and tgen.DISTS == jgen.DISTS
    with pytest.raises(ValueError):
        tgen.generate_matrix("bogus", 8, 8, **CPU)
    with pytest.raises(ValueError):
        tgen.generate_matrix("svd:specified", 8, 8, **CPU)


def test_matgen_determinism_by_seed():
    """The same seed gives the same matrix whatever the tiling; another
    seed another one; complex kinds draw their imaginary parts apart."""
    for kind in ("randn", "rand", "svd", "heev", "poev"):
        a = tgen.generate_matrix(kind, 32, 32, mb=16, seed=7, **CPU)
        b = tgen.generate_matrix(kind, 32, 32, mb=8, seed=7, **CPU)
        c = tgen.generate_matrix(kind, 32, 32, mb=16, seed=8, **CPU)
        assert np.array_equal(a.to_numpy(), b.to_numpy()), kind
        assert not np.array_equal(a.to_numpy(), c.to_numpy()), kind
    z = tgen.generate_matrix("randn", 16, 16, dtype=np.complex128,
                             **CPU).to_numpy()
    assert not np.allclose(z.real, z.imag)
    assert st.generate_matrix is tgen.generate_matrix

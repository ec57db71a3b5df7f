"""slate_tpu_torch's band slice against the JAX package on the CPU: the
band constructors, pbtrf / pbtrs / pbsv, gbtrf / gbtrs / gbsv (pivots
equal to the reference's), getrs on band factors, the wide-band and
rectangular fallbacks, tbsm with band factors, gbmm / hbmm, hb2st's
driver path, the windowed helpers of ``linalg/band.py`` one by one, a
band factor carried over by from_jax_state, and the shared seeded
systems of ``testing.py``. The same seeded numpy inputs go through both
packages; f64 and complex128 agree to 1e-10, f32 to 1e-5 relative."""

import dataclasses

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.linalg import band as jband
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch import testing
from slate_tpu_torch.linalg import band as tband
from slate_tpu_torch.tune import cache as tcache

CPU = dict(device="cpu")


def spd_band(rng, n, kd):
    a = rng.standard_normal((n, n))
    band = np.triu(np.tril(a + a.T, kd), -kd)
    return band + 4 * n ** 0.5 * np.eye(n)


def gen_band(rng, n, kl, ku, shift=4.0):
    a = np.triu(np.tril(rng.standard_normal((n, n)), kl), -ku).T
    return a + shift * np.eye(n)


def close(x, ref, tol):
    """Normwise relative agreement of two arrays."""
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    assert np.linalg.norm(x - ref) <= tol * max(np.linalg.norm(ref), 1e-300)


def _meta(M):
    return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
            "mtype": M.mtype.name, "uplo": M.uplo.name, "op": M.op.name,
            "diag": M.diag.name, "kl": M.kl, "ku": M.ku}


def _tags(M):
    return (M.m, M.n, M.mb, M.nb, M.mtype.name, M.uplo.name, M.op.name,
            M.diag.name, M.kl, M.ku)


def test_band_constructors_match_jax(rng):
    """BandMatrix, TriangularBandMatrix and TrapezoidMatrix: the same
    tags and the same logical matrix (band and triangle masks)."""
    a = rng.standard_normal((20, 14))
    sq = rng.standard_normal((18, 18))
    pairs = [
        (st.BandMatrix(3, 2, a, mb=8, **CPU), jst.BandMatrix(3, 2, a, mb=8)),
        (st.TriangularBandMatrix(st.Uplo.Lower, 4, sq, mb=8, **CPU),
         jst.TriangularBandMatrix(jst.Uplo.Lower, 4, sq, mb=8)),
        (st.TriangularBandMatrix(st.Uplo.Upper, 2, sq, mb=8,
                                 diag=st.Diag.Unit, **CPU),
         jst.TriangularBandMatrix(jst.Uplo.Upper, 2, sq, mb=8,
                                  diag=jst.Diag.Unit)),
        (st.TrapezoidMatrix(st.Uplo.Lower, a, mb=8, **CPU),
         jst.TrapezoidMatrix(jst.Uplo.Lower, a, mb=8)),
        (st.BandMatrix(1, 1, m=10, n=12, mb=4, dtype=torch.float64, **CPU),
         jst.BandMatrix(1, 1, m=10, n=12, mb=4, dtype=jnp.float64)),
    ]
    for T, J in pairs:
        assert _tags(T) == _tags(J)
        assert np.array_equal(T.to_numpy(), np.asarray(J.to_dense()))
        assert np.array_equal(T.T.to_numpy(), np.asarray(J.T.to_dense()))
    with pytest.raises(st.DimensionError):
        st.TriangularBandMatrix(st.Uplo.Lower, 2, a, mb=8, **CPU)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_pbtrf_pbsv_match_jax(rng, uplo):
    """The windowed band Cholesky: factor and solve equal the
    reference's to 1e-10; the factor stays in its band and its tags
    (TriangularBand, A's uplo and bandwidths) match."""
    n, kd, nb = 96, 5, 8
    a = spd_band(rng, n, kd)
    b = rng.standard_normal((n, 3))
    A = st.HermitianBandMatrix(getattr(st.Uplo, uplo), kd, a, mb=nb, **CPU)
    JA = jst.HermitianBandMatrix(getattr(jst.Uplo, uplo), kd, a, mb=nb)
    L = st.pbtrf(A)
    JL = jst.pbtrf(JA)
    assert _tags(L) == _tags(JL)
    assert L.mtype is st.MatrixType.TriangularBand
    close(L.data.numpy(), np.asarray(JL.data), 1e-10)
    ld = L.to_numpy()
    close(ld @ ld.T if uplo == "Lower" else ld.T @ ld, a, 1e-12)
    assert np.allclose(np.tril(ld, -(kd + 1)), 0) \
        and np.allclose(np.triu(ld, kd + 1), 0)
    _, X = st.pbsv(A, st.Matrix(b, mb=nb, **CPU))
    _, JX = jst.pbsv(JA, jst.Matrix(b, mb=nb))
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    if uplo == "Lower":
        ab = np.zeros((kd + 1, n))
        for i in range(kd + 1):
            ab[i, :n - i] = np.diagonal(a, -i)
        close(X.to_numpy(), sla.solveh_banded(ab, b, lower=True), 1e-10)


@pytest.mark.parametrize("kind", ["wide_band", "hermitian"])
def test_pbsv_falls_back_dense(rng, kind):
    """kd ~ n / 2, or a Hermitian matrix with no band: the windowed path
    is off and the dense potrf / potrs serve, as the reference's (a
    TriangularBand factor with A's bandwidths for the band, a
    Triangular one for the Hermitian matrix); the factor's tags and X
    agree, through pbsv and through pbtrs on pbtrf's factor."""
    n, kd, nb = 32, 20, 8
    a = spd_band(rng, n, kd)
    b = rng.standard_normal((n, 2))
    if kind == "wide_band":
        A = st.HermitianBandMatrix(st.Uplo.Lower, kd, a, mb=nb, **CPU)
        JA = jst.HermitianBandMatrix(jst.Uplo.Lower, kd, a, mb=nb)
        mtype = st.MatrixType.TriangularBand
    else:
        A = st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, **CPU)
        JA = jst.HermitianMatrix(jst.Uplo.Lower, a, mb=nb)
        mtype = st.MatrixType.Triangular
    L, X = st.pbsv(A, st.Matrix(b, mb=nb, **CPU))
    JL, JX = jst.pbsv(JA, jst.Matrix(b, mb=nb))
    assert L.mtype is mtype and _tags(L) == _tags(JL)
    close(L.to_numpy(), np.asarray(JL.to_dense()), 1e-10)
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    Xs = st.pbtrs(st.pbtrf(A), st.Matrix(b, mb=nb, **CPU))
    close(Xs.to_numpy(), np.asarray(JX.to_dense()), 1e-10)


@pytest.mark.parametrize("dtype", ["float64", "complex128", "float32"])
def test_gbsv_matches_jax(rng, dtype):
    """The windowed band LU: pivots equal to the reference's, the packed
    factor and X to 1e-10 (f32: 1e-5), the factor's widened tags
    (ku -> kl + ku) and F.band."""
    n, kl, ku, nb = 80, 3, 2, 8
    a = gen_band(rng, n, kl, ku, shift=1.0)
    b = rng.standard_normal((n, 3))
    if dtype == "complex128":
        a = a + 1j * gen_band(rng, n, kl, ku, shift=0.0)
        b = b + 1j * rng.standard_normal((n, 3))
    a, b = a.astype(dtype), b.astype(dtype)
    tol = 1e-5 if dtype == "float32" else 1e-10
    F, X = st.gbsv(st.BandMatrix(kl, ku, a, mb=nb, **CPU),
                   st.Matrix(b, mb=nb, **CPU))
    JF, JX = jst.gbsv(jst.BandMatrix(kl, ku, a, mb=nb), jst.Matrix(b, mb=nb))
    assert F.band and JF.band
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    assert int((F.pivots[:n] != torch.arange(n)).sum()) > 0
    assert _tags(F.LU) == _tags(JF.LU)
    close(F.LU.data.numpy(), np.asarray(JF.LU.data), tol)
    close(X.to_numpy(), np.asarray(JX.to_dense()), tol)
    assert int(F.info) == int(JF.info) == 0
    if dtype == "float64":
        ab = np.zeros((kl + ku + 1, n))
        for i in range(-kl, ku + 1):
            if i >= 0:
                ab[ku - i, i:] = np.diagonal(a, i)
            else:
                ab[ku - i, :n + i] = np.diagonal(a, i)
        close(X.to_numpy(), sla.solve_banded((kl, ku), ab, b), 1e-10)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("trans", ["Trans", "ConjTrans"])
def test_gbtrs_trans_matches_jax(rng, dtype, trans):
    """gbtrs with op(A) = A^T / A^H: the band U^op solve, then the L^op
    sweep with each block's swaps undone."""
    n, kl, ku, nb = 64, 2, 3, 8
    a = gen_band(rng, n, kl, ku, shift=1.0)
    b = rng.standard_normal((n, 2))
    if dtype == "complex128":
        a = a + 1j * gen_band(rng, n, kl, ku, shift=0.0)
    F = st.gbtrf(st.BandMatrix(kl, ku, a, mb=nb, **CPU))
    JF = jst.gbtrf(jst.BandMatrix(kl, ku, a, mb=nb))
    X = st.gbtrs(F, st.Matrix(b.astype(a.dtype), mb=nb, **CPU),
                 trans=getattr(st.Op, trans))
    JX = jst.gbtrs(JF, jst.Matrix(b.astype(a.dtype), mb=nb),
                   trans=getattr(jst.Op, trans))
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    op = a.conj().T if trans == "ConjTrans" else a.T
    close(op @ X.to_numpy(), b, 1e-12)
    # the bool form: True is ConjTrans
    if trans == "ConjTrans":
        Xb = st.gbtrs(F, st.Matrix(b.astype(a.dtype), mb=nb, **CPU),
                      trans=True)
        assert np.array_equal(Xb.to_numpy(), X.to_numpy())


def test_getrs_routes_band_factors(rng):
    """getrs on band-convention factors takes gbtrs (the dense path
    would apply the block-local pivots wrongly)."""
    n, kl, ku, nb = 64, 2, 2, 8
    a = gen_band(rng, n, kl, ku, shift=1.0)
    b = rng.standard_normal((n, 1))
    F = st.gbtrf(st.BandMatrix(kl, ku, a, mb=nb, **CPU))
    X = st.getrs(F, st.Matrix(b, mb=nb, **CPU))
    JX = jst.getrs(jst.gbtrf(jst.BandMatrix(kl, ku, a, mb=nb)),
                   jst.Matrix(b, mb=nb))
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    close(a @ X.to_numpy(), b, 1e-12)


def test_gbtrf_rectangular_falls_back(rng):
    """The windowed gbtrf is square-only: a rectangular band input takes
    getrf, its factor tagged as the reference's."""
    m, n, kl, ku, nb = 80, 64, 2, 3, 8
    a = np.triu(np.tril(rng.standard_normal((m, n)), kl), -ku)
    a[:n] += 4 * np.eye(n)
    F = st.gbtrf(st.BandMatrix(kl, ku, a, mb=nb, **CPU))
    JF = jst.gbtrf(jst.BandMatrix(kl, ku, a, mb=nb))
    assert not F.band and not JF.band
    assert _tags(F.LU) == _tags(JF.LU)
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    close(F.LU.data.numpy(), np.asarray(JF.LU.data), 1e-10)


def test_wide_band_gbsv_falls_back_dense(rng):
    """A band too wide for the windows: getrf / getrs."""
    n, kl, ku, nb = 40, 12, 10, 8
    a = gen_band(rng, n, kl, ku)
    b = rng.standard_normal((n, 2))
    F, X = st.gbsv(st.BandMatrix(kl, ku, a, mb=nb, **CPU),
                   st.Matrix(b, mb=nb, **CPU))
    JF, JX = jst.gbsv(jst.BandMatrix(kl, ku, a, mb=nb), jst.Matrix(b, mb=nb))
    assert not F.band and _tags(F.LU) == _tags(JF.LU)
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)


def _unit_lower_upper(F):
    r = F.LU.resolve()
    L = dataclasses.replace(r, mtype=st.MatrixType.TriangularBand,
                            uplo=st.Uplo.Lower, diag=st.Diag.Unit)
    U = dataclasses.replace(r, mtype=st.MatrixType.TriangularBand,
                            uplo=st.Uplo.Upper, diag=st.Diag.NonUnit)
    return L, U


def test_tbsm_with_band_factors(rng):
    """tbsm given the band gbtrf's LUFactors replays the interleaved
    forward sweep; the upper factor then needs no pivots. Both steps
    equal the reference's."""
    n, kl, ku, nb = 64, 2, 3, 8
    a = gen_band(rng, n, kl, ku, shift=1.0)
    b = rng.standard_normal((n, 2))
    F = st.gbtrf(st.BandMatrix(kl, ku, a, mb=nb, **CPU))
    JF = jst.gbtrf(jst.BandMatrix(kl, ku, a, mb=nb))
    L, U = _unit_lower_upper(F)
    JL = dataclasses.replace(JF.LU.resolve(),
                             mtype=jst.MatrixType.TriangularBand,
                             uplo=jst.Uplo.Lower, diag=jst.Diag.Unit)
    JU = dataclasses.replace(JF.LU.resolve(),
                             mtype=jst.MatrixType.TriangularBand,
                             uplo=jst.Uplo.Upper, diag=jst.Diag.NonUnit)
    Y = st.tbsm(st.Side.Left, 1.0, L, st.Matrix(b, mb=nb, **CPU), pivots=F)
    JY = jst.tbsm(jst.Side.Left, 1.0, JL, jst.Matrix(b, mb=nb), pivots=JF)
    close(Y.to_numpy(), np.asarray(JY.to_dense()), 1e-10)
    X = st.tbsm(st.Side.Left, 1.0, U, Y)
    close(X.to_numpy(), np.asarray(jst.tbsm(jst.Side.Left, 1.0, JU,
                                            JY).to_dense()), 1e-10)
    close(a @ X.to_numpy(), b, 1e-12)


def test_tbsm_raw_pivots_and_lower_band(rng):
    """tbsm with a raw swap vector (applied up front) on a lower
    TriangularBand, alpha scaling it, and an upper band without
    pivots: equal to the reference's."""
    n, kd, nb = 48, 3, 8
    t = np.tril(np.triu(rng.standard_normal((n, n)), -kd)) + 4 * np.eye(n)
    b = rng.standard_normal((n, 2))
    piv = np.minimum(np.arange(n) + rng.integers(0, 3, n), n - 1).astype(
        np.int32)
    T = st.TriangularBandMatrix(st.Uplo.Lower, kd, t, mb=nb, **CPU)
    JT = jst.TriangularBandMatrix(jst.Uplo.Lower, kd, t, mb=nb)
    X = st.tbsm(st.Side.Left, 2.0, T, st.Matrix(b, mb=nb, **CPU),
                pivots=torch.as_tensor(piv))
    JX = jst.tbsm(jst.Side.Left, 2.0, JT, jst.Matrix(b, mb=nb),
                  pivots=jnp.asarray(piv))
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    TU = st.TriangularBandMatrix(st.Uplo.Upper, kd, t.T.copy(), mb=nb, **CPU)
    JTU = jst.TriangularBandMatrix(jst.Uplo.Upper, kd, t.T.copy(), mb=nb)
    close(st.tbsm(st.Side.Left, 1.0, TU, st.Matrix(b, mb=nb, **CPU)
                  ).to_numpy(),
          np.asarray(jst.tbsm(jst.Side.Left, 1.0, JTU,
                              jst.Matrix(b, mb=nb)).to_dense()), 1e-10)


def test_gbmm_matches_jax(rng):
    """The windowed band product (band_mm), also on a transposed view
    (kl / ku swap), and the wide-band gemm fallback."""
    n, nb, kl, ku = 192, 16, 10, 6
    ii, jj = np.indices((n, n))
    a = rng.standard_normal((n, n)) * ((ii - jj <= kl) & (jj - ii <= ku))
    b = rng.standard_normal((n, 5))
    c0 = rng.standard_normal((n, 5))
    A = st.BandMatrix(kl, ku, a, mb=nb, **CPU)
    JA = jst.BandMatrix(kl, ku, a, mb=nb)
    for view, jview in ((A, JA), (A.transpose(), JA.transpose())):
        C = st.gbmm(2.0, view, st.Matrix(b, mb=nb, **CPU), 0.5,
                    st.Matrix(c0, mb=nb, **CPU))
        JC = jst.gbmm(2.0, jview, jst.Matrix(b, mb=nb), 0.5,
                      jst.Matrix(c0, mb=nb))
        close(C.to_numpy(), np.asarray(JC.to_dense()), 1e-12)
    wide = st.BandMatrix(60, 60, a, mb=nb, **CPU)
    C = st.gbmm(1.0, wide, st.Matrix(b, mb=nb, **CPU), 0.0,
                st.Matrix(c0, mb=nb, **CPU))
    close(C.to_numpy(), a @ b, 1e-12)


@pytest.mark.parametrize("side", ["Left", "Right"])
def test_hbmm_matches_jax(rng, side):
    """Narrow complex Hermitian-band hbmm, both sides."""
    n, nb, kd = 160, 16, 8
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    ii, jj = np.indices((n, n))
    a[(ii - jj > kd) | (jj - ii > 0)] = 0       # lower band storage
    shape = (n, 4) if side == "Left" else (4, n)
    b = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    c0 = rng.standard_normal(shape) + 0j
    A = st.HermitianBandMatrix(st.Uplo.Lower, kd, a, mb=nb, **CPU)
    JA = jst.HermitianBandMatrix(jst.Uplo.Lower, kd, a, mb=nb)
    C = st.hbmm(getattr(st.Side, side), 1.5, A, st.Matrix(b, mb=nb, **CPU),
                0.5, st.Matrix(c0, mb=nb, **CPU))
    JC = jst.hbmm(getattr(jst.Side, side), 1.5, JA, jst.Matrix(b, mb=nb),
                  0.5, jst.Matrix(c0, mb=nb))
    close(C.to_numpy(), np.asarray(JC.to_dense()), 1e-12)
    full = A.to_numpy()
    ref = full @ b if side == "Left" else b @ full
    close(C.to_numpy(), 1.5 * ref + 0.5 * c0, 1e-12)


@pytest.mark.parametrize("kind", ["general", "Lower", "Upper"])
def test_band_products_read_only_the_band(rng, kind):
    """gbmm / hbmm read their windows from the storage: entries stored
    outside the band, or in a Hermitian band's other triangle (and the
    imaginary part of its diagonal), take no part, as in the
    reference's product of the masked dense matrix; the product equals
    the reference's and to_dense()'s, also on transposed views and a
    rectangular band."""
    nb = 16
    if kind == "general":
        m, k, kl, ku = 150, 200, 9, 21
        a = rng.standard_normal((m, k))
        b = rng.standard_normal((k, 3))
        c0 = rng.standard_normal((m, 3))
        A = st.BandMatrix(kl, ku, a, mb=nb, **CPU)
        JA = jst.BandMatrix(kl, ku, a, mb=nb)
        pairs = ((A, JA), (A.transpose(), JA.transpose()))
    else:
        n, kd = 144, 11
        a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        b = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
        c0 = rng.standard_normal((n, 3)) + 0j
        A = st.HermitianBandMatrix(getattr(st.Uplo, kind), kd, a, mb=nb,
                                   **CPU)
        JA = jst.HermitianBandMatrix(getattr(jst.Uplo, kind), kd, a, mb=nb)
        pairs = ((A, JA), (A.conj_transpose(), JA.conj_transpose()))
    for view, jview in pairs:
        bv = b if view.shape[1] == b.shape[0] else \
            rng.standard_normal((view.shape[1], 3))
        cv = c0 if view.shape[0] == c0.shape[0] else \
            rng.standard_normal((view.shape[0], 3))
        args = (st.Matrix(bv, mb=nb, **CPU), 0.5,
                st.Matrix(cv, mb=nb, **CPU))
        jargs = (jst.Matrix(bv, mb=nb), 0.5, jst.Matrix(cv, mb=nb))
        if kind == "general":
            C = st.gbmm(2.0, view, *args)
            JC = jst.gbmm(2.0, jview, *jargs)
        else:
            C = st.hbmm(st.Side.Left, 2.0, view, *args)
            JC = jst.hbmm(jst.Side.Left, 2.0, jview, *jargs)
        close(C.to_numpy(), np.asarray(JC.to_dense()), 1e-12)
        close(C.to_numpy(), 2.0 * view.to_numpy() @ bv + 0.5 * cv, 1e-12)


def test_hb2st_driver_band_path(rng):
    """A HermitianBandMatrix through hb2st (the windowed chase) and
    sterf: the tridiagonal and eigenvalues equal the reference's."""
    n, kd, nb = 48, 3, 8
    a = spd_band(rng, n, kd)
    tri = st.hb2st(st.HermitianBandMatrix(st.Uplo.Lower, kd, a, mb=nb,
                                          **CPU))
    jtri = jst.hb2st(jst.HermitianBandMatrix(jst.Uplo.Lower, kd, a, mb=nb))
    close(tri.d.numpy(), np.asarray(jtri.d), 1e-10)
    close(tri.e.numpy(), np.asarray(jtri.e), 1e-10)
    w = st.sterf(tri.d, tri.e)
    close(np.asarray(w), np.linalg.eigvalsh(a), 1e-10)


HELPER_DTYPES = {"float64": 1e-10, "complex128": 1e-10, "float32": 1e-5}


def _helper_inputs(dtype, n=72, k=5, nrhs=3, seed=7):
    rng = np.random.default_rng(seed)
    a = gen_band(rng, n, k, k, shift=1.5)
    b = rng.standard_normal((n, nrhs))
    if dtype == "complex128":
        a = a + 1j * gen_band(rng, n, k, k, shift=0.0)
        b = b + 1j * rng.standard_normal((n, nrhs))
    return a.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("dtype", sorted(HELPER_DTYPES))
def test_band_helpers_match_jax(dtype):
    """Each windowed helper of band.py against the reference's function
    on the same inputs: band_mm, pbtrf_band, gbtrf_band (pivots
    equal), gb_forward_solve, band_trsm_upper, band_trsm_lower (both
    sweeps, unit and non-unit) and gb_backward_solve_trans (transpose
    and conjugate)."""
    tol = HELPER_DTYPES[dtype]
    n, k, nb = 72, 5, 8
    a, b = _helper_inputs(dtype, n, k)
    T = torch.as_tensor
    close(tband.band_mm(T(a), k, k, T(b), nb).numpy(),
          jband.band_mm(jnp.asarray(a), k, k, jnp.asarray(b), nb), tol)
    close(tband.band_mm(T(a[:50]), k, k, T(b), nb).numpy(),
          jband.band_mm(jnp.asarray(a[:50]), k, k, jnp.asarray(b), nb), tol)
    spd = a @ a.conj().T
    spd = np.triu(np.tril(spd, 2 * k), -2 * k) + 4 * n * np.eye(n)
    close(tband.pbtrf_band(T(spd), n, nb, 2 * k).numpy(),
          jband.pbtrf_band(jnp.asarray(spd), n, nb, 2 * k), tol)
    lu, piv = tband.gbtrf_band(T(a), n, nb, k, k)
    jlu, jpiv = jband.gbtrf_band(jnp.asarray(a), n, nb, k, k)
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    close(lu.numpy(), jlu, tol)
    jlu_t = jnp.asarray(np.asarray(jlu))
    y = tband.gb_forward_solve(lu, piv, T(b), n, nb, k)
    close(y.numpy(), jband.gb_forward_solve(jlu_t, jpiv, jnp.asarray(b), n,
                                            nb, k), tol)
    close(tband.band_trsm_upper(lu, y, n, nb, 2 * k).numpy(),
          jband.band_trsm_upper(jlu_t, jnp.asarray(y.numpy()), n, nb, 2 * k),
          tol)
    low = np.tril(np.asarray(lu.numpy()))
    for unit in (False, True):
        for ct in (False, True):
            close(tband.band_trsm_lower(T(low), T(b), n, nb, k,
                                        unit_diagonal=unit,
                                        conj_trans=ct).numpy(),
                  jband.band_trsm_lower(jnp.asarray(low), jnp.asarray(b), n,
                                        nb, k, unit_diagonal=unit,
                                        conj_trans=ct), tol)
    for conj in (False, True):
        close(tband.gb_backward_solve_trans(lu, piv, T(b), n, nb, k,
                                            conj).numpy(),
              jband.gb_backward_solve_trans(jlu_t, jpiv, jnp.asarray(b), n,
                                            nb, k, conj), tol)


def test_band_helpers_small_and_edge_cases():
    """The crossover and the identity padding, as the reference's."""
    for n, nb, w in ((96, 8, 5), (32, 8, 20), (16, 8, 0), (40, 8, -1)):
        assert tband.band_is_narrow(n, nb, w) == jband.band_is_narrow(n, nb, w)
    a = np.arange(9.0).reshape(3, 3)
    assert np.array_equal(tband._pad_identity_to(torch.as_tensor(a),
                                                 5).numpy(),
                          np.asarray(jband._pad_identity_to(jnp.asarray(a),
                                                            5)))
    for kl, ku in ((3, 2), (-1, 4), (-1, -1)):
        A = st.BandMatrix(kl, ku, np.eye(8), mb=4, **CPU)
        JA = jst.BandMatrix(kl, ku, np.eye(8), mb=4)
        assert tband.band_width_of(A) == jband.band_width_of(JA)


def test_gbtrf_panels_through_the_recursive_route(tmp_path, monkeypatch):
    """With a measured ``pallas_rec`` entry the band LU's window panels
    ((nb + kl) x nb = 256 x 128 here, f32) go through lu_panel_rec (its
    plain versions on the CPU): the pivots equal the reference's cold
    route's, X within 1e-5."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    calls = []
    from slate_tpu_torch.ops import kernels as pk
    real = pk.lu_panel_rec
    monkeypatch.setattr(pk, "lu_panel_rec",
                        lambda a, *k, **kw: calls.append(a.shape)
                        or real(a, *k, **kw))
    try:
        for b in (256, 512):
            tcache.get_cache().put("lu_panel", torch.float32, b,
                                   {"method_lu_panel": "pallas_rec"})
        n, kl, ku, nb = 512, 128, 128, 128
        a, bb = testing.band_general_system(3, n, kl, ku, 2, "cpu",
                                            shift=24.0, group=64)
        a, bb = a.numpy(), bb.numpy()
        F, X = st.gbsv(st.BandMatrix(kl, ku, a, mb=nb, **CPU),
                       st.Matrix(bb, mb=nb, **CPU))
        JF, JX = jst.gbsv(jst.BandMatrix(kl, ku, a, mb=nb),
                          jst.Matrix(bb, mb=nb))
        assert calls == [(256, 128)] * 4
        assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
        close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-5)
    finally:
        tcache.reset_cache()
        jcache.reset_cache()


def test_band_lu_from_jax_state(rng):
    """gbtrf's band factors carried over (meta["band"]): gbtrs and
    getrs with them equal the reference's solve."""
    n, kl, ku, nb = 64, 3, 2, 8
    a = gen_band(rng, n, kl, ku, shift=1.0)
    b = rng.standard_normal((n, 2))
    JF = jst.gbtrf(jst.BandMatrix(kl, ku, a, mb=nb))
    F = st.from_jax_state({"LU": np.asarray(JF.LU.data),
                           "pivots": np.asarray(JF.pivots),
                           "info": np.asarray(JF.info)},
                          dict(_meta(JF.LU), band=True), **CPU)
    assert F.band and _tags(F.LU) == _tags(JF.LU)
    JX = np.asarray(jst.gbtrs(JF, jst.Matrix(b, mb=nb)).to_dense())
    close(st.gbtrs(F, st.Matrix(b, mb=nb, **CPU)).to_numpy(), JX, 1e-12)
    close(st.getrs(F, st.Matrix(b, mb=nb, **CPU)).to_numpy(), JX, 1e-12)


def test_band_systems_structure():
    """testing.py's band systems: the bandwidths they claim, SPD, the
    group permutation within its band, the same draw from one seed."""
    n, kd = 96, 6
    a, b = testing.band_spd_system(1, n, kd, 3, "cpu", torch.float64)
    a = a.numpy()
    assert b.shape == (n, 3) and np.allclose(a, a.T)
    assert np.allclose(np.tril(a, -(kd + 1)), 0)
    assert np.linalg.eigvalsh(a).min() > 0
    g, _ = testing.band_general_system(2, n, 5, 3, 1, "cpu")
    g = g.numpy()
    assert np.allclose(np.tril(g, -6), 0) and np.allclose(np.triu(g, 4), 0)
    p, _ = testing.band_general_system(2, n, 12, 12, 1, "cpu", group=8)
    p = p.numpy()
    assert np.allclose(np.tril(p, -13), 0) and np.allclose(np.triu(p, 13), 0)
    assert not np.allclose(np.tril(p, -6), 0)
    q, _ = testing.band_general_system(2, n, 12, 12, 1, "cpu", group=8)
    assert np.array_equal(p, q.numpy())
    # the pivots of the grouped system leave the diagonal
    _, piv = sla.lu_factor(p.astype(np.float64))
    assert (piv != np.arange(n)).sum() > n // 4

"""The port's small auxiliaries against the JAX package on the CPU:
norms (every Norm over General, Trapezoid, Triangular and Symmetric
matrices, per matrix, column and row) and colNorms to 1e-6 relative;
the elementwise aux drivers (set, add, copy, scale, scale_row_col,
set_entries, redistribute) bitwise on the padded storage; the masks;
and the three condition estimators, equal to the reference's to 1e-5
relative and within a factor of 3 of numpy's exact condition."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.tiles import TiledMatrix as JTiled
from slate_tpu.ops import masks as jmasks

import slate_tpu_torch as st
from slate_tpu_torch.core.tiles import TiledMatrix as TTiled
from slate_tpu_torch.ops import masks as tmasks

MB = 16
STRUCTS = {
    "General": (jst.MatrixType.General, jst.Uplo.General, (40, 30)),
    "Trapezoid": (jst.MatrixType.Trapezoid, jst.Uplo.Lower, (40, 30)),
    "Triangular": (jst.MatrixType.Triangular, jst.Uplo.Upper, (36, 36)),
    "Symmetric": (jst.MatrixType.Symmetric, jst.Uplo.Lower, (36, 36)),
}


def _pair(struct, seed=0, dtype=np.float32):
    """The same (m, n) matrix in both packages, with tiles of MB (the
    padding exercised: no dimension divides MB)."""
    mtype, uplo, (m, n) = STRUCTS[struct]
    a = np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)
    J = JTiled.from_dense(jnp.asarray(a), MB, mtype=mtype, uplo=uplo)
    T = TTiled.from_dense(a, MB, mtype=getattr(st.MatrixType, mtype.name),
                          uplo=getattr(st.Uplo, uplo.name), device="cpu")
    return J, T


def _np(x):
    return np.asarray(x.data if hasattr(x, "data") else x)


@pytest.mark.parametrize("struct", sorted(STRUCTS))
@pytest.mark.parametrize("norm", ["One", "Inf", "Fro", "Max"])
@pytest.mark.parametrize("scope", ["Matrix", "Columns", "Rows"])
def test_norm_matches_jax(struct, norm, scope):
    J, T = _pair(struct)
    ref = np.asarray(jst.norm(getattr(jst.Norm, norm), J,
                              scope=getattr(jst.NormScope, scope)))
    out = st.norm(getattr(st.Norm, norm), T,
                  scope=getattr(st.NormScope, scope))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("struct", sorted(STRUCTS))
def test_colnorms_matches_jax(struct):
    J, T = _pair(struct, seed=1)
    ref = np.asarray(jst.colNorms(jst.Norm.Max, J))
    np.testing.assert_allclose(st.colNorms(st.Norm.Max, T).numpy(), ref,
                               rtol=1e-6, atol=0)


def test_norm_of_complex_matches_jax():
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((20, 12)) + 1j * rng.standard_normal((20, 12))
         ).astype(np.complex64)
    J = JTiled.from_dense(jnp.asarray(a), 8)
    T = TTiled.from_dense(a, 8, device="cpu")
    for norm in ("One", "Inf", "Fro", "Max"):
        ref = np.asarray(jst.norm(getattr(jst.Norm, norm), J))
        out = st.norm(getattr(st.Norm, norm), T)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("struct", sorted(STRUCTS))
def test_set_add_copy_scale_bitwise(struct):
    J, T = _pair(struct, seed=3)
    J2, T2 = _pair(struct, seed=4)
    cases = [
        (jst.set(0.5, -2.0, J), st.set(0.5, -2.0, T)),
        (jst.add(1.5, J2, -0.25, J), st.add(1.5, T2, -0.25, T)),
        (jst.copy(J2, J), st.copy(T2, T)),
        (jst.scale(3.0, 7.0, J), st.scale(3.0, 7.0, T)),
    ]
    m, n = STRUCTS[struct][2]
    R = np.linspace(0.5, 2.0, m).astype(np.float32)
    C = np.linspace(-1.0, 1.0, n).astype(np.float32)
    cases.append((jst.scale_row_col(R, C, J),
                  st.scale_row_col(R, C, T)))
    for ref, out in cases:
        assert out.data.shape == ref.data.shape
        assert out.mtype.name == ref.mtype.name
        assert np.array_equal(out.data.numpy(), _np(ref)), struct


def test_copy_converts_type_bitwise():
    J, T = _pair("General", seed=5)
    Jd = JTiled.from_dense(jnp.zeros((40, 30), jnp.float64), MB)
    Td = TTiled.from_dense(np.zeros((40, 30)), MB, device="cpu")
    out = st.copy(T, Td)
    assert out.dtype == torch.float64
    assert np.array_equal(out.data.numpy(), _np(jst.copy(J, Jd)))


def test_set_entries_bitwise():
    J, T = _pair("General", seed=6)
    ref = jst.set_entries(lambda i, j: i * 100 + j * 0.5, J)
    out = st.set_entries(lambda i, j: i * 100 + j * 0.5, T)
    assert np.array_equal(out.data.numpy(), _np(ref))


def test_redistribute_retiles_and_rejects_a_grid():
    J, T = _pair("General", seed=7)
    Jb = JTiled.from_dense(jnp.zeros((40, 30), jnp.float32), 8, 12)
    Tb = TTiled.from_dense(np.zeros((40, 30), np.float32), 8, 12,
                           device="cpu")
    ref = jst.redistribute(J, Jb)
    out = st.redistribute(T, Tb)
    assert (out.mb, out.nb) == (ref.mb, ref.nb) == (8, 12)
    assert np.array_equal(out.data.numpy(), _np(ref))
    with pytest.raises(TypeError, match="ProcessGrid"):
        st.redistribute(T, Tb, {st.Option.Grid: object()})
    grid = {st.Option.Grid: st.single_device_grid("cpu")}
    assert np.array_equal(st.redistribute(T, Tb, grid).data.numpy(),
                          _np(ref))


@pytest.mark.parametrize("shape,m,n", [((8, 12), 5, 9), ((6, 6), 6, 6)])
def test_masks_match_jax(shape, m, n):
    for lower in (True, False):
        for strict in (True, False):
            assert np.array_equal(
                tmasks.tri_mask(shape, lower, strict, device="cpu").numpy(),
                np.asarray(jmasks.tri_mask(shape, lower, strict)))
    assert np.array_equal(tmasks.bounds_mask(shape, m, n,
                                             device="cpu").numpy(),
                          np.asarray(jmasks.bounds_mask(shape, m, n)))
    assert np.array_equal(tmasks.band_mask(shape, 2, 1,
                                           device="cpu").numpy(),
                          np.asarray(jmasks.band_mask(shape, 2, 1)))


# -- condition estimators -------------------------------------------------

N_COND = 96


@pytest.fixture(scope="module")
def cond_system():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((N_COND, N_COND)).astype(np.float32) \
        + 4.0 * np.eye(N_COND, dtype=np.float32)
    g = rng.standard_normal((N_COND, N_COND))
    s = (g @ g.T / N_COND + 0.05 * np.eye(N_COND)).astype(np.float32)
    return a, s


def _exact_rcond(a, norm):
    ordv = 1 if norm == "One" else np.inf
    a = a.astype(np.float64)
    return 1.0 / (np.linalg.norm(a, ordv) * np.linalg.norm(np.linalg.inv(a),
                                                           ordv))


@pytest.mark.parametrize("norm", ["One", "Inf"])
def test_gecondest_matches_jax(cond_system, norm):
    a, _ = cond_system
    anorm = float(np.linalg.norm(a.astype(np.float64),
                                 1 if norm == "One" else np.inf))
    Fj = jst.getrf(jst.Matrix(a, mb=32))
    Ft = st.getrf(st.Matrix(a, mb=32, device="cpu"))
    ref = float(jst.gecondest(getattr(jst.Norm, norm), Fj, anorm))
    out = float(st.gecondest(getattr(st.Norm, norm), Ft, anorm))
    assert abs(out - ref) <= 1e-5 * ref
    exact = _exact_rcond(a, norm)
    assert exact / 3 <= out <= exact * 3


@pytest.mark.parametrize("norm", ["One", "Inf"])
def test_pocondest_matches_jax(cond_system, norm):
    _, s = cond_system
    anorm = float(np.linalg.norm(s.astype(np.float64),
                                 1 if norm == "One" else np.inf))
    Lj = jst.potrf(jst.HermitianMatrix(jst.Uplo.Lower, s, mb=32))
    Lt = st.potrf(st.HermitianMatrix(st.Uplo.Lower, s, mb=32,
                                     device="cpu"))
    ref = float(jst.pocondest(getattr(jst.Norm, norm), Lj, anorm))
    out = float(st.pocondest(getattr(st.Norm, norm), Lt, anorm))
    assert abs(out - ref) <= 1e-5 * ref
    exact = _exact_rcond(s, norm)
    assert exact / 3 <= out <= exact * 3


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("norm", ["One", "Inf"])
def test_trcondest_matches_jax(cond_system, uplo, norm):
    a, _ = cond_system
    t = np.tril(a) if uplo == "Lower" else np.triu(a)
    Tj = jst.TriangularMatrix(getattr(jst.Uplo, uplo), t, mb=32)
    Tt = st.TriangularMatrix(getattr(st.Uplo, uplo), t, mb=32,
                             device="cpu")
    ref = float(jst.trcondest(getattr(jst.Norm, norm), Tj))
    out = float(st.trcondest(getattr(st.Norm, norm), Tt))
    assert abs(out - ref) <= 1e-5 * ref
    exact = _exact_rcond(t, norm)
    assert exact / 3 <= out <= exact * 3

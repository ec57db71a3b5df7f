"""slate_tpu_torch's Cholesky family (potrf / potrs / posv, trtri /
trtrm / potri, return_info, posv_mixed / posv_mixed_gmres) and the
BLAS-3 drivers it brings, against the JAX package on the CPU.

The same seeded numpy inputs (``testing.spd_system``: cond <= 5) go
through both packages, on the Fused route (one library Cholesky: LAPACK
on both sides) and the Tiled one (the blocked loops with library
diagonal blocks and panel solves), so factors agree to f32 rounding of
differently ordered sums."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.enums import Side as JSide
from slate_tpu.core.methods import MethodFactor as JMethodFactor
from slate_tpu.linalg import blas3 as jblas3
from slate_tpu.linalg import blocked as jblocked
from slate_tpu.linalg import chol as jchol
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.linalg import blocked as tblocked
from slate_tpu_torch.testing import spd_system
from slate_tpu_torch.tune import cache as tcache

N, NB, NRHS = 384, 128, 4
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def tune_env(tmp_path, monkeypatch):
    """Isolated tune caches for both packages."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    yield
    tcache.reset_cache()
    jcache.reset_cache()


@pytest.fixture(scope="module")
def system():
    return spd_system(np.random.default_rng(2), N, NRHS)


def _opts(method, lookahead=None):
    o, jo = {}, {}
    if method is not None:
        o[st.Option.MethodFactor] = st.MethodFactor(method)
        jo[jst.Option.MethodFactor] = JMethodFactor(method)
    if lookahead is not None:
        o[st.Option.Lookahead] = jo[jst.Option.Lookahead] = lookahead
    return o, jo


def _both(a, uplo, nb=NB):
    return (st.HermitianMatrix(st.Uplo[uplo], a, mb=nb, **CPU),
            jst.HermitianMatrix(jst.Uplo[uplo], a, mb=nb))


# f32 factors of a cond <= 5 matrix through differently ordered sums:
# 1e-5 relative to the factor's scale (|L| <= sqrt(5)) is ~100 ulps
FACTOR_TOL = 1e-5


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("method,lookahead", [("fused", None),
                                              ("tiled", None),
                                              ("tiled", 0)])
def test_posv_matches_jax(system, method, lookahead, uplo):
    """potrf + potrs on the Fused route, the pipelined Tiled loop
    (lookahead 1, the default) and the plain right-looking one."""
    s, b = system
    o, jo = _opts(method, lookahead)
    A, JA = _both(s, uplo)
    L, X = st.posv(A, st.Matrix(b, mb=NB, **CPU), o)
    JL, JX = jst.posv(JA, jst.Matrix(b, mb=NB), jo)
    assert L.mtype is st.MatrixType.Triangular and L.uplo.name == uplo
    ld, jld = L.to_numpy(), np.asarray(JL.to_dense())
    assert np.abs(ld - jld).max() <= FACTOR_TOL * np.abs(jld).max()
    # X of a cond <= 5 system: a few f32 ulps apart
    x = X.to_numpy()
    assert np.linalg.norm(x - JX.to_numpy()) <= 1e-5 * np.linalg.norm(x)
    assert np.linalg.norm(s @ x - b) <= 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_chol_loop_matches_jax_scan(system, uplo, monkeypatch):
    """Past its step cap the reference takes its fixed-shape step
    (forced here by a threshold lowered on the JAX side only); the port
    has no such form and runs its pipelined loop at any step count: the
    same factor."""
    s, _ = system
    monkeypatch.setattr(jblocked, "CHOL_SCAN_THRESHOLD", 2)
    o, jo = _opts("tiled")
    A, JA = _both(s, uplo)
    calls = []
    orig = tblocked.chol_loop_pipelined
    monkeypatch.setattr(tblocked, "chol_loop_pipelined",
                        lambda a, nb, f: calls.append(nb) or orig(a, nb, f))
    L = st.potrf(A, o).to_numpy()
    JL = np.asarray(jst.potrf(JA, jo).to_dense())
    assert calls == [NB]
    assert np.abs(L - JL).max() <= FACTOR_TOL * np.abs(JL).max()


def test_cholesky_blocked_many_steps_matches_jax_scan(system):
    """96 block steps of 4, past the reference's CHOL_SCAN_THRESHOLD
    (64): the port's loop against the reference's fixed-shape step
    itself."""
    a = system[0]
    nb = 4
    assert N // nb > jblocked.CHOL_SCAN_THRESHOLD
    L = torch.tril(tblocked.cholesky_blocked(torch.as_tensor(a), nb))
    JL = np.tril(np.asarray(jblocked.cholesky_scan(jnp.asarray(a), nb)))
    assert np.abs(L.numpy() - JL).max() <= FACTOR_TOL * np.abs(JL).max()


def test_potrf_reads_only_the_stored_triangle(system):
    """Fused, Lower: the raw storage goes to the library unmirrored; a
    poisoned upper triangle changes nothing."""
    s, _ = system
    poisoned = s.copy()
    poisoned[np.triu_indices(N, 1)] = np.nan
    L1 = st.potrf(st.HermitianMatrix(st.Uplo.Lower, s, mb=NB, **CPU))
    L2 = st.potrf(st.HermitianMatrix(st.Uplo.Lower, poisoned, mb=NB, **CPU))
    assert torch.equal(L1.to_dense(), L2.to_dense())


@pytest.mark.parametrize("k", [1, 130, 384])
def test_return_info_non_spd_matches_jax(system, k):
    """A matrix whose leading minor of order k is the first that is not
    positive definite: info == k on both sides, X NaN; and info == 0 on
    the SPD matrix with X equal to posv's."""
    s, b = system
    bad = s.copy()
    bad[k - 1, k - 1] = -10.0 * N
    A, JA = _both(bad, "Lower")
    L, X, info = st.posv(A, st.Matrix(b, mb=NB, **CPU), return_info=True)
    JL, JX, jinfo = jst.posv(JA, jst.Matrix(b, mb=NB), return_info=True)
    assert int(info) == int(jinfo) == k
    assert info.dtype == torch.int32
    assert torch.isnan(X.to_dense()).all()
    A, _ = _both(s, "Lower")
    L, X, info = st.posv(A, st.Matrix(b, mb=NB, **CPU), return_info=True)
    _, X0 = st.posv(A, st.Matrix(b, mb=NB, **CPU))
    assert int(info) == 0
    x, x0 = X.to_numpy(), X0.to_numpy()
    assert np.linalg.norm(x - x0) <= 1e-5 * np.linalg.norm(x0)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("diag", ["NonUnit", "Unit"])
def test_trtri_matches_jax(system, uplo, diag):
    """The triangular inverse of the Cholesky factor (identity-padded
    from 384 to 512 on both sides, solved against the identity)."""
    s, _ = system
    lo = np.linalg.cholesky(s.astype(np.float64)).astype(np.float32)
    t = lo if uplo == "Lower" else lo.T.copy()
    T = st.TriangularMatrix(st.Uplo[uplo], t, mb=NB,
                            diag=st.Diag[diag], **CPU)
    JT = jst.TriangularMatrix(jst.Uplo[uplo], t, mb=NB,
                              diag=jst.Diag[diag])
    inv = st.trtri(T).to_numpy()
    jinv = jst.trtri(JT).to_numpy()
    # a triangular solve against I, different libraries' blocking: the
    # inverse of a cond <= sqrt(5) factor to 1e-5 of its scale
    assert np.abs(inv - jinv).max() <= 1e-5 * np.abs(jinv).max()


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_potri_matches_jax(system, uplo):
    s, _ = system
    A, JA = _both(s, uplo)
    inv = st.potri(st.potrf(A)).to_numpy()
    jinv = np.asarray(jst.potri(jst.potrf(JA)).to_dense())
    assert np.abs(inv - jinv).max() <= 1e-5 * np.abs(jinv).max()
    # A^-1 itself (cond <= 5)
    assert np.abs(inv @ s - np.eye(N)).max() <= 1e-5


def test_posv_mixed_f64_matches_jax():
    """f64 input: the lo factor is f32 on both sides (the reference's
    f32 input would need a bf16 Cholesky, which XLA's CPU lacks)."""
    s, b = spd_system(np.random.default_rng(3), 256, 2)
    s, b = s.astype(np.float64), b.astype(np.float64)
    L, X, iters = st.posv_mixed(st.HermitianMatrix(st.Uplo.Lower, s, mb=64,
                                                   **CPU),
                                st.Matrix(b, mb=64, **CPU))
    JL, JX, jiters = jst.posv_mixed(jst.HermitianMatrix(jst.Uplo.Lower, s,
                                                        mb=64),
                                    jst.Matrix(b, mb=64))
    assert L.dtype == torch.float32 and JL.data.dtype == jnp.float32
    assert iters >= 0 and int(jiters) >= 0
    # both refine to the f64 criterion (eps * sqrt(n) * ||A||)
    x = X.to_numpy()
    np.testing.assert_allclose(x, JX.to_numpy(), rtol=1e-12, atol=1e-13)
    assert np.linalg.norm(s @ x - b) <= 1e-12 * np.linalg.norm(b)


def test_posv_mixed_gmres_f64_matches_jax():
    s, b = spd_system(np.random.default_rng(4), 256, 1)
    s, b = s.astype(np.float64), b.astype(np.float64)
    _, X, iters = st.posv_mixed_gmres(
        st.HermitianMatrix(st.Uplo.Lower, s, mb=64, **CPU),
        st.Matrix(b, mb=64, **CPU))
    _, JX, jiters = jst.posv_mixed_gmres(
        jst.HermitianMatrix(jst.Uplo.Lower, s, mb=64), jst.Matrix(b, mb=64))
    assert iters >= 0 and int(jiters) >= 0
    np.testing.assert_allclose(X.to_numpy(), JX.to_numpy(), rtol=1e-11,
                               atol=1e-12)


@pytest.mark.parametrize("fn", ["posv_mixed", "posv_mixed_gmres"])
def test_posv_mixed_f32_converges(system, fn):
    """f32 input, a bf16 factor (the library's Cholesky on the f32
    upcast, rounded): the reference cannot run it on the CPU, so the
    port is held to its own f32 posv: converged, X within 1e-5."""
    s, b = system
    b = b[:, :1] if fn == "posv_mixed_gmres" else b
    A = st.HermitianMatrix(st.Uplo.Lower, s, mb=NB, **CPU)
    B = st.Matrix(b, mb=NB, **CPU)
    L, X, iters = getattr(st, fn)(A, B)
    _, Xf = st.posv(A, B)
    assert L.dtype == torch.bfloat16 and iters >= 0
    x, xf = X.to_numpy(), Xf.to_numpy()
    assert np.linalg.norm(x - xf) <= 1e-5 * np.linalg.norm(xf)


def test_chol_diag_factor_bf16_is_rounded_f32_factor(system):
    s = torch.as_tensor(system[0][:128, :128]).bfloat16()
    L = tblocked.chol_diag_factor(s)
    assert L.dtype == torch.bfloat16
    assert torch.equal(L, torch.linalg.cholesky(s.float()).bfloat16())


# -- BLAS-3 -------------------------------------------------------------------

BLAS3 = ["herk", "syrk", "her2k", "syr2k", "hemm", "symm", "trmm"]


@pytest.mark.parametrize("name", BLAS3)
def test_blas3_matches_jax(name):
    rng = np.random.default_rng(BLAS3.index(name))
    m, k = 96, 40
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((m, k)).astype(np.float32)
    c = rng.standard_normal((m, m)).astype(np.float32)
    c = c + c.T
    sq = rng.standard_normal((m, m)).astype(np.float32)
    cb = rng.standard_normal((m, k)).astype(np.float32)
    H = st.HermitianMatrix(st.Uplo.Lower, c, mb=32, **CPU)
    JH = jst.HermitianMatrix(jst.Uplo.Lower, c, mb=32)

    def gm(x):
        return st.Matrix(x, mb=32, **CPU), jst.Matrix(x, mb=32)

    (A, JA), (B, JB), (CB, JCB) = gm(a), gm(b), gm(cb)
    if name in ("herk", "syrk"):
        out = getattr(st, name)(0.5, A, 2.0, H)
        ref = getattr(jblas3, name)(0.5, JA, 2.0, JH)
    elif name in ("her2k", "syr2k"):
        out = getattr(st, name)(0.5, A, B, 2.0, H)
        ref = getattr(jblas3, name)(0.5, JA, JB, 2.0, JH)
    elif name in ("hemm", "symm"):
        out = getattr(st, name)(st.Side.Left, 0.5, H, CB, 2.0, CB)
        ref = getattr(jblas3, name)(JSide.Left, 0.5, JH, JCB, 2.0, JCB)
    else:
        T = st.TriangularMatrix(st.Uplo.Lower, sq, mb=32, **CPU)
        JT = jst.TriangularMatrix(jst.Uplo.Lower, sq, mb=32)
        out = st.trmm(st.Side.Left, 0.5, T, CB)
        ref = jblas3.trmm(JSide.Left, 0.5, JT, JCB)
    o, r = out.to_numpy(), np.asarray(ref.to_dense())
    # sums of <= 96 O(1) f32 products in different orders
    np.testing.assert_allclose(o, r, atol=1e-4, rtol=1e-5)


def test_potrf_factor_from_jax_state(system):
    """potrf's triangular factor carried over with its metadata, then
    potrs on both sides."""
    s, b = system
    JL = jst.potrf(jst.HermitianMatrix(jst.Uplo.Upper, s, mb=NB))
    meta = {"m": JL.m, "n": JL.n, "mb": JL.mb, "nb": JL.nb,
            "mtype": JL.mtype.name, "uplo": JL.uplo.name,
            "op": JL.op.name, "diag": JL.diag.name}
    L = st.from_jax_state({"data": np.asarray(JL.data)}, meta, **CPU)
    assert L.mtype is st.MatrixType.Triangular and L.uplo is st.Uplo.Upper
    x = st.potrs(L, st.Matrix(b, mb=NB, **CPU)).to_numpy()
    jx = jchol.potrs(JL, jst.Matrix(b, mb=NB)).to_numpy()
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)

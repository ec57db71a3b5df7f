"""slate_tpu_torch's Aasen solver (hetrf / hetrs / hesv and the sy*
aliases) against the JAX package on the CPU, on the same seeded numpy
inputs: the blocked path's factors (pivots equal, L and T to 1e-10 in
f64), its structure (P A P^T = L T L^H, T banded < 2 nb, L unit lower),
the complex-symmetric congruence, the small-n Parlett-Reid path, info,
a run of more than 64 block steps held against the reference's
``_aasen_scan`` route, panels on the recursive kernel's route, and
factors carried over by from_jax_state."""

import numpy as np
import pytest
import torch

import slate_tpu as jst
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch import testing
from slate_tpu_torch.linalg import indefinite as tind
from slate_tpu_torch.tune import cache as tcache

CPU = dict(device="cpu")


def herm(rng, n, complex_=False):
    x = rng.standard_normal((n, n))
    if complex_:
        x = x + 1j * rng.standard_normal((n, n))
    return (x + x.conj().T) / 2


def close(x, ref, tol):
    x, ref = np.asarray(x), np.asarray(ref)
    assert x.shape == ref.shape
    assert np.linalg.norm(x - ref) <= tol * max(np.linalg.norm(ref), 1e-300)


def _pair(a, nb, sym=False, uplo="Lower"):
    kind = "SymmetricMatrix" if sym else "HermitianMatrix"
    return (getattr(st, kind)(getattr(st.Uplo, uplo), a, mb=nb, **CPU),
            getattr(jst, kind)(getattr(jst.Uplo, uplo), a, mb=nb))


def _same_factors(F, JF, tol=1e-10):
    n = F.L.m
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    assert F.hermitian == JF.hermitian
    assert F.T.mtype.name == JF.T.mtype.name
    assert (F.T.kl, F.T.ku) == (JF.T.kl, JF.T.ku)
    close(F.L.to_numpy(), np.asarray(JF.L.to_dense()), tol)
    close(F.T.to_numpy(), np.asarray(JF.T.to_dense()), tol)
    assert F.pivots.shape[0] >= n


def test_hesv_matches_jax(rng):
    """hesv at n = 32, nb = 8 (the blocked path): X equal to the
    reference's, T Hermitian."""
    n = 32
    a = herm(rng, n)
    b = rng.standard_normal((n, 3))
    A, JA = _pair(a, 8)
    F, X = st.hesv(A, st.Matrix(b, mb=8, **CPU))
    JF, JX = jst.hesv(JA, jst.Matrix(b, mb=8))
    _same_factors(F, JF)
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    close(a @ X.to_numpy(), b, 1e-12)
    t = F.T.to_numpy()
    np.testing.assert_allclose(t, t.conj().T, atol=1e-9)


def test_hetrf_blocked_structure(rng):
    """Blocked Aasen (n > 2 nb): P A P^T = L T L^H, L unit lower, T
    zero outside |i - j| < 2 nb and Hermitian; hetrs solves; factors
    equal to the reference's."""
    n, nb = 96, 8
    a = herm(rng, n)
    A, JA = _pair(a, nb)
    F = st.hetrf(A)
    _same_factors(F, jst.hetrf(JA))
    L = np.tril(F.L.to_numpy())
    T = F.T.to_numpy()
    p = F.pivots.numpy()[:n]
    close(L @ T @ L.conj().T, a[p][:, p], 1e-12)
    assert np.allclose(np.diag(L), 1)
    ii, jj = np.indices((n, n))
    assert np.all(T[np.abs(ii - jj) >= 2 * nb] == 0)
    np.testing.assert_allclose(T, T.conj().T, atol=1e-10)
    b = rng.standard_normal((n, 3))
    X = st.hetrs(F, st.Matrix(b, mb=nb, **CPU))
    close(a @ X.to_numpy(), b, 1e-12)


def test_sytrf_blocked_complex_symmetric(rng):
    """The blocked path with the transpose congruence (L T L^T)."""
    n, nb = 64, 8
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = (a + a.T) / 2
    A, JA = _pair(a, nb, sym=True)
    F = st.sytrf(A)
    JF = jst.sytrf(JA)
    assert not F.hermitian
    _same_factors(F, JF)
    L = np.tril(F.L.to_numpy())
    p = F.pivots.numpy()[:n]
    close(L @ F.T.to_numpy() @ L.T, a[p][:, p], 1e-12)
    b = rng.standard_normal((n, 2)) + 0j
    X = st.sytrs(F, st.Matrix(b, mb=nb, **CPU))
    close(X.to_numpy(), np.asarray(jst.sytrs(JF, jst.Matrix(b, mb=nb))
                                   .to_dense()), 1e-10)
    close(a @ X.to_numpy(), b, 1e-10)


@pytest.mark.parametrize("cplx", [False, True])
def test_parlett_reid_path_matches_jax(rng, cplx):
    """n <= 2 nb: the pivoted Parlett-Reid reduction, T tridiagonal
    with the General tag; factors and X equal to the reference's."""
    n, nb = 16, 8
    a = herm(rng, n, complex_=cplx)
    b = rng.standard_normal((n, 2)) + (0j if cplx else 0)
    A, JA = _pair(a, nb)
    F, X = st.hesv(A, st.Matrix(b, mb=nb, **CPU))
    JF, JX = jst.hesv(JA, jst.Matrix(b, mb=nb))
    _same_factors(F, JF)
    assert F.T.mtype is st.MatrixType.General
    t = F.T.to_numpy()
    ii, jj = np.indices((n, n))
    assert np.all(t[np.abs(ii - jj) > 1] == 0)
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)
    close(a @ X.to_numpy(), b, 1e-12)


def test_hetrf_info(rng):
    """info 0 on a nonsingular matrix; > 0 (the first zero pivot of T's
    LU) on the zero matrix, as the reference's."""
    n = 12
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2 + n * np.eye(n)
    _, info = st.hetrf(st.HermitianMatrix(st.Uplo.Lower, a, mb=8, **CPU),
                       return_info=True)
    assert int(info) == 0
    z = np.zeros((n, n))
    _, info = st.hetrf(st.HermitianMatrix(st.Uplo.Lower, z, mb=8, **CPU),
                       return_info=True)
    _, jinfo = jst.hetrf(jst.HermitianMatrix(jst.Uplo.Lower, z, mb=8),
                         return_info=True)
    assert int(info) > 0 and int(info) == int(jinfo)
    # the blocked path's T goes through gbtrf for its info
    big = np.zeros((40, 40))
    _, info = st.hetrf(st.HermitianMatrix(st.Uplo.Lower, big, mb=8, **CPU),
                       return_info=True)
    _, jinfo = jst.hetrf(jst.HermitianMatrix(jst.Uplo.Lower, big, mb=8),
                         return_info=True)
    assert int(info) > 0 and int(info) == int(jinfo)


def test_many_block_steps_match_aasen_scan(rng):
    """n = 600, nb = 8: 75 block steps, past the reference's
    AASEN_SCAN_THRESHOLD (64), where it takes its fixed-shape
    _aasen_scan form; the port runs the blocked loop. Pivots equal, L
    and T to 1e-10, the solves equal."""
    import importlib
    jind = importlib.import_module("slate_tpu.linalg.indefinite")
    n, nb = 600, 8
    assert -(-n // nb) > jind.AASEN_SCAN_THRESHOLD
    a = herm(rng, n)
    b = rng.standard_normal((n, 2))
    A, JA = _pair(a, nb)
    F, X = st.hesv(A, st.Matrix(b, mb=nb, **CPU))
    JF, JX = jst.hesv(JA, jst.Matrix(b, mb=nb))
    _same_factors(F, JF)
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)


def test_sysv_equals_hesv_bitwise(rng):
    """The aliases take the same route: sysv's X bitwise hesv's."""
    n, nb = 40, 8
    a = herm(rng, n)
    b = rng.standard_normal((n, 2))
    A, _ = _pair(a, nb)
    B = st.Matrix(b, mb=nb, **CPU)
    F1, X1 = st.hesv(A, B)
    F2, X2 = st.sysv(A, B)
    assert torch.equal(X1.data, X2.data) and torch.equal(F1.T.data, F2.T.data)
    assert torch.equal(st.sytrs(F1, B).data, st.hetrs(F1, B).data)


def test_upper_storage_and_padding(rng):
    """Upper storage and an order that is not a tile multiple (the
    permutation extended over the padded rows)."""
    n, nb = 45, 8
    a = herm(rng, n)
    b = rng.standard_normal((n, 2))
    A, JA = _pair(a, nb, uplo="Upper")
    F, X = st.hesv(A, st.Matrix(b, mb=nb, **CPU))
    JF, JX = jst.hesv(JA, jst.Matrix(b, mb=nb))
    _same_factors(F, JF)
    assert F.pivots.shape[0] == A.data.shape[0]
    close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-10)


def test_hetrf_panels_through_the_recursive_route(tmp_path, monkeypatch):
    """With measured ``pallas_rec`` entries (f32) the Aasen panels
    (n - r0) x nb go through lu_panel_rec (its plain versions on the
    CPU) and the symmetric permutation through _compose_swaps: the
    pivots equal the reference's cold route's, X within 1e-5 of it, on
    testing.indefinite_system."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    from slate_tpu_torch.linalg import lu as tlu
    from slate_tpu_torch.ops import kernels as pk
    calls, swaps = [], []
    real_rec, real_swaps = pk.lu_panel_rec, tlu._compose_swaps
    monkeypatch.setattr(pk, "lu_panel_rec",
                        lambda a, *k, **kw: calls.append(tuple(a.shape))
                        or real_rec(a, *k, **kw))
    monkeypatch.setattr(tlu, "_compose_swaps",
                        lambda p, m: swaps.append(m) or real_swaps(p, m))
    try:
        for bk in (128, 256, 512):
            tcache.get_cache().put("lu_panel", torch.float32, bk,
                                   {"method_lu_panel": "pallas_rec"})
        n, nb = 384, 128
        a, b = testing.indefinite_system(5, n, 2, "cpu")
        a, b = a.numpy(), b.numpy()
        A, JA = _pair(a, nb)
        F, X = st.hesv(A, st.Matrix(b, mb=nb, **CPU))
        JF, JX = jst.hesv(JA, jst.Matrix(b, mb=nb))
        # Aasen's one panel, then T's LU: its band (2 nb - 1 = 255) is
        # not narrow at n = 384, so gbtrf takes getrf (one 384 panel)
        assert calls == [(256, 128), (384, 384)]
        assert swaps[0] == 256
        assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
        close(X.to_numpy(), np.asarray(JX.to_dense()), 1e-5)
    finally:
        tcache.reset_cache()
        jcache.reset_cache()


def test_indefinite_system_structure():
    """testing.indefinite_system: symmetric, indefinite, its spectrum in
    +-[2.6, 5.4] sqrt(n), and Aasen's panels pivot off the diagonal."""
    n = 256
    a, b = testing.indefinite_system(1, n, 3, "cpu", torch.float64)
    a = a.numpy()
    assert b.shape == (n, 3) and np.allclose(a, a.T)
    w = np.linalg.eigvalsh(a) / np.sqrt(n)
    assert w.min() < 0 < w.max()
    assert np.abs(w).min() > 2.4 and np.abs(w).max() < 5.6
    F = st.hetrf(st.HermitianMatrix(st.Uplo.Lower, a, mb=32, **CPU))
    assert (F.pivots.numpy()[:n] != np.arange(n)).sum() > n // 4


def test_ltl_factors_from_jax_state(rng):
    """hetrf's factors carried over (L, T with their metadata, pivots,
    hermitian): hetrs with them equals the reference's hetrs."""
    def meta(M):
        return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
                "mtype": M.mtype.name, "uplo": M.uplo.name,
                "op": M.op.name, "diag": M.diag.name, "kl": M.kl,
                "ku": M.ku}

    for n, nb in ((48, 8), (12, 8)):
        a = herm(rng, n)
        b = rng.standard_normal((n, 2))
        JF = jst.hetrf(jst.HermitianMatrix(jst.Uplo.Lower, a, mb=nb))
        F = st.from_jax_state(
            {"L": np.asarray(JF.L.data), "T": np.asarray(JF.T.data),
             "pivots": np.asarray(JF.pivots)},
            {"L": meta(JF.L), "T": meta(JF.T), "hermitian": JF.hermitian},
            **CPU)
        assert isinstance(F, st.LTLFactors) and F.hermitian
        assert F.T.mtype.name == JF.T.mtype.name
        close(st.hetrs(F, st.Matrix(b, mb=nb, **CPU)).to_numpy(),
              np.asarray(jst.hetrs(JF, jst.Matrix(b, mb=nb)).to_dense()),
              1e-12)


def test_permute_rows_matches_reference(rng):
    """_permute_rows over padded storage, forward and inverse, with a
    permutation shorter and longer than B's rows."""
    import importlib
    import jax.numpy as jnp
    jind = importlib.import_module("slate_tpu.linalg.indefinite")
    b = rng.standard_normal((20, 3))
    for plen in (16, 20, 32):
        perm = np.concatenate([rng.permutation(16),
                               np.arange(16, plen)]).astype(np.int32)
        for inv in (False, True):
            out = tind._permute_rows(st.Matrix(b, mb=8, **CPU),
                                     torch.as_tensor(perm), inverse=inv)
            ref = jind._permute_rows(jst.Matrix(b, mb=8),
                                     jnp.asarray(perm), inverse=inv)
            assert np.array_equal(out.data.numpy(), np.asarray(ref.data))


def test_f32_accuracy_matches_reference():
    """The blocked Aasen's f32 accuracy is the reference's: on
    testing.indefinite_system (2-norm condition ~1.7) at n = 1024,
    nb = 128 both packages lose digits alike (the block congruence's L
    is ill-conditioned: its multipliers W = L3 L2^-1 come from a
    triangular inverse of a random panel's L), so the port's backward
    error is held within a factor of 3 of the reference's, not to a
    fixed limit (ROADMAP queue 3)."""
    n, nb = 1024, 128
    a, b = testing.indefinite_system(5, n, 2, "cpu")
    a, b = a.numpy(), b.numpy()
    A, JA = _pair(a, nb)
    _, X = st.hesv(A, st.Matrix(b, mb=nb, **CPU))
    _, JX = jst.hesv(JA, jst.Matrix(b, mb=nb))
    a64 = a.astype(np.float64)

    def berr(x):
        x = np.asarray(x, np.float64)
        return np.linalg.norm(a64 @ x - b) / (np.linalg.norm(a64)
                                              * np.linalg.norm(x))

    e, je = berr(X.to_numpy()), berr(JX.to_dense())
    assert je / 3 <= e <= 3 * je

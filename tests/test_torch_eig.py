"""slate_tpu_torch's Hermitian eigensolvers (heev over its three methods,
hegst / hegv, the staged he2hb -> hb2st -> steqr2 / sterf pipeline and
the routed chain accumulation) against the JAX package on the CPU.

The same seeded numpy inputs go through both packages, in f64 (the JAX
side runs with x64, as its own tests do), at the reference tests'
sizes. Spectra and decompositions are compared, not pass counts: the
port's sweep runs on the host in numpy scalars, XLA may contract the
reference's sweep into fused multiply-adds, so d, e and the number of
passes may differ in the last ulps. Eigenvectors are compared column by
column up to sign (a phase for complex) where the spectral gaps allow.
A stage's input can be carried over from the JAX side
(``from_jax_state``), so a disagreement is localized to one stage."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.methods import MethodEig as JMethodEig
from slate_tpu.linalg import eig as jeig
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.tune import cache as tcache

CPU = {"device": "cpu"}
#: spectra: relative to the spectrum's scale, the reference tests' f64
#: tolerance for eigenvalues
W_TOL = 1e-10
#: eigenvectors column by column (up to sign / phase), decompositions
#: and orthogonality: f64 rounding amplified by the smallest spectral
#: gap of these random matrices (> 1e-3)
V_TOL = 1e-8

METHODS = {"auto": (st.MethodEig.Auto, JMethodEig.Auto),
           "qr_iteration": (st.MethodEig.QRIteration, JMethodEig.QRIteration),
           "dc": (st.MethodEig.DC, JMethodEig.DC)}


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


def herm(rng, n, complex_=False):
    a = rng.standard_normal((n, n))
    if complex_:
        a = a + 1j * rng.standard_normal((n, n))
    return (a + a.conj().T) / 2


def tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "to_dense"):
        return _np(x.to_dense())
    return np.asarray(x)


def _meta(M):
    """The metadata from_jax_state takes, read off a JAX TiledMatrix."""
    return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
            "mtype": M.mtype.name, "uplo": M.uplo.name, "op": M.op.name,
            "diag": M.diag.name, "kl": M.kl, "ku": M.ku}


def same_columns(v, ref, tol):
    """Columns of v equal those of ref up to a sign (phase), column by
    column."""
    v, ref = _np(v), _np(ref)
    for j in range(ref.shape[1]):
        k = int(np.argmax(np.abs(ref[:, j])))
        ph = v[k, j] / ref[k, j]
        ph = ph / abs(ph)
        np.testing.assert_allclose(v[:, j], ph * ref[:, j], atol=tol)


def check_eig(a, w, V, wref, tol=V_TOL):
    """w against wref (W_TOL of the scale), A V = V diag(w), V^H V = I."""
    w, v = _np(w), _np(V)
    scale = max(np.abs(wref).max(), 1.0)
    np.testing.assert_allclose(w, wref, atol=W_TOL * scale)
    np.testing.assert_allclose(a @ v, v * w[None, :], atol=tol * scale)
    np.testing.assert_allclose(v.conj().T @ v, np.eye(v.shape[1]),
                               atol=tol)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_heev_matches_jax(rng, method, complex_):
    """heev on the three routes: the same spectrum and the same
    eigenvectors as the JAX package's route of the same name (Auto: the
    two libraries' eigensolvers), and a decomposition of A."""
    n, nb = (32, 8) if not complex_ else (24, 8)
    a = herm(rng, n, complex_)
    uplo = st.Uplo.Lower if not complex_ else st.Uplo.Upper
    A = st.HermitianMatrix(uplo, a, mb=nb, **CPU)
    JA = jst.HermitianMatrix(jst.Uplo(uplo.value), a, mb=nb)
    tm, jm = METHODS[method]
    w, V = st.heev(A, {st.Option.MethodEig: tm})
    jw, JV = jst.heev(JA, {jst.Option.MethodEig: jm})
    check_eig(a, w, V, np.asarray(jw))
    same_columns(V, JV.to_numpy(), V_TOL)


@pytest.mark.parametrize("method", list(METHODS))
def test_heev_values_only_matches_jax(rng, method):
    """want_vectors=False: the values-only routes (sterf on the staged
    ones)."""
    a = herm(rng, 32)
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=8, **CPU)
    JA = jst.HermitianMatrix(jst.Uplo.Lower, a, mb=8)
    tm, jm = METHODS[method]
    res = st.heev(A, {st.Option.MethodEig: tm}, want_vectors=False)
    jres = jst.heev(JA, {jst.Option.MethodEig: jm}, want_vectors=False)
    assert res.vectors is None
    np.testing.assert_allclose(_np(res.values), np.asarray(jres.values),
                               atol=W_TOL * np.abs(np.asarray(
                                   jres.values)).max())
    np.testing.assert_allclose(_np(st.eig_vals(A)), np.linalg.eigvalsh(a),
                               atol=W_TOL * 10)


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches_jax(rng, itype):
    """Generalized problems: potrf(B), hegst, heev, back-transform; the
    same spectrum and vectors as the JAX package."""
    n = 24
    a = herm(rng, n)
    bm = rng.standard_normal((n, n))
    b = bm @ bm.T + n * np.eye(n)
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=8, **CPU)
    B = st.HermitianMatrix(st.Uplo.Lower, b, mb=8, **CPU)
    w, V = st.hegv(itype, A, B)
    jw, JV = jst.hegv(itype, jst.HermitianMatrix(jst.Uplo.Lower, a, mb=8),
                      jst.HermitianMatrix(jst.Uplo.Lower, b, mb=8))
    np.testing.assert_allclose(_np(w), np.asarray(jw),
                               atol=W_TOL * np.abs(np.asarray(jw)).max())
    same_columns(V, JV.to_numpy(), 1e-9)


@pytest.mark.parametrize("nb", [32, 48])
def test_hegst_blocked_matches_jax(rng, nb):
    """The blocked two-sided transform (an explicit BlockSize) and the
    whole-matrix default both match the JAX package's, to 1e-11 of the
    scale (the reference test's tolerance)."""
    n = 160
    a = herm(rng, n)
    y = rng.standard_normal((n, n))
    l = np.linalg.cholesky(y @ y.T / n + 4.0 * np.eye(n))
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=32, **CPU)
    L = st.HermitianMatrix(st.Uplo.Lower, l, mb=32, **CPU)
    JA = jst.HermitianMatrix(jst.Uplo.Lower, a, mb=32)
    JL = jst.HermitianMatrix(jst.Uplo.Lower, l, mb=32)
    for opts, jopts in (({st.Option.BlockSize: nb},
                         {jst.Option.BlockSize: nb}), (None, None)):
        C = st.hegst(1, A, L, opts)
        JC = jst.hegst(1, JA, JL, jopts)
        np.testing.assert_allclose(C.to_numpy(), JC.to_numpy(),
                                   atol=1e-11 * np.abs(a).max())
    got = teig._hegst_blocked_lower(torch.as_tensor(a), torch.as_tensor(l),
                                    nb)
    ref = jeig._hegst_blocked_lower(jnp.asarray(a), jnp.asarray(l), nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-11)


@pytest.mark.parametrize("n,nb,complex_", [(32, 8, False), (32, 8, True),
                                            (256, 128, True)],
                         ids=["real", "complex", "complex-square-panel"])
def test_he2hb_matches_jax(rng, n, nb, complex_):
    """Stage 1: the band and Q equal the JAX package's to f64 rounding
    (1e-12 of the scale). The last panel is square, so in the complex
    cases the last reflector acts on a 1x1 block; at 128 x 128 the
    library geqrf on the CPU (MKL's blocked path) skips that step, and
    the band matches only because the port applies it."""
    a = herm(rng, n, complex_)
    B, Q = st.he2hb(st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, **CPU))
    JB, JQ = jst.he2hb(jst.HermitianMatrix(jst.Uplo.Lower, a, mb=nb))
    assert (B.kl, B.ku, B.mtype.name) == (JB.kl, JB.ku, JB.mtype.name)
    scale = np.abs(a).max()
    np.testing.assert_allclose(B.to_numpy(), JB.to_numpy(),
                               atol=1e-12 * scale)
    np.testing.assert_allclose(Q.to_numpy(), JQ.to_numpy(), atol=1e-12)
    q, b = Q.to_numpy(), B.to_numpy()
    np.testing.assert_allclose(q @ b @ q.conj().T, a, atol=1e-12 * scale)


def spd_band(rng, n, kd):
    x = rng.standard_normal((n, n))
    a = (x + x.T) / 2
    return np.triu(np.tril(a, kd), -kd) + 2 * kd * np.eye(n)


@pytest.mark.parametrize("branch", ["band", "dense", "complex"])
def test_hb2st_matches_jax(rng, branch):
    """Stage 2 on a band carried over from the JAX package: the windowed
    chase (2 <= kd <= n/3; complex Hermitian included) and the dense
    Householder loop (kd > n/3) give the JAX package's d, e and Q2
    (1e-10 of the scale: both run LAPACK QRs of the bulge blocks)."""
    if branch == "complex":
        n, kd = 32, 3
        x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        a = np.triu(np.tril((x + x.conj().T) / 2, kd), -kd) + 10 * np.eye(n)
    else:
        n, kd = (48, 3) if branch == "band" else (40, 16)
        a = spd_band(rng, n, kd)
    JB = jst.HermitianBandMatrix(jst.Uplo.Lower, kd, a, mb=8)
    B = st.from_jax_state({"data": np.asarray(JB.data)}, _meta(JB), **CPU)
    assert B.mtype is st.MatrixType.HermitianBand and B.kl == kd
    tri = st.hb2st(B)
    jtri = jst.hb2st(JB)
    scale = np.abs(a).max()
    np.testing.assert_allclose(_np(tri.d), np.asarray(jtri.d),
                               atol=1e-10 * scale)
    np.testing.assert_allclose(_np(tri.e), np.asarray(jtri.e),
                               atol=1e-10 * scale)
    np.testing.assert_allclose(tri.Q.to_numpy(), jtri.Q.to_numpy(),
                               atol=1e-10)
    q = tri.Q.to_numpy()
    np.testing.assert_allclose(q @ tridiag(_np(tri.d), _np(tri.e))
                               @ q.conj().T, a, atol=1e-10 * scale)


@pytest.mark.parametrize("n", [16, 48])
def test_steqr2_qr_matches_jax(rng, n):
    """The QR iteration on a random tridiagonal: the spectrum, the
    eigenvectors (column by column, up to sign), and
    Z diag(w) Z^T = T, Z^T Z = I to the reference test's tolerances."""
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    T = tridiag(d, e)
    w, Z, info = teig.steqr2_qr(torch.as_tensor(d), torch.as_tensor(e))
    jw, JZ, jinfo = jeig.steqr2_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0 == int(jinfo)
    np.testing.assert_allclose(_np(w), np.asarray(jw), rtol=1e-10,
                               atol=1e-12)
    same_columns(Z, np.asarray(JZ), 1e-9)
    z = _np(Z)
    np.testing.assert_allclose(z.T @ z, np.eye(n), atol=1e-12)
    np.testing.assert_allclose(z @ np.diag(_np(w)) @ z.T, T, atol=1e-11)


def _one_pass_loop(d, e, maxit_factor=30, route=None):
    """steqr2_qr as one steqr_sweep pass a loop iteration, the count
    read after each: the loop the multi-pass launches replace."""
    n = d.shape[0]
    Z = torch.eye(n, dtype=d.dtype)
    cnt, it = pk.unconverged(d, e, torch.finfo(d.dtype).eps), 0
    while int(cnt) > 0 and it < maxit_factor * n:
        d, e, cs, sn, cnt = pk.steqr_sweep(d, e)
        Z = route(Z, cs, sn) if route else Z @ teig._givens_chain_matrix(
            cs, sn, n, d.dtype)
        it += 1
    order = torch.argsort(d, stable=True)
    return d[order], Z[:, order], cnt, it


@pytest.mark.parametrize("n,dtype,passes_per_launch", [
    (16, torch.float64, 32), (48, torch.float64, 32),
    (48, torch.float64, 5), (48, torch.float32, 32)])
def test_steqr2_qr_multi_pass_equals_one_pass_loop(rng, n, dtype,
                                                   passes_per_launch,
                                                   monkeypatch):
    """The passes in multi-pass launches (every launch's chains applied
    in pass order after it) give w, Z and info bitwise the one-pass
    loop's, and steqr2_qr.passes counts that loop's passes."""
    monkeypatch.setattr(pk, "STEQR_PASSES_PER_LAUNCH", passes_per_launch)
    d = torch.as_tensor(rng.standard_normal(n)).to(dtype)
    e = torch.as_tensor(rng.standard_normal(n - 1)).to(dtype)
    w0, Z0, info0, it = _one_pass_loop(d, e)
    teig.steqr2_qr.passes = 0
    w, Z, info = teig.steqr2_qr(d, e)
    assert torch.equal(w, w0) and torch.equal(Z, Z0)
    assert int(info) == int(info0) == 0 and info.dtype == torch.int32
    assert teig.steqr2_qr.passes == it > passes_per_launch


@pytest.mark.parametrize("maxit_factor,passes_per_launch", [
    (30, 32), (30, 7), (1, 32), (1, 5), (0, 32)])
def test_steqr2_qr_launch_sizes(rng, maxit_factor, passes_per_launch,
                                monkeypatch):
    """Each launch is given min(STEQR_PASSES_PER_LAUNCH, what is left of
    the cap maxit_factor * n); the loop stops after a launch that ends
    at a count of 0 or at the cap, where info is the count left (the
    one-pass loop's). n = 24: ~40 passes, so a factor of 1 (24 passes)
    stops at the cap."""
    monkeypatch.setattr(pk, "STEQR_PASSES_PER_LAUNCH", passes_per_launch)
    n = 24
    d = torch.as_tensor(rng.standard_normal(n))
    e = torch.as_tensor(rng.standard_normal(n - 1))
    asked, ran = [], []
    real = pk.steqr_sweeps

    def spy(d, e, k):
        out = real(d, e, k)
        asked.append(k)
        ran.append(out[4].tolist())
        return out

    monkeypatch.setattr(pk, "steqr_sweeps", spy)
    w, Z, info = teig.steqr2_qr(d, e, maxit_factor=maxit_factor)
    w0, Z0, info0, it = _one_pass_loop(d, e, maxit_factor)
    assert torch.equal(w, w0) and torch.equal(Z, Z0)
    assert int(info) == int(info0)
    cap, done = maxit_factor * n, 0
    for k, (p, count) in zip(asked, ran):
        assert k == min(passes_per_launch, cap - done)
        assert p == k or count == 0
        done += p
    assert done == it and ran[-1][1] == int(info)
    assert (int(info) > 0) == (done == cap)


def test_steqr2_clustered_deflation(rng):
    """Clustered eigenvalues (deflation stress, the reference test's
    case): the same spectrum as numpy and the JAX package, a
    decomposition of T."""
    n = 30
    d = np.repeat(rng.standard_normal(n // 3), 3)
    e = 1e-9 * rng.standard_normal(n - 1)
    T = tridiag(d, e)
    w, Z, info = teig.steqr2_qr(torch.as_tensor(d), torch.as_tensor(e))
    jw, _, _ = jeig.steqr2_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0
    np.testing.assert_allclose(_np(w), np.linalg.eigvalsh(T), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(_np(w), np.asarray(jw), rtol=1e-9,
                               atol=1e-12)
    z = _np(Z)
    np.testing.assert_allclose(z @ np.diag(_np(w)) @ z.T, T, atol=1e-11)


def test_steqr2_with_q_from_jax_tridiag(rng):
    """The driver with a back-transform: the JAX package's he2hb / hb2st
    carried over (TridiagResult through from_jax_state), then steqr2
    accumulating onto Q (the z0 slot), against the JAX package's
    steqr2 on the same state."""
    n = 48
    a = herm(rng, n)
    JA = jst.HermitianMatrix(jst.Uplo.Lower, a, mb=16)
    JB, JQ1 = jst.he2hb(JA)
    jtri = jst.hb2st(JB)
    JQ = jst.unmtr_he2hb(JQ1, jtri.Q)
    tri = st.from_jax_state({"d": np.asarray(jtri.d),
                             "e": np.asarray(jtri.e),
                             "Q": np.asarray(JQ.data)}, {"Q": _meta(JQ)},
                            **CPU)
    assert isinstance(tri, st.TridiagResult)
    w, V = st.steqr2(tri.d, tri.e, tri.Q)
    jw, JV = jst.steqr2(jtri.d, jtri.e, JQ)
    check_eig(a, w, V, np.asarray(jw))
    same_columns(V, JV.to_numpy(), V_TOL)
    wv, none = st.steqr2(tri.d, tri.e, want_vectors=False)
    assert none is None
    np.testing.assert_allclose(_np(wv), np.asarray(jw), atol=1e-12 * n)


def test_sterf_matches_jax(rng):
    """Values only: the library's eigvalsh of the tridiagonal against
    the reference's eigh_tridiagonal."""
    n = 48
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    np.testing.assert_allclose(
        _np(st.sterf(torch.as_tensor(d), torch.as_tensor(e))),
        np.asarray(jst.sterf(jnp.asarray(d), jnp.asarray(e))),
        rtol=1e-10, atol=1e-12)


def test_steqr2_routed_chain_matches_cold():
    """A cached ('steqr2', 'chain') = 'pallas_rec' entry (and a chain
    block of 16, so n = 64 passes the gate) reroutes the accumulation
    through the chain kernel's entry (its plain version on the CPU):
    the same eigendecomposition as the cold dense compose and as the
    JAX package's routed run (its Pallas kernel interpreted), on the
    reference test's clustered spectrum."""
    n = 64
    d = np.concatenate([np.ones(n // 2), 2.0 * np.ones(n // 2)]) \
        + 1e-8 * np.arange(n)
    e = 1e-3 * np.ones(n - 1)
    td, te = torch.as_tensor(d), torch.as_tensor(e)
    w0, Z0, _ = teig.steqr2_qr(td, te)
    for cache, dt in ((tcache, torch.float64), (jcache, np.float64)):
        cache.get_cache().put("steqr2", dt, n, {"chain": "pallas_rec"})
        cache.get_cache().put("steqr2", None, None, {"chain_blk": 16})
    assert pk.givens_chain_eligible(n, n, torch.float64)
    w1, Z1, info = teig.steqr2_qr(td, te)
    jw, _, _ = jeig.steqr2_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0
    np.testing.assert_allclose(_np(w1), _np(w0), atol=1e-12)
    np.testing.assert_allclose(_np(Z1), _np(Z0), atol=1e-12)
    np.testing.assert_allclose(_np(w1), np.asarray(jw), atol=1e-10)
    z = _np(Z1)
    np.testing.assert_allclose(z.T @ tridiag(d, e) @ z, np.diag(_np(w1)),
                               atol=1e-8)


def test_steqr2_complex_takes_stedc_and_grid_raises(rng, monkeypatch):
    """The reference's routing: complex d warns and takes stedc; a grid
    must be a parallel.ProcessGrid (the grid route itself:
    tests/test_torch_dist.py)."""
    n = 8
    d = torch.as_tensor(rng.standard_normal(n) + 0j)
    e = torch.as_tensor(rng.standard_normal(n - 1) + 0j)
    calls = []
    monkeypatch.setattr(teig, "stedc", lambda *a, **k: calls.append(1)
                        or ("w", "v"))
    with pytest.warns(UserWarning, match="stedc"):
        assert teig.steqr2(d, e) == ("w", "v")
    assert calls
    with pytest.raises(TypeError, match="ProcessGrid"):
        st.steqr2(d.real, e.real, opts={st.Option.Grid: object()})


def test_heev_entry_needs_a_card_by_default(rng, monkeypatch):
    """No silent CPU fall back: numpy into steqr2 with no device asks
    for the card, and without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.steqr2(rng.standard_normal(4), rng.standard_normal(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.HermitianMatrix(st.Uplo.Lower, herm(rng, 4), mb=4)

"""slate_tpu_torch's SVD (svd over its three methods, the staged ge2tb ->
tb2bd -> bdsqr pipeline, the bidiagonal QR iteration and its routed
chain accumulation) against the JAX package on the CPU.

The same seeded numpy inputs go through both packages in f64 at the
reference tests' sizes. Singular values and decompositions are
compared, not pass counts (the port's sweep runs on the host in numpy
scalars, the reference's in XLA, which may fuse multiply-adds); singular
vectors column by column up to a sign (a phase for complex) shared by
the pair u_i, v_i. A stage's input can be carried over from the JAX
side (``from_jax_state``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.methods import MethodSVD as JMethodSVD
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.tune import cache as tcache

import importlib

# both packages re-export the svd FUNCTION under the module's name
jsvd = importlib.import_module("slate_tpu.linalg.svd")
tsvd = importlib.import_module("slate_tpu_torch.linalg.svd")

CPU = {"device": "cpu"}
#: singular values, relative to the largest (the reference tests' f64
#: tolerance)
S_TOL = 1e-10
#: singular vectors column by column and reconstructions, relative to
#: the scale: f64 rounding amplified by the smallest gap (> 1e-3 here)
V_TOL = 1e-8

METHODS = {"auto": (st.MethodSVD.Auto, JMethodSVD.Auto),
           "qr_iteration": (st.MethodSVD.QRIteration,
                            JMethodSVD.QRIteration),
           "dc": (st.MethodSVD.DC, JMethodSVD.DC)}


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


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "to_dense"):
        return _np(x.to_dense())
    return np.asarray(x)


def _meta(M):
    return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
            "mtype": M.mtype.name, "uplo": M.uplo.name, "op": M.op.name,
            "diag": M.diag.name, "kl": M.kl, "ku": M.ku}


def gauss(rng, m, n, complex_=False):
    a = rng.standard_normal((m, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, n))
    return a


def same_pairs(u, vh, ju, jvh, tol):
    """Singular vector pairs equal up to one phase per pair."""
    u, vh, ju, jvh = _np(u), _np(vh), _np(ju), _np(jvh)
    for j in range(ju.shape[1]):
        k = int(np.argmax(np.abs(ju[:, j])))
        ph = u[k, j] / ju[k, j]
        ph = ph / abs(ph)
        np.testing.assert_allclose(u[:, j], ph * ju[:, j], atol=tol)
        np.testing.assert_allclose(vh[j], np.conj(ph) * jvh[j], atol=tol)


def check_svd(a, s, U, Vh, sref):
    s, u, vh = _np(s), _np(U), _np(Vh)
    scale = sref.max()
    np.testing.assert_allclose(s, sref, atol=S_TOL * scale)
    np.testing.assert_allclose(u @ np.diag(s) @ vh, a, atol=V_TOL * scale)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("shape", [(32, 32, False), (40, 24, False),
                                   (24, 24, True)],
                         ids=["square", "tall", "complex"])
def test_svd_matches_jax(rng, method, shape):
    """svd on the three routes: singular values, vectors (pairwise up to
    a phase) and the reconstruction, against the JAX package's route of
    the same name (Auto and DC: the two libraries' SVDs)."""
    m, n, cplx = shape
    a = gauss(rng, m, n, cplx)
    tm, jm = METHODS[method]
    res = st.svd(st.Matrix(a, mb=8, **CPU), {st.Option.MethodSVD: tm})
    jres = jst.svd(jst.Matrix(a, mb=8), {jst.Option.MethodSVD: jm})
    check_svd(a, res.s, res.U, res.Vh, np.asarray(jres.s))
    same_pairs(res.U, res.Vh, jres.U.to_numpy(), jres.Vh.to_numpy(),
               V_TOL)


@pytest.mark.parametrize("method", list(METHODS))
def test_svd_vals_matches_jax(rng, method):
    a = gauss(rng, 30, 30)
    tm, jm = METHODS[method]
    s = st.svd(st.Matrix(a, mb=8, **CPU), {st.Option.MethodSVD: tm},
               want_u=False, want_vh=False)
    js = jst.svd(jst.Matrix(a, mb=8), {jst.Option.MethodSVD: jm},
                 want_u=False, want_vh=False)
    assert s.U is None and s.Vh is None
    np.testing.assert_allclose(_np(s.s), np.asarray(js.s), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(_np(s.s), np.linalg.svd(a, compute_uv=False),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(_np(st.svd_vals(st.Matrix(a, mb=8, **CPU))),
                               np.asarray(jst.svd_vals(jst.Matrix(a, mb=8))),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m,n,nb,cplx", [(24, 24, 8, False),
                                         (40, 24, 8, False),
                                         (32, 32, 8, True),
                                         (256, 256, 128, True)],
                         ids=["square", "tall", "complex",
                              "complex-square-panel"])
def test_ge2tb_matches_jax(rng, m, n, nb, cplx):
    """Stage 1: the band and both transforms equal the JAX package's to
    f64 rounding (1e-12 of the scale). At 256 x 256 with nb = 128 the
    last QR and LQ panels are square 128 x 128 complex blocks, where the
    library geqrf on the CPU skips its last reflector's 1x1 step and the
    port applies it."""
    a = gauss(rng, m, n, cplx)
    F = st.ge2tb(st.Matrix(a, mb=nb, **CPU))
    JF = jst.ge2tb(jst.Matrix(a, mb=nb))
    assert (F.B.kl, F.B.ku, F.B.mtype.name) == (JF.B.kl, JF.B.ku,
                                                JF.B.mtype.name)
    scale = np.abs(a).max()
    for x, jx in ((F.B, JF.B), (F.U, JF.U), (F.Vh, JF.Vh)):
        np.testing.assert_allclose(x.to_numpy(), jx.to_numpy(),
                                   atol=1e-12 * scale)
    np.testing.assert_allclose(F.U.to_numpy() @ F.B.to_numpy()
                               @ F.Vh.to_numpy(), a, atol=1e-12 * scale)


def _carry_ge2tb(JF):
    return st.from_jax_state(
        {"B": np.asarray(JF.B.data), "U": np.asarray(JF.U.data),
         "Vh": np.asarray(JF.Vh.data)},
        {"B": _meta(JF.B), "U": _meta(JF.U), "Vh": _meta(JF.Vh)}, **CPU)


@pytest.mark.parametrize("n,nb,cplx", [(24, 8, False), (30, 16, False),
                                       (30, 6, True)],
                         ids=["band", "golub-kahan", "band-complex"])
def test_tb2bd_matches_jax(rng, n, nb, cplx):
    """Stage 2 on the JAX package's ge2tb result carried over: the
    windowed chase (2 <= kd <= n/3; complex included) and the dense
    Golub-Kahan loop (kd > n/3) give the JAX package's d, e, U and Vh
    (1e-10 of the scale: both run LAPACK QRs of the bulge blocks)."""
    a = gauss(rng, n, n, cplx)
    JF = jst.ge2tb(jst.Matrix(a, mb=nb))
    F = _carry_ge2tb(JF)
    assert isinstance(F, st.Ge2tbResult) and F.B.ku == JF.B.ku
    bd = st.tb2bd(F)
    jbd = jst.tb2bd(JF)
    scale = np.abs(a).max()
    for x, jx in ((bd.d, jbd.d), (bd.e, jbd.e)):
        np.testing.assert_allclose(_np(x), np.asarray(jx),
                                   atol=1e-10 * scale)
    for x, jx in ((bd.U, jbd.U), (bd.Vh, jbd.Vh)):
        np.testing.assert_allclose(x.to_numpy(), jx.to_numpy(), atol=1e-10)
    B2 = np.diag(_np(bd.d)) + np.diag(_np(bd.e), 1)
    np.testing.assert_allclose(bd.U.to_numpy() @ B2 @ bd.Vh.to_numpy(), a,
                               atol=1e-10 * scale)


def test_bdsqr_matches_jax_with_info(rng):
    """Stage 3 on the JAX package's bidiagonal carried over
    (BidiagResult through from_jax_state): the QR iteration with
    return_info, against the JAX package's bdsqr."""
    n = 24
    a = gauss(rng, n, n)
    jbd = jst.tb2bd(jst.ge2tb(jst.Matrix(a, mb=8)))
    bd = st.from_jax_state({"d": np.asarray(jbd.d), "e": np.asarray(jbd.e),
                            "U": np.asarray(jbd.U.data),
                            "Vh": np.asarray(jbd.Vh.data)},
                           {"kind": "bidiag", "U": _meta(jbd.U),
                            "Vh": _meta(jbd.Vh)}, **CPU)
    assert isinstance(bd, st.BidiagResult)
    res, info = st.bdsqr(bd, return_info=True)
    jres, jinfo = jst.bdsqr(jbd, return_info=True)
    assert int(info) == 0 == int(jinfo) and info.dtype == torch.int32
    check_svd(a, res.s, res.U, res.Vh, np.asarray(jres.s))
    same_pairs(res.U, res.Vh, jres.U.to_numpy(), jres.Vh.to_numpy(), V_TOL)


@pytest.mark.parametrize("n", [16, 60])
def test_bdsqr_qr_matches_jax(rng, n):
    """The bidiagonal QR iteration on a random bidiagonal: singular
    values, Gu diag(s) Gvh = B, Gu^T Gu = I (the reference test's
    tolerances) and the vectors against the JAX package's."""
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    s, Gu, Gvh, info = tsvd.bdsqr_qr(torch.as_tensor(d), torch.as_tensor(e))
    js, JGu, JGvh, jinfo = jsvd.bdsqr_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0 == int(jinfo)
    bid = np.diag(d) + np.diag(e, 1)
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(_np(Gu) @ np.diag(_np(s)) @ _np(Gvh), bid,
                               atol=1e-11)
    np.testing.assert_allclose(_np(Gu).T @ _np(Gu), np.eye(n), atol=1e-12)
    same_pairs(Gu, Gvh, np.asarray(JGu), np.asarray(JGvh), 1e-9)


def test_bdsqr_qr_clustered_deflation(rng):
    """Clustered singular values (the reference test's deflation
    stress): the same values as numpy and the JAX package."""
    n = 30
    d = np.repeat(rng.standard_normal(n // 3), 3)
    e = 1e-8 * rng.standard_normal(n - 1)
    s, Gu, Gvh, info = tsvd.bdsqr_qr(torch.as_tensor(d), torch.as_tensor(e))
    js, _, _, _ = jsvd.bdsqr_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0
    bid = np.diag(d) + np.diag(e, 1)
    np.testing.assert_allclose(_np(s), np.linalg.svd(bid, compute_uv=False),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(_np(Gu) @ np.diag(_np(s)) @ _np(Gvh), bid,
                               atol=1e-11)


def test_bdsqr_routed_chain_matches_cold(rng):
    """A cached ('bdsqr', 'chain') = 'pallas_rec' entry (chain block 16,
    so n = 64 passes the gate) routes both chains of every pass through
    the chain kernel's entry, the right one on Gvh^T (a transposed
    view): the same decomposition as the cold dense compose and the
    same singular values as the JAX package's routed run."""
    n = 64
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    td, te = torch.as_tensor(d), torch.as_tensor(e)
    s0, Gu0, Gvh0, _ = tsvd.bdsqr_qr(td, te)
    for cache, dt in ((tcache, torch.float64), (jcache, np.float64)):
        cache.get_cache().put("bdsqr", dt, n, {"chain": "pallas_rec"})
        cache.get_cache().put("steqr2", None, None, {"chain_blk": 16})
    assert tsvd._select_chain_apply("bdsqr", n, n, torch.float64) is not None
    s1, Gu1, Gvh1, info = tsvd.bdsqr_qr(td, te)
    js, _, _, _ = jsvd.bdsqr_qr(jnp.asarray(d), jnp.asarray(e))
    assert int(info) == 0
    np.testing.assert_allclose(_np(s1), _np(s0), atol=1e-12)
    np.testing.assert_allclose(_np(Gu1), _np(Gu0), atol=1e-11)
    np.testing.assert_allclose(_np(Gvh1), _np(Gvh0), atol=1e-11)
    np.testing.assert_allclose(_np(s1), np.asarray(js), rtol=1e-10,
                               atol=1e-12)


def _one_pass_loop(d, e, maxit_factor=12, route=None):
    """bdsqr_qr as one bdsqr_sweep pass a loop iteration, the count read
    after each: the loop the multi-pass launches replace. Returns
    (s, Gu, Gvh, info, passes)."""
    n, dt = d.shape[0], d.dtype
    Gu, Gvh = torch.eye(n, dtype=dt), torch.eye(n, dtype=dt)
    cnt, it = pk.unconverged(d, e, 20 * torch.finfo(dt).eps), 0
    while int(cnt) > 0 and it < maxit_factor * n:
        d, e, cr, sr, cl, sl, cnt = pk.bdsqr_sweep(d, e)
        if route is not None:
            Gu = route(Gu, cl, sl)
            Gvh = route(Gvh.T, cr, sr).T
        else:
            Gu = Gu @ tsvd._givens_chain_matrix(cl, sl, n, dt)
            Gvh = tsvd._givens_chain_matrix(cr, sr, n, dt).T @ Gvh
        it += 1
    sgn = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    order = torch.argsort(-d.abs(), stable=True)
    return (d.abs()[order], (Gu * sgn[None, :])[:, order], Gvh[order, :],
            cnt, it)


def _route_bdsqr_chain(n):
    """A cached ('bdsqr', 'chain') = 'pallas_rec' route in both packages
    (chain block 16, so n = 64 passes the gate); returns the port's
    applier."""
    for cache, dt in ((tcache, torch.float64), (jcache, np.float64)):
        cache.get_cache().put("bdsqr", dt, n, {"chain": "pallas_rec"})
        cache.get_cache().put("steqr2", None, None, {"chain_blk": 16})
    route = tsvd._select_chain_apply("bdsqr", n, n, torch.float64)
    assert route is not None
    return route


@pytest.mark.parametrize("n,dtype,passes_per_launch,routed", [
    (16, torch.float64, 32, False), (64, torch.float64, 32, False),
    (64, torch.float64, 5, False), (64, torch.float64, 32, True),
    (64, torch.float32, 32, False)])
def test_bdsqr_qr_multi_pass_equals_one_pass_loop(rng, n, dtype,
                                                  passes_per_launch, routed,
                                                  monkeypatch):
    """The passes in multi-pass launches (every launch's two chains
    applied in pass order after it), on the cold dense compose and on
    the routed chain, give s, Gu, Gvh and info bitwise the one-pass
    loop's; bdsqr_qr.passes counts that loop's passes; and (f64) the
    values and vectors match the JAX package's bdsqr_qr within
    test_bdsqr_qr_matches_jax's tolerances."""
    monkeypatch.setattr(pk, "BDSQR_PASSES_PER_LAUNCH", passes_per_launch)
    d0, e0 = rng.standard_normal(n), rng.standard_normal(n - 1)
    d = torch.as_tensor(d0).to(dtype)
    e = torch.as_tensor(e0).to(dtype)
    route = _route_bdsqr_chain(n) if routed else None
    s0, Gu0, Gvh0, info0, it = _one_pass_loop(d, e, route=route)
    tsvd.bdsqr_qr.passes = 0
    s, Gu, Gvh, info = tsvd.bdsqr_qr(d, e)
    assert torch.equal(s, s0) and torch.equal(Gu, Gu0) \
        and torch.equal(Gvh, Gvh0)
    assert int(info) == int(info0) == 0 and info.dtype == torch.int32
    assert tsvd.bdsqr_qr.passes == it > passes_per_launch
    if dtype == torch.float64:
        js, JGu, JGvh, _ = jsvd.bdsqr_qr(jnp.asarray(d0), jnp.asarray(e0))
        np.testing.assert_allclose(_np(s), np.asarray(js), rtol=1e-10,
                                   atol=1e-12)
        same_pairs(Gu, Gvh, np.asarray(JGu), np.asarray(JGvh), 1e-9)


@pytest.mark.parametrize("maxit_factor,passes_per_launch", [
    (12, 32), (12, 7), (1, 32), (1, 5), (0, 32)])
def test_bdsqr_qr_launch_sizes(rng, maxit_factor, passes_per_launch,
                               monkeypatch):
    """Each launch is given min(BDSQR_PASSES_PER_LAUNCH, what is left of
    the cap maxit_factor * n); the loop stops after a launch that ends
    at a count of 0 or at the cap, where info is the count left (the
    one-pass loop's), and bdsqr_qr.passes counts the passes run. n = 24:
    more than 24 passes, so a factor of 1 stops at the cap."""
    monkeypatch.setattr(pk, "BDSQR_PASSES_PER_LAUNCH", passes_per_launch)
    n = 24
    d = torch.as_tensor(rng.standard_normal(n))
    e = torch.as_tensor(rng.standard_normal(n - 1))
    asked, ran = [], []
    real = pk.bdsqr_sweeps

    def spy(d, e, k):
        out = real(d, e, k)
        asked.append(k)
        ran.append(out[-1].tolist())
        return out

    monkeypatch.setattr(pk, "bdsqr_sweeps", spy)
    tsvd.bdsqr_qr.passes = 0
    s, Gu, Gvh, info = tsvd.bdsqr_qr(d, e, maxit_factor=maxit_factor)
    s0, Gu0, Gvh0, info0, it = _one_pass_loop(d, e, maxit_factor)
    assert torch.equal(s, s0) and torch.equal(Gu, Gu0) \
        and torch.equal(Gvh, Gvh0)
    assert int(info) == int(info0)
    cap, done = maxit_factor * n, 0
    for k, (p, count) in zip(asked, ran):
        assert k == min(passes_per_launch, cap - done)
        assert p == k or count == 0
        done += p
    assert done == it == tsvd.bdsqr_qr.passes and ran[-1][1] == int(info)
    assert (int(info) > 0) == (done == cap)


def test_bdsqr_large_or_complex_takes_library(rng):
    """Past BDSQR_QR_MAX_N (or on complex d) bdsqr warns and takes the
    library SVD of the bidiagonal, info 0, as the reference."""
    n = 6
    d = torch.as_tensor(rng.standard_normal(n) + 0j)
    e = torch.as_tensor(rng.standard_normal(n - 1) + 0j)
    with pytest.warns(UserWarning, match="BDSQR_QR_MAX_N"):
        res, info = st.bdsqr(st.BidiagResult(d, e, None, None),
                             return_info=True)
    bid = np.diag(d.numpy()) + np.diag(e.numpy(), 1)
    np.testing.assert_allclose(_np(res.s), np.linalg.svd(bid,
                                                         compute_uv=False),
                               rtol=1e-12)
    assert int(info) == 0


def test_unmbr_applies_the_transforms(rng):
    """unmbr_ge2tb / unmbr_tb2bd: one product with the accumulated
    factor, on either side, as the JAX package."""
    a = gauss(rng, 24, 24)
    c = gauss(rng, 24, 24)
    F = st.ge2tb(st.Matrix(a, mb=8, **CPU))
    JF = jst.ge2tb(jst.Matrix(a, mb=8))
    C, JC = st.Matrix(c, mb=8, **CPU), jst.Matrix(c, mb=8)
    for left in (True, False):
        np.testing.assert_allclose(
            st.unmbr_ge2tb(F.U, F.Vh, C, side_left=left).to_numpy(),
            jst.unmbr_ge2tb(JF.U, JF.Vh, JC, side_left=left).to_numpy(),
            atol=1e-12 * np.abs(c).max() * 24)
        np.testing.assert_allclose(
            st.unmbr_tb2bd(F.U, F.Vh, C, side_left=left).to_numpy(),
            st.unmbr_ge2tb(F.U, F.Vh, C, side_left=left).to_numpy())

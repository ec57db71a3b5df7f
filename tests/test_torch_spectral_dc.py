"""slate_tpu_torch's spectral divide & conquer eigensolver
(linalg/polar.py, linalg/spectral_dc.py) against the JAX package on the
CPU.

The same seeded numpy inputs go through both packages. The scalar
schedule is held to 2 f32 ulps (its cube root evaluated as XLA does;
sqrt and fused multiply-adds may part in the last ulp), one Halley step to the dtype's rounding, the polar
iteration to its iteration count, flag and factor, and the eigensolver
to its flag, spectrum and vectors. The cases include the four fixes of
the reference's polar.py (the interval-minimum lift, the converged
power iteration, the iteration folded into the estimator's key, the
AND of every split's flag) and an even-sized split whose two middle
diagonal entries differ (the median is their average)."""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.linalg import polar as jpolar
from slate_tpu.linalg import spectral_dc as jsdc

from slate_tpu_torch.linalg import polar as tpolar
from slate_tpu_torch.linalg import spectral_dc as tsdc
from slate_tpu_torch.obs import events as obs_events
from slate_tpu_torch.obs import metrics as obs_metrics

#: the polar factor: the reference tests' limit (f32), f64 rounding
U_TOL = {np.float32: 5e-5, np.complex64: 5e-5, np.float64: 1e-12}
#: one Halley step: f32 / f64 rounding of two triangular solves with a
#: mild weight (c ~ 10)
STEP_TOL = {np.float32: 1e-6, np.float64: 1e-13}
#: eigenvalues relative to ||H||_2
W_TOL = {np.float32: 1e-4, np.float64: 1e-10}
#: residual ||H V - V diag(w)||_F / ||H||_F and max |V^T V - I| (f32)
RES_TOL = 1e-5


def ulps_apart(x, y):
    x, y = np.float32(x), np.float32(y)
    return abs(float(x) - float(y)) / float(np.spacing(np.abs(y)))


def ref_start_block(n, it):
    """The reference's estimator draw: fold_in(PRNGKey(7), it)."""
    key = jax.random.fold_in(jax.random.PRNGKey(7),
                             jnp.asarray(it, jnp.int32))
    return np.asarray(jax.random.normal(key, (n, 3), jnp.float32))


def gaussian_unit(rng, n, dtype):
    x = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal((n, n))
    return (x / np.linalg.norm(x, 2)).astype(dtype)


# -- the scalar schedule ------------------------------------------------------

@pytest.mark.parametrize("l", (1e-8, 1e-6, 1e-4, 1e-2, 0.1))
def test_capped_params_and_lift_match_reference(l):
    """_capped_params and _lift_estimate on the reference's l x sg grid
    (tests/test_tune.py::test_polar_lift_is_interval_minimum), within 2
    f32 ulps, and the lift is the interval minimum in the port too."""
    for c_max in (tpolar.C_MAX_F32, tpolar.C_MAX_F64):
        ja = jpolar._capped_params(jnp.float32(l), c_max)
        ta = tpolar._capped_params(np.float32(l), c_max)
        for j, t in zip(ja, ta):
            assert isinstance(t, np.float32)
            assert ulps_apart(t, np.asarray(j)) <= 2, (l, c_max)
    a, b, c, _ = tpolar._capped_params(np.float32(l), tpolar.C_MAX_F32)
    ja, jb, jc, _ = jpolar._capped_params(jnp.float32(l),
                                          tpolar.C_MAX_F32)
    for sg in (1e-5, 1e-3, 0.05, 0.11, 0.3, 0.8):
        lest = tpolar._lift_estimate(np.float32(sg), a, b, c)
        jlest = jpolar._lift_estimate(jnp.float32(sg), ja, jb, jc)
        assert ulps_apart(lest, np.asarray(jlest)) <= 2, (l, sg)
        xs = np.linspace(sg, 1.0, 20001)
        f = xs * (float(a) + float(b) * xs ** 2) / (1 + float(c) * xs ** 2)
        assert float(lest) <= f.min() + 1e-7


# -- one Halley step ----------------------------------------------------------

@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_halley_step_matches_reference(dtype):
    rng = np.random.default_rng(11)
    u = gaussian_unit(rng, 40, dtype)
    a, b, c, _ = tpolar._capped_params(np.float32(0.3), tpolar.C_MAX_F32)
    ref = np.asarray(jpolar._chol_halley_step(
        jnp.asarray(u), jnp.float32(a), jnp.float32(b), jnp.float32(c)))
    got = tpolar._chol_halley_step(torch.as_tensor(u), a, b, c).numpy()
    assert np.abs(got - ref).max() <= STEP_TOL[dtype]


@pytest.mark.parametrize("it", (0, 1))
def test_halley_step_estimator_with_reference_draw(it):
    """With the reference's start block (start_block=), the estimate
    agrees to 1e-5 and the reliability flag exactly; the two draws of
    the estimator-key case (it = 0, 1) stay finite and nonnegative, as
    the reference's test requires."""
    rng = np.random.default_rng(3)
    n = 32
    x = rng.standard_normal((n, n)).astype(np.float32)
    u = x / np.linalg.norm(x, 2)
    a, b, c = np.float32(3.0), np.float32(1.0), np.float32(3.0)
    ju, jsig, jrel = jpolar._chol_halley_step(
        jnp.asarray(u), jnp.float32(a), jnp.float32(b), jnp.float32(c),
        want_sigma_est=True, it=it)
    tu, tsig, trel = tpolar._chol_halley_step(
        torch.as_tensor(u), a, b, c, want_sigma_est=True, it=it,
        start_block=torch.tensor(ref_start_block(n, it)))
    assert abs(float(tsig) - float(jsig)) <= 1e-5
    assert bool(trel) == bool(jrel)
    assert np.abs(tu.numpy() - np.asarray(ju)).max() <= 1e-6
    # the port's own draw (seeded from 7 and it) gives a sane estimate
    _, sig_own, _ = tpolar._chol_halley_step(
        torch.as_tensor(u), a, b, c, want_sigma_est=True, it=it)
    assert np.isfinite(float(sig_own)) and float(sig_own) >= 0
    assert tsig.dtype == torch.float32 and trel.dtype == torch.bool


def test_start_block_depends_on_iteration():
    b0, b1 = tpolar._start_block(32, 0), tpolar._start_block(32, 1)
    assert b0.shape == (32, 3) and not torch.equal(b0, b1)
    assert torch.equal(b0, tpolar._start_block(32, 0))


# -- the polar iteration ------------------------------------------------------

def advice_diagonal(case):
    n = 48
    if case == "dip":
        d = np.linspace(0.5, 1.0, n).astype(np.float32)
        d[0], d[1] = 0.12, -0.12
    else:
        d = np.full(n, 1e-4, np.float32)
        d[n // 2:] = 1.0
        d[::2] *= -1.0
    return d


def assert_polar_matches(x, dtype):
    ju, jk, jconv = jpolar.polar_unitary(jnp.asarray(x))
    tu, tk, tconv = tpolar.polar_unitary(torch.as_tensor(x), device="cpu")
    assert tconv == bool(jconv) and tk == int(jk)
    assert np.abs(tu.numpy() - np.asarray(ju)).max() <= U_TOL[dtype]
    return tu.numpy(), tk, tconv


@pytest.mark.parametrize("case", ("dip", "clustered"))
def test_polar_advice_diagonals(case):
    """The two ADVICE cases: a singular value at the capped-weight dip
    (the interval-minimum lift) and clustered tiny ones (the converged
    power iteration); both converge to diag(sign(d)) within 5e-5."""
    d = advice_diagonal(case)
    u, k, conv = assert_polar_matches(np.diag(d), np.float32)
    assert conv and k <= 14
    assert np.abs(u - np.diag(np.sign(d))).max() < 5e-5
    assert np.abs(u @ u.T - np.eye(len(d))).max() < 5e-5


def test_polar_estimator_key_case():
    """The reference's estimator-key matrix through the whole iteration."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 32)).astype(np.float32)
    assert_polar_matches(x / np.linalg.norm(x, 2), np.float32)


@pytest.mark.parametrize("dtype", (np.float32, np.float64, np.complex64))
def test_polar_gaussian(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((56, 56))
    if dtype is np.complex64:
        x = x + 1j * rng.standard_normal((56, 56))
    u, _k, conv = assert_polar_matches(x.astype(dtype), dtype)
    assert conv
    eye = np.eye(56)
    assert np.abs(u.conj().T @ u - eye).max() <= 10 * U_TOL[dtype]


def test_sign_hermitian_is_hermitian():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 40))
    h = (x + x.T) / 2
    s, k, conv = tpolar.sign_hermitian(torch.as_tensor(h), device="cpu")
    js, jk, jconv = jpolar.sign_hermitian(jnp.asarray(h))
    assert torch.equal(s, s.mT) and conv == bool(jconv) and k == int(jk)
    assert np.abs(s.numpy() - np.asarray(js)).max() <= 1e-12


# -- one split ----------------------------------------------------------------

def test_split_even_size_median_averages():
    """An even-sized block whose two middle diagonal entries differ
    (-1 and 1): sigma is their average (jnp.nanmedian), k and the
    lower-subspace projector agree with the reference."""
    rng = np.random.default_rng(21)
    m = 64
    d = np.concatenate([np.linspace(-3.0, -1.0, m // 2),
                        np.linspace(1.0, 3.0, m // 2)])
    rng.shuffle(d)
    g = rng.standard_normal((m, m))
    h = (np.diag(d) + 0.02 * (g + g.T)).astype(np.float32)
    jsigma = float(jnp.nanmedian(jnp.real(jnp.diagonal(jnp.asarray(h)))))
    tsigma = float(tsdc._median(torch.diagonal(torch.as_tensor(h))))
    assert tsigma == jsigma
    assert abs(tsigma - float(np.median(np.diag(h)))) < 1e-6
    ref = jsdc._split_spectrum(jnp.asarray(h), m, None)
    spl = tsdc._split_spectrum(torch.as_tensor(h))
    k = int(ref.k)
    assert spl.k == k == m // 2 and spl.ok == bool(ref.ok)
    q_ref = np.asarray(ref.Q)[:, :k]
    q = spl.Q.numpy()[:, :k]
    assert np.abs(q @ q.T - q_ref @ q_ref.T).max() <= 1e-4
    # W is block diagonal to the split tolerance
    w = spl.W.numpy()
    assert np.abs(w[k:, :k]).max() <= 1e-4 * np.abs(h).max()


# -- the eigensolver ----------------------------------------------------------

def gapped_symmetric(n, dtype, seed=31):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-1.0, 1.0, n)
    rng.shuffle(lam)
    h = (q * lam) @ q.T
    return ((h + h.T) / 2).astype(dtype)


#: (n, leaf) cases: several levels, and n <= leaf (the library solve)
DC_CASES = ((192, 48), (40, 48))


@pytest.fixture(scope="module")
def dc_ref():
    """Each reference eigh_dc shape run once."""
    out = {}
    for n, leaf in DC_CASES:
        for dtype in (np.float32, np.float64):
            h = gapped_symmetric(n, dtype)
            w, v, ok = jsdc.eigh_dc(jnp.asarray(h), leaf=leaf)
            out[n, leaf, dtype] = (h, np.asarray(w), np.asarray(v),
                                   bool(ok))
    return out


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
@pytest.mark.parametrize("n,leaf", DC_CASES)
def test_eigh_dc_matches_reference(dc_ref, n, leaf, dtype):
    h, w_ref, v_ref, ok_ref = dc_ref[n, leaf, dtype]
    stats = {}
    w, v, ok = tsdc.eigh_dc(torch.as_tensor(h), leaf=leaf, device="cpu",
                            stats=stats)
    w, v = w.numpy(), v.numpy()
    assert ok == ok_ref and ok is True
    h64 = h.astype(np.float64)
    hn2 = np.linalg.norm(h64, 2)
    assert np.all(np.diff(w) >= 0)
    assert np.abs(w - w_ref).max() <= W_TOL[dtype] * hn2
    assert np.abs(w - np.linalg.eigvalsh(h64)).max() <= W_TOL[dtype] * hn2
    assert np.abs(np.diag(v.T @ v_ref)).min() >= 1 - 1e-3
    res = np.linalg.norm(h64 @ v - v * w) / np.linalg.norm(h64)
    orth = np.abs(v.T.astype(np.float64) @ v - np.eye(n)).max()
    tol = RES_TOL if dtype is np.float32 else 1e-12
    assert res <= tol and orth <= tol
    if n > leaf:
        assert stats["splits"] >= 3 and stats["leaves"] >= 4
        assert stats["polar_iterations"] >= stats["splits"]
        assert stats["host_reads"] > stats["polar_iterations"]
    else:
        assert stats == {"leaves": 1}


def test_eigh_dc_diagonal_root():
    """A diagonal input takes the root's near-diagonal branch: its
    diagonal sorted (stably), the identity's columns; no split."""
    d = np.array([3.0, -1.0, 2.0, 0.5] * 48, np.float64)
    stats = {}
    w, v, ok = tsdc.eigh_dc(torch.as_tensor(np.diag(d)), leaf=48,
                            device="cpu", stats=stats)
    jw, jv, jok = jsdc.eigh_dc(jnp.asarray(np.diag(d)), leaf=48)
    assert ok and bool(jok)
    assert np.array_equal(w.numpy(), np.asarray(jw))
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert "splits" not in stats


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_eigh_dc_below_the_reference_ladder(dtype):
    """n = 80 with leaf 16: the reference's bucket ladder rounds its
    first bucket up to 128, past the (2n, n) workspace, and raises; the
    port runs each subproblem at its true size (ROADMAP queue 3)."""
    h = gapped_symmetric(80, dtype, seed=41)
    with pytest.raises(TypeError, match="slice_sizes"):
        jsdc.eigh_dc(jnp.asarray(h), leaf=16)
    stats = {}
    w, v, ok = tsdc.eigh_dc(torch.as_tensor(h), leaf=16, device="cpu",
                            stats=stats)
    h64 = h.astype(np.float64)
    w, v = w.numpy(), v.numpy()
    assert ok and stats["splits"] >= 3
    assert np.abs(w - np.linalg.eigvalsh(h64)).max() <= W_TOL[dtype]
    tol = RES_TOL if dtype is np.float32 else 1e-12
    assert np.linalg.norm(h64 @ v - v * w) / np.linalg.norm(h64) <= tol
    assert np.abs(v.T.astype(np.float64) @ v - np.eye(80)).max() <= tol


# -- the opt-in polar check ---------------------------------------------------

def test_check_polar(monkeypatch):
    monkeypatch.delenv(tsdc.CHECK_POLAR_ENV, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tsdc.check_polar(False) is None     # off: nothing read
    monkeypatch.setenv(tsdc.CHECK_POLAR_ENV, "1")
    obs_metrics.reset()
    obs_events.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tsdc.check_polar(torch.tensor(True)) is True
        assert "polar.unconverged" not in \
            obs_metrics.snapshot()["counters"]
        with pytest.warns(UserWarning, match="polar \\(sign\\)"):
            assert tsdc.check_polar(False) is False
        assert obs_metrics.snapshot()["counters"]["polar.unconverged"] == 1
    finally:
        obs_events.disable()
        obs_metrics.reset()
        obs_events.clear()


# -- the library eigensolver's route ------------------------------------------

def test_library_eigh_route():
    """f32 on the card at order <= 512 goes to f64 (cuSOLVER's syevj,
    PyTorch's f32 route there, reaches ~1e-4 on an H100); everything
    else, and everything on the CPU, is one plain call."""
    from slate_tpu_torch.linalg.blocked import (SYEVJ_MAX_N, _syevj_route,
                                                library_eigh)
    assert _syevj_route("cuda", torch.float32, 256)
    assert _syevj_route("cuda", torch.float32, 32)
    assert _syevj_route("cuda", torch.float32, SYEVJ_MAX_N)
    assert not _syevj_route("cuda", torch.float32, SYEVJ_MAX_N + 1)
    assert not _syevj_route("cuda", torch.float64, 256)
    assert not _syevj_route("cuda", torch.complex64, 256)
    assert not _syevj_route("cpu", torch.float32, 256)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 40, 40)).astype(np.float32)
    a = torch.as_tensor(x + x.transpose(0, 2, 1))
    w, v = library_eigh(a)
    w0, v0 = torch.linalg.eigh(a)
    assert torch.equal(w, w0) and torch.equal(v, v0)
    assert torch.equal(library_eigh(a, eigenvectors=False),
                       torch.linalg.eigvalsh(a))

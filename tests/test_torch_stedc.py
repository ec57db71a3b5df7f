"""slate_tpu_torch's divide & conquer tridiagonal eigensolver
(linalg/stedc.py) against the JAX package on the CPU, phase by phase as
tests/test_stedc.py drives the reference: the solve (padded and
unpadded, decoupled, clustered, tiny-scale), the deflation and its
rotations, the secular solve for both signs of rho, and the driver
with a back-transform.

The same seeded numpy inputs go through both packages in f64, with the
reference tests' tolerances; eigenvalues against the JAX package's,
eigenvectors through the residual T V = V diag(w) and V^T V = I, and
column by column against the JAX package's where the gaps allow. The
f32 case (30 bisections and 8 Newton passes, the reference's
schedule) is held to f32 tolerances."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import importlib

import slate_tpu as jst
import slate_tpu_torch as st

# both packages re-export the stedc FUNCTION under the module's name
jsd = importlib.import_module("slate_tpu.linalg.stedc")
tsd = importlib.import_module("slate_tpu_torch.linalg.stedc")

CPU = {"device": "cpu"}


def tri(d, e):
    return np.diag(d) + np.diag(e, -1) + np.diag(e, 1)


def T(x):
    return torch.as_tensor(np.asarray(x))


def check(d, e, w, v, wref, res=1e-9, orth=1e-8):
    """Eigenvalues against wref (rtol 1e-9, the reference's), the
    residual and orthogonality."""
    t = tri(d, e)
    w, v = np.asarray(w), np.asarray(v)
    np.testing.assert_allclose(w, wref, rtol=1e-9, atol=1e-10)
    assert np.abs(t @ v - v * w[None, :]).max() < res
    assert np.abs(v.T @ v - np.eye(len(d))).max() < orth


def same_columns(v, ref, tol):
    for j in range(ref.shape[1]):
        k = int(np.argmax(np.abs(ref[:, j])))
        sgn = np.sign(v[k, j] * ref[k, j])
        np.testing.assert_allclose(v[:, j], sgn * ref[:, j], atol=tol)


@pytest.mark.parametrize("n", [16, 64, 100])
def test_stedc_solve_matches_jax(rng, n):
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, v = tsd.stedc_solve(T(d), T(e))
    jw, jv = jsd.stedc_solve(jnp.asarray(d), jnp.asarray(e))
    check(d, e, w.numpy(), v.numpy(), np.asarray(jw))
    same_columns(v.numpy(), np.asarray(jv), 1e-8)


@pytest.mark.parametrize("n", [100, 129])
def test_stedc_solve_padded_driver(rng, n):
    """Non-power-of-two n through the sentinel-padded level driver (leaf
    16): the sentinels must not leak."""
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, v = tsd.stedc_solve(T(d), T(e), leaf=16)
    jw, _ = jsd.stedc_solve(jnp.asarray(d), jnp.asarray(e), leaf=16)
    assert tuple(v.shape) == (n, n)
    check(d, e, w.numpy(), v.numpy(), np.asarray(jw), res=1e-8)
    dp, ep, N, nl = tsd.stedc_split(T(d), T(e), 16)
    jdp, jep, jN, jnl = jsd.stedc_split(jnp.asarray(d), jnp.asarray(e), 16)
    assert (N, nl) == (jN, jnl)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(jdp))
    np.testing.assert_array_equal(ep.numpy(), np.asarray(jep))


def test_stedc_deflation_path(rng):
    """A decoupled problem (rho = 0 exactly at the split)."""
    n = 32
    d = np.sort(rng.standard_normal(n))
    e = rng.standard_normal(n - 1) * 0.1
    e[n // 2 - 1] = 0.0
    w, v = tsd.stedc_solve(T(d), T(e))
    check(d, e, w.numpy(), v.numpy(), np.linalg.eigvalsh(tri(d, e)))


def test_merge_decoupled_above_leaf(rng):
    """rho == 0 at the split with n > leaf: the merge returns the
    concatenated sub-results exactly."""
    n = 64
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    e[n // 2 - 1] = 0.0
    w, v = tsd.stedc_solve(T(d), T(e))
    jw, _ = jsd.stedc_solve(jnp.asarray(d), jnp.asarray(e))
    check(d, e, w.numpy(), v.numpy(), np.asarray(jw))


def test_stedc_clustered_eigenvalues(rng):
    """Near-tied poles exercise the Givens tie-rotation deflation."""
    n = 60
    d = np.repeat(np.sort(rng.standard_normal(n // 4)), 4)
    e = np.full(n - 1, 1e-12)
    w, v = tsd.stedc_solve(T(d), T(e))
    jw, _ = jsd.stedc_solve(jnp.asarray(d), jnp.asarray(e))
    check(d, e, w.numpy(), v.numpy(), np.asarray(jw))


def test_stedc_solve_scale_invariant(rng):
    """A 1e-10-scale matrix keeps relative accuracy (the sentinels scale
    with the spectrum)."""
    n = 70
    d = rng.standard_normal(n) * 1e-10
    e = rng.standard_normal(n - 1) * 1e-10
    w, v = tsd.stedc_solve(T(d), T(e), leaf=16)
    wn = np.linalg.eigvalsh(tri(d, e))
    np.testing.assert_allclose(w.numpy(), wn, rtol=1e-9,
                               atol=1e-12 * np.abs(wn).max())
    vn = v.numpy()
    assert np.abs(tri(d, e) @ vn - vn * w.numpy()[None, :]).max() \
        < 1e-8 * np.abs(wn).max()


@pytest.mark.parametrize("rho", [0.7, -0.6])
def test_secular_matches_jax(rng, rho):
    """Deflation and the secular solve of diag(D) + rho z z^T (both signs
    of rho: the origin selection of each branch): the deflation record
    equals the JAX package's, the roots and eigenvectors match it, and
    with the recorded rotations they diagonalize M."""
    n = 24
    D = np.sort(rng.standard_normal(n))
    z = rng.standard_normal(n) / np.sqrt(n)
    defl = st.stedc_deflate(T(D), T(z), rho)
    jdefl = jst.stedc_deflate(jnp.asarray(D), jnp.asarray(z), rho)
    for a, b in zip(defl, jdefl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15)
    lam, U = st.stedc_secular(defl.d, defl.z, rho, defl.keep)
    jlam, jU = jst.stedc_secular(jdefl.d, jdefl.z, rho, jdefl.keep)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), atol=1e-10)
    M = np.diag(D) + rho * np.outer(z, z)
    np.testing.assert_allclose(np.sort(lam.numpy()), np.linalg.eigvalsh(M),
                               rtol=1e-8, atol=1e-9)
    V = st.stedc_rotate(torch.eye(n, dtype=torch.float64), defl).numpy() \
        @ U.numpy()
    assert np.abs(M @ V - V * lam.numpy()[None, :]).max() < 1e-10
    assert np.abs(V.T @ V - np.eye(n)).max() < 1e-10


def _clustered_deflation(rng, n):
    D = np.sort(np.repeat(rng.standard_normal(n // 4), 4)
                + 1e-14 * rng.standard_normal(n))
    z = rng.standard_normal(n) / np.sqrt(n)
    z[::5] = 1e-18
    return D, z


@pytest.mark.parametrize("rho", [0.9, -0.8, 0.0])
def test_rotation_matrix_matches_jax(rng, rho):
    """Heavy deflation (clustered poles, tiny z): the port's fused
    deflation + rotation scan, its separate rotation matrix and
    stedc_rotate against the JAX package's column-at-a-time rotation
    loop and its fused scan."""
    n = 40
    D, z = _clustered_deflation(rng, n)
    defl, G = tsd._deflate_rotation_fused(T(D), T(z), rho)
    jdefl, JG = jsd._deflate_rotation_fused(jnp.asarray(D), jnp.asarray(z),
                                            rho)
    for a, b in zip(defl, jdefl):
        # flags, partners and rotations exactly; the rotated poles to an
        # ulp (XLA fuses d c^2 + d s^2 into multiply-adds)
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                       atol=1e-300)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(G.numpy(), np.asarray(JG), atol=1e-15)
    np.testing.assert_array_equal(tsd.stedc_rotation_matrix(defl).numpy(),
                                  G.numpy())
    Q = rng.standard_normal((n, n))
    ref = np.asarray(jsd._stedc_rotate_cols(jnp.asarray(Q), jdefl))
    np.testing.assert_allclose(st.stedc_rotate(T(Q), defl).numpy(), ref,
                               rtol=1e-12, atol=1e-13)


def test_merge_batched_matches_each_pair(rng):
    """The level merge over a leading batch (the reference's vmap)
    equals merging each pair on its own; sort and z-vector phases
    against the JAX package's."""
    leaf = 8
    pairs = []
    for _ in range(3):
        d1, e1 = rng.standard_normal(leaf), rng.standard_normal(leaf - 1)
        d2, e2 = rng.standard_normal(leaf), rng.standard_normal(leaf - 1)
        w1, v1 = np.linalg.eigh(tri(d1, e1))
        w2, v2 = np.linalg.eigh(tri(d2, e2))
        pairs.append((w1, v1, w2, v2, rng.standard_normal()))
    stack = [T(np.stack([p[i] for p in pairs])) for i in range(5)]
    w, V = st.stedc_merge(*stack)
    for b, (w1, v1, w2, v2, rho) in enumerate(pairs):
        wb, Vb = st.stedc_merge(T(w1), T(v1), T(w2), T(v2), rho)
        np.testing.assert_allclose(w[b].numpy(), wb.numpy(), atol=1e-13)
        np.testing.assert_allclose(V[b].numpy(), Vb.numpy(), atol=1e-12)
        jw, jV = jst.stedc_merge(jnp.asarray(w1), jnp.asarray(v1),
                                 jnp.asarray(w2), jnp.asarray(v2), rho)
        np.testing.assert_allclose(wb.numpy(), np.asarray(jw), rtol=1e-12,
                                   atol=1e-13)
        same_columns(Vb.numpy(), np.asarray(jV), 1e-9)
    z = st.stedc_z_vector(T(pairs[0][1]), T(pairs[0][3]))
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jst.stedc_z_vector(jnp.asarray(pairs[0][1]),
                                                 jnp.asarray(pairs[0][3]))))
    Ds, zs, perm = st.stedc_sort(T(np.concatenate([pairs[0][0],
                                                   pairs[0][2]])), z)
    jDs, jzs, jperm = jst.stedc_sort(
        jnp.asarray(np.concatenate([pairs[0][0], pairs[0][2]])),
        jnp.asarray(z.numpy()))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(Ds.numpy(), np.asarray(jDs))
    np.testing.assert_array_equal(zs.numpy(), np.asarray(jzs))


def test_stedc_f32_schedule(rng):
    """f32: 30 bisections then 8 safeguarded Newton passes (the
    reference's f32 schedule), against the JAX package's f32 solve:
    eigenvalues to 1e-5 of the scale, residual and orthogonality to
    1e-4 (f32 rounding over a 128-point merge)."""
    n = 128
    d = rng.standard_normal(n).astype(np.float32)
    e = rng.standard_normal(n - 1).astype(np.float32)
    w, v = tsd.stedc_solve(T(d), T(e))
    jw, _ = jsd.stedc_solve(jnp.asarray(d), jnp.asarray(e))
    assert w.dtype == torch.float32
    t = tri(d.astype(np.float64), e.astype(np.float64))
    scale = np.abs(np.asarray(jw)).max()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5 * scale)
    vn = v.double().numpy()
    assert np.abs(t @ vn - vn * w.double().numpy()[None, :]).max() \
        < 1e-4 * scale
    assert np.abs(vn.T @ vn - np.eye(n)).max() < 1e-4


def test_stedc_with_backtransform(rng):
    """The driver with Q: he2hb -> hb2st -> stedc on a dense symmetric
    matrix, against the JAX package's pipeline."""
    n = 48
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=16, **CPU)
    Band, Q = st.he2hb(A)
    trd = st.hb2st(Band)
    w, V = st.stedc(trd.d, trd.e, st.unmtr_he2hb(Q, trd.Q))
    JBand, JQ = jst.he2hb(jst.HermitianMatrix(jst.Uplo.Lower, a, mb=16))
    jtrd = jst.hb2st(JBand)
    jw, _ = jst.stedc(jtrd.d, jtrd.e, jst.unmtr_he2hb(JQ, jtrd.Q))
    v = V.to_numpy()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-8,
                               atol=1e-9)
    assert np.abs(a @ v - v * w.numpy()[None, :]).max() < 1e-7


def test_steqr2_values_only_and_vectors(rng):
    """steqr2: values only (sterf), and the vector path."""
    n = 48
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    wn = np.linalg.eigvalsh(tri(d, e))
    w, v = st.steqr2(d, e, want_vectors=False, **CPU)
    assert v is None
    np.testing.assert_allclose(w.numpy(), wn, rtol=1e-9, atol=1e-9)
    w2, v2 = st.steqr2(d, e, **CPU)
    np.testing.assert_allclose(w2.numpy(), wn, rtol=1e-9, atol=1e-9)
    vn = v2.numpy()
    assert np.abs(tri(d, e) @ vn - vn * w2.numpy()[None, :]).max() < 1e-8

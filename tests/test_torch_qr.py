"""slate_tpu_torch's QR family (geqrf, unmqr, gelqf / unmlq, cholqr,
gels over QR, CholQR and TSQR, the tree QR of linalg/ca.py) against
the JAX package on the CPU.

The same seeded numpy inputs go through both packages. f32 and c64
panels take the library geqrf on both sides (LAPACK), so packed factors
and taus agree to f32 rounding of differently ordered sums. bf16 panels
take the column loop of reflections on both sides (the kernel's gate
rejects CPU tensors, as the reference's rejects off the TPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.enums import Side as JSide
from slate_tpu.core.methods import MethodFactor as JMethodFactor
from slate_tpu.core.methods import MethodGels as JMethodGels
from slate_tpu.linalg import ca as jca
from slate_tpu.linalg import qr as jqr
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.linalg import ca as tca
from slate_tpu_torch.linalg import qr as tqr
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import permuted_boosted_system
from slate_tpu_torch.tune import cache as tcache

NB = 128
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


def _mat(a, nb=NB):
    return st.Matrix(a, mb=nb, **CPU), jst.Matrix(a, mb=nb)


def _np(x):
    """numpy of a port tensor or a JAX array (bf16 as f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(x, ref, tol):
    x, ref = _np(x), _np(ref)
    assert np.abs(x - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


SHAPES = {"square": (384, 384, np.float32), "tall": (512, 200, np.float32),
          "wide": (200, 384, np.float32), "complex": (256, 256,
                                                      np.complex64)}


def _shape_input(kind):
    m, n, dt = SHAPES[kind]
    rng = np.random.default_rng(len(kind))
    a = rng.standard_normal((m, n))
    if dt == np.complex64:
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dt)


#: packed V\R and taus of f32 / c64 Householder QR from two LAPACK
#: builds, blocked differently: 1e-5 relative to the factor's scale
QR_TOL = 1e-5


@pytest.mark.parametrize("method", ["fused", "tiled"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_geqrf_matches_jax(kind, method):
    """Packed R (V below) and taus: the Fused route (one library geqrf)
    and the Tiled carry form (nb 128 panels)."""
    a = _shape_input(kind)
    o = {st.Option.MethodFactor: st.MethodFactor(method)}
    jo = {jst.Option.MethodFactor: JMethodFactor(method)}
    if method == "tiled":
        o[st.Option.BlockSize] = jo[jst.Option.BlockSize] = NB
    A, JA = _mat(a)
    F, JF = st.geqrf(A, o), jst.geqrf(JA, jo)
    assert F.QR.data.shape == JF.QR.data.shape
    assert F.taus.shape == JF.taus.shape
    packed, taus = _np(F.QR.data), _np(F.taus)
    jpacked, jtaus = _np(JF.QR.data), _np(JF.taus)
    if kind == "complex":
        # the last reflector of a square complex matrix acts on a 1x1
        # block: the port applies LAPACK's larfg step there where the
        # library skipped it, so R_nn is real, as jax's
        k = a.shape[0] - 1
        assert packed[k, k].imag == 0 and taus[k] != 0
    _close(packed, jpacked, QR_TOL)
    _close(taus, jtaus, QR_TOL)


def test_geqrf_carry_matches_jax_scan(monkeypatch):
    """Past its step cap (lowered to 2 on the JAX side only) the
    reference takes its fixed-shape step for 3 steps of 128; the port
    has no such form and runs its carry form with nb 128: the same
    factor."""
    monkeypatch.setattr(jqr, "QR_SCAN_THRESHOLD", 2)
    a = _shape_input("square")
    calls = []
    orig = tqr._geqrf_carry
    monkeypatch.setattr(tqr, "_geqrf_carry",
                        lambda x, nb, *r: calls.append(nb) or orig(x, nb, *r))
    o = {st.Option.MethodFactor: st.MethodFactor.Tiled,
         st.Option.BlockSize: NB}
    jo = {jst.Option.MethodFactor: JMethodFactor.Tiled,
          jst.Option.BlockSize: NB}
    A, JA = _mat(a)
    F, JF = st.geqrf(A, o), jst.geqrf(JA, jo)
    assert calls == [NB]
    _close(F.QR.data, JF.QR.data, QR_TOL)
    _close(F.taus, JF.taus, QR_TOL)


@pytest.fixture(scope="module")
def factors():
    """A tall f32 factor (Tiled, 3 panels) in both packages, once."""
    a = _shape_input("tall")
    o = {st.Option.MethodFactor: st.MethodFactor.Tiled,
         st.Option.BlockSize: 64}
    jo = {jst.Option.MethodFactor: JMethodFactor.Tiled,
          jst.Option.BlockSize: 64}
    A, JA = _mat(a, 64)
    return a, st.geqrf(A, o), jst.geqrf(JA, jo)


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("jax_scan", [False, True])
def test_unmqr_matches_jax(factors, side, trans, jax_scan, monkeypatch):
    """Q or Q^H from either side: the port's loop over the panels
    against the reference's loop and its fixed-shape step (forced by a
    threshold lowered on the JAX side only); the port applies the JAX
    factor (carried over) and its own."""
    if jax_scan:
        monkeypatch.setattr(jqr, "QR_SCAN_THRESHOLD", 1)
    a, F, JF = factors
    m = a.shape[0]
    c = np.random.default_rng(9).standard_normal(
        (m, 48) if side == "Left" else (48, m)).astype(np.float32)
    C, JC = _mat(c, 64)
    ref = jqr.unmqr(JSide[side], JF, JC, trans=trans).to_numpy()
    out = st.unmqr(st.Side[side], F, C, trans=trans).to_numpy()
    # an orthogonal apply of O(1) data: 1e-5 of the result's scale
    _close(out, ref, 1e-5)
    carried = st.from_jax_state(
        {"QR": np.asarray(JF.QR.data), "taus": np.asarray(JF.taus)},
        _meta(JF.QR), **CPU)
    _close(st.unmqr(st.Side[side], carried, C, trans=trans).to_numpy(),
           ref, 1e-5)


def _meta(M):
    return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
            "mtype": M.mtype.name, "uplo": M.uplo.name, "op": M.op.name,
            "diag": M.diag.name}


def test_unmqr_explicit_thin_q_matches_jax(factors):
    """An explicit thin (M, K) Q applies as the isometry on both sides
    (the reference's mesh-TSQR factors carry one)."""
    a, _, _ = factors
    q = np.linalg.qr(a.astype(np.float64))[0].astype(np.float32)
    c = np.random.default_rng(10).standard_normal(
        (a.shape[0], 8)).astype(np.float32)
    JF = jqr.QRFactors(jst.Matrix(a, mb=64), jnp.zeros(200, jnp.float32),
                       Q=jst.Matrix(q, mb=64))
    F = st.from_jax_state({"QR": np.asarray(JF.QR.data),
                           "taus": np.asarray(JF.taus),
                           "Q": np.asarray(JF.Q.data)},
                          dict(_meta(JF.QR), Q=_meta(JF.Q)), **CPU)
    for trans in (True, False):
        cc = c if trans else c[:200]
        ref = jqr.unmqr(JSide.Left, JF, jst.Matrix(cc, mb=64),
                        trans=trans).to_numpy()
        out = st.unmqr(st.Side.Left, F, st.Matrix(cc, mb=64, **CPU),
                       trans=trans).to_numpy()
        _close(out, ref, 1e-5)


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("trans", [False, True])
def test_gelqf_unmlq_matches_jax(side, trans):
    a = _shape_input("wide")
    A, JA = _mat(a)
    F, JF = st.gelqf(A), jst.gelqf(JA)
    _close(F.LQ.data, JF.LQ.data, QR_TOL)
    _close(F.taus, JF.taus, QR_TOL)
    n = a.shape[1]
    c = np.random.default_rng(11).standard_normal(
        (n, 16) if side == "Left" else (16, n)).astype(np.float32)
    C, JC = _mat(c)
    ref = jqr.unmlq(JSide[side], JF, JC, trans=trans).to_numpy()
    _close(st.unmlq(st.Side[side], F, C, trans=trans).to_numpy(), ref,
           1e-5)
    carried = st.from_jax_state({"LQ": np.asarray(JF.LQ.data),
                                 "taus": np.asarray(JF.taus)},
                                _meta(JF.LQ), **CPU)
    _close(st.unmlq(st.Side[side], carried, C, trans=trans).to_numpy(),
           ref, 1e-5)


def test_cholqr_matches_jax():
    a = _shape_input("tall")
    A, JA = _mat(a)
    (Q, R), (JQ, JR) = st.cholqr(A), jst.cholqr(JA)
    # R = chol(A^T A) and Q = A R^-1 of a cond ~ 4 matrix
    _close(R.to_dense(), JR.to_dense(), 1e-5)
    _close(Q.to_dense(), JQ.to_dense(), 1e-5)
    q = Q.to_numpy()
    assert np.abs(q.T @ q - np.eye(200)).max() <= 1e-4


@pytest.mark.parametrize("method", ["auto", "qr", "cholqr", "tsqr",
                                    "underdetermined"])
def test_gels_matches_jax(method):
    """Square (QR, CholQR, TSQR by option), tall through Auto (CholQR at
    m >= 3n), and underdetermined (the minimum-norm LQ route)."""
    rng = np.random.default_rng(12)
    if method == "auto":
        a = rng.standard_normal((768, 128)).astype(np.float32)
    elif method == "underdetermined":
        a = rng.standard_normal((200, 384)).astype(np.float32)
    else:
        a = permuted_boosted_system(rng, 384, 1)[0]
    b = rng.standard_normal((a.shape[0], 4)).astype(np.float32)
    o, jo = {}, {}
    if method not in ("auto", "underdetermined"):
        o[st.Option.MethodGels] = st.MethodGels(method)
        jo[jst.Option.MethodGels] = JMethodGels(method)
    A, JA = _mat(a)
    B, JB = _mat(b)
    x = st.gels(A, B, o).to_numpy()
    jx = jst.gels(JA, JB, jo).to_numpy()
    # the least-squares solution of a well-conditioned system: f32
    # forward errors of a few ulps times cond
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)
    ref = np.linalg.lstsq(a.astype(np.float64), b, rcond=None)[0]
    assert np.linalg.norm(x - ref) <= 1e-4 * np.linalg.norm(ref)


def test_tsqr_matches_jax():
    a = _shape_input("tall")
    q, r = tca.tsqr(torch.as_tensor(a), chunk=128)
    jq, jr = jca.tsqr(jnp.asarray(a), chunk=128)
    # both trees use LAPACK QR (the same sign convention)
    _close(r, jr, 1e-5)
    _close(q, jq, 1e-5)
    np.testing.assert_allclose(_np(q) @ _np(r), a, atol=1e-4)


# -- bf16: the column loop on both sides -------------------------------------

def test_qr_panel_fori_bf16_matches_jax():
    """The bf16 column loop of reflections: one panel of the reference's
    route off the TPU, the same loop in both packages. bf16 rounds at
    other places in XLA's fusions than in torch's per-op kernels, so the
    factors agree to a few bf16 ulps of their scale (2^-6)."""
    a = np.random.default_rng(13).standard_normal((256, 64)) \
        .astype(np.float32)
    p, t = tqr._qr_panel(torch.as_tensor(a).bfloat16())
    jp, jt = jqr._qr_panel(jnp.asarray(a).astype(jnp.bfloat16))
    assert p.dtype == torch.bfloat16 and t.dtype == torch.bfloat16
    _close(p, jp, 2.0 ** -6)
    _close(t, jt, 2.0 ** -6)


def test_gels_bf16_matches_jax():
    """bf16 gels (Tiled: nb 128 panels, each the column loop on both
    sides) on the permuted boosted system. Each X is held to the f32
    solution by the bound the reference itself meets on this system
    (0.0248 at n = 512 on the CPU; 0.05 here), and the two to each
    other by the same."""
    n = 256
    a, b = permuted_boosted_system(np.random.default_rng(14), n, 4)
    X = st.gels(st.Matrix(torch.as_tensor(a).bfloat16(), mb=64, **CPU),
                st.Matrix(torch.as_tensor(b).bfloat16(), mb=64, **CPU))
    JX = jst.gels(jst.Matrix(jnp.asarray(a).astype(jnp.bfloat16), mb=64),
                  jst.Matrix(jnp.asarray(b).astype(jnp.bfloat16), mb=64))
    assert X.dtype == torch.bfloat16
    x32 = np.linalg.solve(a.astype(np.float64), b)
    x, jx = _np(X.to_dense()), _np(JX.to_dense())
    for y in (x, jx):
        assert np.linalg.norm(y - x32) <= 0.05 * np.linalg.norm(x32)
    assert np.linalg.norm(x - jx) <= 0.05 * np.linalg.norm(jx)


def test_qr_panel_route(monkeypatch):
    """_qr_panel's order: the library geqrf for f32 (the kernel entry is
    never asked); bf16 on the CPU: the gate rejects, the column loop
    runs; with the gate forced open, the kernel entry (its plain version
    here) factors the panel."""
    a = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (256, 32)).astype(np.float32))
    calls = []
    orig = pk.qr_panel
    monkeypatch.setattr(pk, "qr_panel",
                        lambda x: calls.append(tuple(x.shape)) or orig(x))
    tqr._qr_panel(a)
    tqr._qr_panel(a.bfloat16())
    assert calls == []
    monkeypatch.setattr(pk, "qr_panel_eligible", lambda *x: True)
    p, t = tqr._qr_panel(a.bfloat16())
    assert calls == [(256, 32)]
    kp, kt = pk.qr_panel_plain(a.bfloat16())
    assert torch.equal(p, kp) and torch.equal(t, kt.bfloat16())


def test_geqrf_default_nb_matches_jax():
    for kmax in (256, 4096, 8192, 16384, 65536):
        for tile in (128, 256, 512):
            assert tqr.geqrf_default_nb(kmax, tile) == \
                jqr.geqrf_default_nb(kmax, tile)
    # the bf16 gels path at n = 8192: 16 steps of 512 (4 sub-panels each)
    assert tqr.geqrf_default_nb(8192, 512) == 512


def test_slice_and_sub_match_jax():
    a = np.arange(300 * 260, dtype=np.float32).reshape(300, 260)
    A, JA = _mat(a, 64)
    for args in ((10, 209, 5, 130), (0, 299, 0, 259)):
        S, JS = A.slice(*args), JA.slice(*args)
        assert (S.m, S.n, S.mb, S.nb) == (JS.m, JS.n, JS.mb, JS.nb)
        np.testing.assert_array_equal(S.data.numpy(), np.asarray(JS.data))
    S, JS = A.sub(1, 3, 0, 2), JA.sub(1, 3, 0, 2)
    assert (S.m, S.n, S.mtype) == (JS.m, JS.n, st.MatrixType.General)
    np.testing.assert_array_equal(S.data.numpy(), np.asarray(JS.data))
    S, JS = A.T.sub(0, 1, 1, 4), JA.T.sub(0, 1, 1, 4)
    np.testing.assert_array_equal(S.to_numpy(), JS.to_numpy())
    assert A.uniform() is A


def test_geqrf_bf16_matches_jax():
    """bf16 geqrf through the Tiled carry form (nb 64: every panel is
    the column loop of reflections on both sides): R agrees with the
    reference's to bf16 rounding of its scale, and Q R reproduces A to
    a bf16-level residual."""
    a = permuted_boosted_system(np.random.default_rng(16), 256, 1)[0]
    o = {st.Option.MethodFactor: st.MethodFactor.Tiled,
         st.Option.BlockSize: 64}
    jo = {jst.Option.MethodFactor: JMethodFactor.Tiled,
          jst.Option.BlockSize: 64}
    F = st.geqrf(st.Matrix(torch.as_tensor(a).bfloat16(), mb=64, **CPU), o)
    JF = jst.geqrf(jst.Matrix(jnp.asarray(a).astype(jnp.bfloat16), mb=64),
                   jo)
    assert F.QR.dtype == torch.bfloat16
    r, jr = np.triu(_np(F.QR.data)), np.triu(_np(JF.QR.data))
    # the boosted diagonal (|R_jj| ~ 2 sqrt(n) = 32) dominates: R agrees
    # to a few bf16 ulps of its scale
    assert np.abs(r - jr).max() <= 2.0 ** -5 * np.abs(jr).max()
    q = _np(st.unmqr(st.Side.Left, F, st.Matrix(
        torch.eye(256).bfloat16(), mb=64, **CPU), trans=False).to_dense())
    # Q applied to I in bf16, then Q R: a few bf16 roundings (2^-8)
    res = np.linalg.norm(q @ r[:256] - a) / np.linalg.norm(a)
    assert res <= 0.02


def test_tune_entries_route_geqrf_and_potrf(monkeypatch):
    """Measured entries steer the drivers as in the reference: a cached
    ("geqrf", "fused_max_n") below n sends Auto to the carry form, a
    cached ("geqrf", "nb") sets its blocking, and a cached potrf
    method_factor "tiled" takes the blocked loop."""
    a = _shape_input("square")
    n = a.shape[0]
    tcache.get_cache().put("geqrf", torch.float32, n,
                           {"fused_max_n": 256, "nb": 128})
    nbs = []
    orig = tqr._geqrf_carry
    monkeypatch.setattr(tqr, "_geqrf_carry",
                        lambda x, nb, *r: nbs.append(nb) or orig(x, nb, *r))
    st.geqrf(st.Matrix(a, mb=NB, **CPU))
    assert nbs == [128]
    from slate_tpu_torch.linalg import blocked as tblocked
    calls = []
    orig_b = tblocked.cholesky_blocked
    monkeypatch.setattr(tblocked, "cholesky_blocked",
                        lambda *x, **k: calls.append(1) or orig_b(*x, **k))
    s = (a @ a.T / n + np.eye(n)).astype(np.float32)
    st.potrf(st.HermitianMatrix(st.Uplo.Lower, s, mb=NB, **CPU))
    assert calls == []
    tcache.get_cache().put("potrf", torch.float32, n,
                           {"method_factor": "tiled"})
    st.potrf(st.HermitianMatrix(st.Uplo.Lower, s, mb=NB, **CPU))
    assert calls == [1]


def test_grid_routes_not_ported():
    """geqrf, gels_tsqr and potrf take Option.Grid only as a
    parallel.ProcessGrid and raise naming the driver on anything else;
    on the 1 x 1 grid their grid routes give the one-device results
    (the routes on four ranks: tests/test_torch_grid.py,
    tests/test_torch_dist.py)."""
    a = _shape_input("tall")
    A = st.Matrix(a, mb=NB, **CPU)
    B = st.Matrix(a[:, :2], mb=NB, **CPU)
    S = st.HermitianMatrix(st.Uplo.Lower, np.eye(8, dtype=np.float32) * 4,
                           mb=8, **CPU)
    calls = {"geqrf": lambda o: st.geqrf(A, o),
             "gels_tsqr": lambda o: st.gels_tsqr(A, B, o),
             "potrf": lambda o: st.potrf(S, o)}
    for name, fn in calls.items():
        with pytest.raises(TypeError, match=name):
            fn({st.Option.Grid: object()})
    one = {st.Option.Grid: st.single_device_grid("cpu")}
    np.testing.assert_allclose(calls["gels_tsqr"](one).to_numpy(),
                               calls["gels_tsqr"](None).to_numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(calls["potrf"](one).to_dense(),
                       calls["potrf"](None).to_dense())

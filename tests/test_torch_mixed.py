"""slate_tpu_torch's mixed-precision solves (gesv_mixed,
gesv_mixed_gmres), the pipelined getrf form and the bf16 factor path
against the JAX package on the CPU.

The same seeded numpy inputs go through both packages. On the JAX side
a tune cache routes bf16 panels to "pallas" or "pallas_rec", so its
kernels run in the Pallas interpreter (off a TPU its cold bf16 route is
the fori loop); on the port side the same cache entries route the
panels to the kernels' plain versions (CPU tensors), and the cold
route is the fori loop as well."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.methods import MethodFactor as JMethodFactor
from slate_tpu.linalg import refine as jrefine
from slate_tpu.ops import pallas_kernels as jpk
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.core.methods import MethodFactor, MethodLUPanel
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.linalg import refine
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import permuted_boosted_system
from slate_tpu_torch.tune import cache as tcache

N, NB, NRHS = 256, 64, 4
ROUTES = ("cold", "pallas", "pallas_rec")


def _route(route, monkeypatch, tmp_path):
    """Fresh tune caches for both packages; for a kernel route, the
    measured bf16 panel route in both (one bucket covers heights
    64-256)."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    if route != "cold":
        tcache.get_cache().put("lu_panel", torch.bfloat16, N,
                               {"method_lu_panel": route})
        jcache.get_cache().put("lu_panel", jnp.bfloat16, N,
                               {"method_lu_panel": route})


def _berr(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a)
                                        * np.linalg.norm(x))


def _cpu(a, **kw):
    return st.Matrix(a, device="cpu", **kw)


@pytest.fixture(scope="module")
def system():
    return permuted_boosted_system(np.random.default_rng(1), N, NRHS)


@pytest.fixture(scope="module")
def jax_mixed(system, tmp_path_factory):
    """JAX gesv_mixed on every route and gesv_mixed_gmres on the
    rank-1 route, computed once."""
    a, b = system
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for route in ROUTES:
            _route(route, mp, tmp_path_factory.mktemp(route))
            F, X, it = jst.gesv_mixed(jst.Matrix(a, mb=NB),
                                      jst.Matrix(b, mb=NB),
                                      {jst.Option.BlockSize: NB})
            out[route] = (np.asarray(F.pivots), X.to_numpy(), int(it), F)
            if route == "pallas":
                F, X, it = jst.gesv_mixed_gmres(
                    jst.Matrix(a, mb=NB), jst.Matrix(b[:, :1], mb=NB),
                    {jst.Option.BlockSize: NB})
                out["gmres"] = (np.asarray(F.pivots), X.to_numpy(),
                                int(it), F)
    finally:
        mp.undo()
        tcache.reset_cache()
        jcache.reset_cache()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_gesv_mixed_matches_jax(system, jax_mixed, route, monkeypatch,
                                tmp_path):
    """f32 input, bf16 factor, nb = 64: the pipelined form in both.
    The boosted system forces every pivot: bitwise. Both refine to a
    backward error <= 1e-6 and agree to 1e-5 (cond(A) = O(1)); the
    bf16 factors round at different points (the triangular solves,
    blocked.solve_triangular), so the sweep counts may differ by one."""
    a, b = system
    _route(route, monkeypatch, tmp_path)
    calls = []
    for name in ("lu_panel", "lu_panel_rec"):
        orig = getattr(pk, name)
        monkeypatch.setattr(pk, name, lambda x, _o=orig, _n=name, **k:
                            calls.append((_n, tuple(x.shape)))
                            or _o(x, **k))
    F, X, iters = st.gesv_mixed(_cpu(a, mb=NB), _cpu(b, mb=NB),
                                {st.Option.BlockSize: NB})
    jpiv, jx, jit, _ = jax_mixed[route]
    assert F.LU.dtype == torch.bfloat16
    # every panel asked the route the cache chose (the 192- and 64-row
    # panels then fall to the fori loop on the gates' 'align', in both)
    heights = [(N - k * NB, NB) for k in range(N // NB)]
    want = {"cold": [], "pallas": [("lu_panel", s) for s in heights],
            "pallas_rec": [("lu_panel_rec", s) for s in heights]}[route]
    assert calls == want
    assert np.array_equal(F.pivots.numpy(), jpiv)
    assert iters >= 0 and jit >= 0 and abs(iters - jit) <= 1
    x = X.to_numpy()
    assert _berr(a, x, b) <= 1e-6 and _berr(a, jx, b) <= 1e-6
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)


def test_gesv_mixed_gmres_matches_jax(system, jax_mixed, monkeypatch,
                                      tmp_path):
    """One right-hand side, restart min(30, itermax, mb - 1) = 30, the
    rank-1 route: as test_gesv_mixed_matches_jax."""
    a, b = system
    _route("pallas", monkeypatch, tmp_path)
    F, X, iters = st.gesv_mixed_gmres(_cpu(a, mb=NB), _cpu(b[:, :1], mb=NB),
                                      {st.Option.BlockSize: NB})
    jpiv, jx, jit, _ = jax_mixed["gmres"]
    assert np.array_equal(F.pivots.numpy(), jpiv)
    # iters counts whole restart cycles of 30: within one cycle
    assert iters >= 0 and jit >= 0 and abs(iters - jit) <= 30
    x = X.to_numpy()
    assert x.shape == (N, 1)
    assert _berr(a, x, b[:, :1]) <= 1e-6 and _berr(a, jx, b[:, :1]) <= 1e-6
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)


@pytest.mark.parametrize("driver", ["gesv_mixed", "gesv_mixed_gmres"])
def test_mixed_f64_input_refines_f32_factor(driver):
    """f64 input: the factor is f32 (lo precision of f64) and the
    refinement reaches f64 accuracy, as tests/test_lu.py does for the
    reference; both packages pick the same pivots."""
    rng = np.random.default_rng(42)
    n = 40
    a = rng.standard_normal((n, n)) + n * np.eye(n) * 0.1
    b = rng.standard_normal((n, 2 if driver == "gesv_mixed" else 1))
    F, X, iters = getattr(st, driver)(_cpu(a, mb=8), _cpu(b, mb=8))
    JF, JX, jit = getattr(jst, driver)(jst.Matrix(a, mb=8),
                                       jst.Matrix(b, mb=8))
    assert F.LU.dtype == torch.float32
    assert iters >= 0 and int(jit) >= 0
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    # the reference test's tolerances: 1e-9 (IR), 1e-8 (FGMRES)
    tol = 1e-9 if driver == "gesv_mixed" else 1e-8
    np.testing.assert_allclose(a @ X.to_numpy(), b, rtol=tol)


@pytest.mark.parametrize("driver", ["gesv_mixed", "gesv_mixed_gmres"])
def test_mixed_non_convergence_takes_fallback(driver):
    """MaxIterations 0 on an ill-conditioned matrix (cond 1e6): the bf16
    factor cannot meet the f32 criterion, so the fallback f32 solve
    gives X and iters < 0, the same code as the reference's."""
    rng = np.random.default_rng(3)
    n = 128
    q1, _ = np.linalg.qr(rng.standard_normal((n, n)))
    q2, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = ((q1 * np.logspace(0, -6, n)) @ q2.T).astype(np.float32)
    b = rng.standard_normal((n, 1)).astype(np.float32)
    opts = {st.Option.MaxIterations: 0}
    F, X, iters = getattr(st, driver)(_cpu(a, mb=32), _cpu(b, mb=32), opts)
    _, JX, jit = getattr(jst, driver)(jst.Matrix(a, mb=32),
                                      jst.Matrix(b, mb=32),
                                      {jst.Option.MaxIterations: 0})
    assert iters < 0 and iters == int(jit)
    _, Xf = st.gesv(_cpu(a, mb=32), _cpu(b, mb=32), opts)
    assert torch.equal(X.data, Xf.data)
    # without the fallback the unrefined lo solution comes back
    _, Xn, it_n = getattr(st, driver)(
        _cpu(a, mb=32), _cpu(b, mb=32),
        {st.Option.MaxIterations: 0, st.Option.UseFallbackSolver: False})
    assert it_n >= 0 and not torch.equal(Xn.data, Xf.data)


# -- the pipelined form and the width cap ------------------------------------

def test_getrf_pipelined_matches_unrolled_and_jax(monkeypatch):
    """Lookahead 1 routes getrf through the pipelined loop; deferring
    the swaps must reproduce the unrolled loop exactly (pivots equal,
    f64 factors to 1e-12, as tests/test_lu.py holds the reference), and
    the reference's pipelined loop (same pivots). The library-LU dtype
    gate is forced off in both packages, so f64 takes these forms
    instead of the carry form."""
    monkeypatch.setattr(MethodFactor, "native_lu_dtype_ok",
                        staticmethod(lambda dt: False))
    monkeypatch.setattr(JMethodFactor, "native_lu_dtype_ok",
                        staticmethod(lambda dt: False))
    calls = []
    orig = tlu._getrf_pipelined
    monkeypatch.setattr(tlu, "_getrf_pipelined",
                        lambda a, nb: calls.append(nb) or orig(a, nb))
    rng = np.random.default_rng(42)
    for m, n in ((96, 96), (96, 120), (120, 96)):
        a = rng.standard_normal((m, n))
        base = {st.Option.MethodFactor: st.MethodFactor.Tiled,
                st.Option.BlockSize: 16}
        F0 = st.getrf(_cpu(a, mb=16), {**base, st.Option.Lookahead: 0})
        F1 = st.getrf(_cpu(a, mb=16), {**base, st.Option.Lookahead: 1})
        assert np.array_equal(F1.pivots.numpy(), F0.pivots.numpy())
        np.testing.assert_allclose(F1.LU.data.numpy(), F0.LU.data.numpy(),
                                   rtol=1e-12, atol=1e-13)
        if (m, n) != (96, 120):
            continue        # the reference's loop on one shape (its time)
        JF = jst.getrf(jst.Matrix(a, mb=16),
                       {jst.Option.MethodFactor: JMethodFactor.Tiled,
                        jst.Option.BlockSize: 16, jst.Option.Lookahead: 1})
        assert np.array_equal(F1.pivots.numpy(), np.asarray(JF.pivots))
        np.testing.assert_allclose(F1.LU.data.numpy(),
                                   np.asarray(JF.LU.data), rtol=1e-10,
                                   atol=1e-12)
    assert calls == [16, 16, 16]


def test_width_cap_to_rank1_kernel_matches_jax(monkeypatch, tmp_path):
    """Where the rank-1 kernel's gate takes bf16 panels (the card; the
    TPU for the reference), getrf caps the frozen nb (512) to its width
    (256) and every panel runs it. Both gates are opened on the CPU for
    the shapes the kernels take: the port's plain version and the
    reference's interpreted kernel then factor the same panels, with
    the same pivots."""
    _route("cold", monkeypatch, tmp_path)
    monkeypatch.setattr(
        pk, "lu_panel_eligible", lambda m, w, dt, device=None:
        dt in pk.PANEL_DTYPES and pk._lu_shape_ok(m, w, dt))
    monkeypatch.setattr(
        jpk, "lu_panel_eligible", lambda m, w, dt:
        jnp.dtype(dt) in (jnp.float32, jnp.bfloat16)
        and jpk._lu_shape_ok(m, w, dt))
    calls = []
    orig = pk.lu_panel
    monkeypatch.setattr(pk, "lu_panel",
                        lambda x: calls.append(tuple(x.shape)) or orig(x))
    a, _ = permuted_boosted_system(np.random.default_rng(8), 512, 1)
    F = st.getrf(_cpu(torch.as_tensor(a).bfloat16(), mb=128))
    JF = jst.getrf(jst.Matrix(jnp.asarray(a).astype(jnp.bfloat16), mb=128))
    assert calls == [(512, 256), (256, 256)]
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    # bf16 trailing products rounded at different points: to 2^-6 of
    # the factor's scale (|U| ~ 2 sqrt(n) = 45)
    lu = F.LU.data.float().numpy()
    jlu = np.asarray(JF.LU.data).astype(np.float32)
    assert np.abs(lu - jlu).max() <= 2.0 ** -6 * np.abs(jlu).max()


def test_cold_panel_route_on_the_card():
    """The cold chain with the panel on the card: native for the
    library-LU dtypes, the rank-1 kernel for bf16 panels its gate takes
    (at most 4096 rows), the fori loop above; off the card bf16 stays
    on the fori loop, as the reference off the TPU."""
    cuda = torch.device("cuda")
    cold = MethodLUPanel.cold_default
    assert cold(8192, 256, torch.float32, cuda) is MethodLUPanel.Native
    assert cold(4096, 256, torch.bfloat16, cuda) is MethodLUPanel.Pallas
    assert cold(4224, 256, torch.bfloat16, cuda) is MethodLUPanel.Fori
    assert cold(4096, 256, torch.bfloat16, "cpu") is MethodLUPanel.Fori
    assert cold(4096, 256, torch.bfloat16) is MethodLUPanel.Fori
    assert MethodLUPanel.resolve(4096, 256, torch.bfloat16, cuda) \
        is MethodLUPanel.Pallas


# -- refinement pieces, factors carried over, obs ------------------------------

def test_lo_dtype_pairs_match_jax():
    for t, j in ((torch.float64, jnp.float64), (torch.float32, jnp.float32),
                 (torch.complex128, jnp.complex128),
                 (torch.bfloat16, jnp.bfloat16)):
        assert str(refine.lo_dtype(t)).replace("torch.", "") == \
            jnp.dtype(jrefine.lo_dtype(j)).name


def test_lstsq_svd_matches_jax_at_rank_loss():
    """The FGMRES least-squares solve at a lucky breakdown (H loses
    rank): the SVD with jnp.linalg.lstsq's cutoff gives its minimum-norm
    answer."""
    rng = np.random.default_rng(4)
    H = np.triu(rng.standard_normal((6, 5)), -1)
    H[4, 3] = 0.0                       # breakdown: H[4:, 4] dependent
    H[:, 4] = H[:, 3] * 2.0
    e1 = np.zeros(6)
    e1[0] = 3.0
    ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(H), jnp.asarray(e1))[0])
    out = refine._lstsq_svd(torch.as_tensor(H), torch.as_tensor(e1))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)


def test_from_jax_state_bf16_factors(system, jax_mixed):
    """The reference's bf16 LU factors carry over bit for bit (numpy
    holds them as ml_dtypes.bfloat16, which the port never imports),
    and the port's refinement converges on them."""
    a, b = system
    JF = jax_mixed["pallas_rec"][3]
    jlu = np.asarray(JF.LU.data)
    assert jlu.dtype.name == "bfloat16"
    meta = {"m": JF.LU.m, "n": JF.LU.n, "mb": JF.LU.mb, "nb": JF.LU.nb,
            "mtype": JF.LU.mtype.name}
    F = st.from_jax_state({"LU": jlu, "pivots": np.asarray(JF.pivots),
                           "info": np.asarray(JF.info)}, meta, device="cpu")
    assert F.LU.dtype == torch.bfloat16
    assert np.array_equal(F.LU.data.view(torch.int16).numpy(),
                          jlu.view(np.int16))
    A, B = _cpu(a, mb=NB), _cpu(b, mb=NB)
    solve_lo = refine.lo_rhs_solver(B, torch.bfloat16,
                                    lambda rhs: st.getrs(F, rhs))
    x, iters = refine.iterative_refinement(A, B, solve_lo, None)
    assert iters >= 0 and _berr(a, x.numpy(), b) <= 1e-6


def test_refine_and_fori_fallback_publish_obs(system):
    from slate_tpu_torch.obs import events as ev
    a, b = system
    ev.clear()
    ev.enable()
    try:
        tlu._FORI_FALLBACK_SEEN.clear()
        _, _, iters = st.gesv_mixed(_cpu(a, mb=NB), _cpu(b, mb=NB),
                                    {st.Option.BlockSize: NB})
        names = [e.name for e in ev.events()]
        ir = [e for e in ev.events(cat="refine") if e.name == "refine.ir"]
        assert names.count("gesv_mixed") == 1
        assert len(ir) == 1 and ir[0].args["iters"] == iters
        fb = [e for e in ev.events(cat="kernel")
              if e.name == "getrf.panel_fori_fallback"]
        assert fb and all(e.args["reason"] == pk.NOT_CUDA for e in fb)
    finally:
        ev.disable()
        ev.clear()

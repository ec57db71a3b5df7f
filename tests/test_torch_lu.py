"""slate_tpu_torch getrf / getrs / gesv against the JAX package on the
CPU, on both panel routes: the cold route (library LU panels) and the
route a measured ``method_lu_panel = "pallas_rec"`` tune entry selects
(the recursive panel kernel: plain versions on the port side, the
Pallas interpreter on the JAX side). Plus from_jax_state round trips
and the unported branches' errors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import slate_tpu as jst
from slate_tpu.core.methods import MethodFactor as JMethodFactor
from slate_tpu.tune import cache as jcache

import slate_tpu_torch as st
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import permuted_boosted_system
from slate_tpu_torch.tune import cache as tcache

N, NB, NRHS = 512, 128, 8
ROUTES = ("cold", "pallas_rec")


def _meta(M):
    """The metadata from_jax_state takes, read off a JAX TiledMatrix."""
    return {"m": M.m, "n": M.n, "mb": M.mb, "nb": M.nb,
            "mtype": M.mtype.name, "uplo": M.uplo.name, "op": M.op.name,
            "diag": M.diag.name, "kl": M.kl, "ku": M.ku}


def _route(route, monkeypatch, tmp_path):
    """Point both packages at fresh tune caches; for "pallas_rec", put
    the measured route into both for every panel-height bucket."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    if route == "pallas_rec":
        for n in (128, 256, 512):
            tcache.get_cache().put("lu_panel", torch.float32, n,
                                   {"method_lu_panel": "pallas_rec"})
            jcache.get_cache().put("lu_panel", np.float32, n,
                                   {"method_lu_panel": "pallas_rec"})


@pytest.fixture(scope="module")
def system():
    return permuted_boosted_system(np.random.default_rng(1), N, NRHS)


@pytest.fixture(scope="module")
def jax_results(system, tmp_path_factory):
    """JAX gesv on both routes, computed once."""
    a, b = system
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for route in ROUTES:
            _route(route, mp, tmp_path_factory.mktemp(route))
            F, X = jst.gesv(jst.Matrix(a, mb=NB), jst.Matrix(b, mb=NB),
                            {jst.Option.BlockSize: NB})
            out[route] = (F, np.asarray(F.LU.data), np.asarray(F.pivots),
                          int(F.info), X.to_numpy())
    finally:
        mp.undo()
        tcache.reset_cache()
        jcache.reset_cache()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_gesv_matches_jax(system, jax_results, route, monkeypatch,
                          tmp_path):
    a, b = system
    _route(route, monkeypatch, tmp_path)
    calls = []
    orig = pk.lu_panel_rec
    monkeypatch.setattr(pk, "lu_panel_rec",
                        lambda x, **k: calls.append(tuple(x.shape))
                        or orig(x, **k))
    F, X = st.gesv(st.Matrix(a, mb=NB, device="cpu"),
                   st.Matrix(b, mb=NB, device="cpu"),
                   {st.Option.BlockSize: NB})
    _, jlu, jpiv, jinfo, jx = jax_results[route]
    # every panel went through the route the tune cache chose
    assert calls == ([] if route == "cold" else
                     [(N - k * NB, NB) for k in range(N // NB)])
    # the permuted boosted matrix forces every pivot: bitwise
    assert np.array_equal(F.pivots.numpy(), jpiv)
    assert int(F.info) == jinfo == 0
    # f32 factors of an O(1)-conditioned matrix through differently
    # ordered (but equally blocked) updates: 1e-4 relative to the
    # factor's scale (|U| ~ 2 sqrt(n) = 45)
    lu = F.LU.data.numpy()
    assert np.abs(lu - jlu).max() <= 1e-4 * np.abs(jlu).max()
    # the solve: cond(A) = O(1), so forward errors of both routes are
    # a few f32 ulps; 1e-4 relative leaves room for the f32 sums
    x = X.to_numpy()
    assert np.linalg.norm(x - jx) <= 1e-4 * np.linalg.norm(jx)
    assert np.linalg.norm(a @ x - b) <= 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("trans", [st.Op.Trans, st.Op.ConjTrans, True])
def test_getrs_transposed_matches_jax(system, jax_results, trans):
    """Port getrs on the JAX factors (carried over with from_jax_state)
    against JAX getrs: the same factors, so only the two triangular
    solves' rounding differs (1e-5 relative)."""
    a, b = system
    JF = jax_results["cold"][0]
    jtrans = trans if trans is True else jst.Op[trans.name]
    jx = jst.getrs(JF, jst.Matrix(b, mb=NB), trans=jtrans).to_numpy()
    F = st.from_jax_state({"LU": np.asarray(JF.LU.data),
                           "pivots": np.asarray(JF.pivots),
                           "info": np.asarray(JF.info)},
                          _meta(JF.LU), device="cpu")
    x = st.getrs(F, st.Matrix(b, mb=NB, device="cpu"),
                 trans=trans).to_numpy()
    assert np.linalg.norm(x - jx) <= 1e-5 * np.linalg.norm(jx)
    assert np.linalg.norm(a.T @ x - b) <= 1e-5 * np.linalg.norm(b)


def test_from_jax_state_round_trip(system, jax_results):
    """numpy out of the JAX objects, into the port, and back: every
    array bitwise, every field equal."""
    a, _ = system
    JA = jst.TriangularMatrix(jst.Uplo.Lower, a[:100, :100], mb=32,
                              diag=jst.Diag.Unit).T
    T = st.from_jax_state({"data": np.asarray(JA.data)}, _meta(JA),
                          device="cpu")
    assert np.array_equal(T.data.numpy(), np.asarray(JA.data))
    assert _meta(T) == _meta(JA)
    assert np.array_equal(T.to_numpy(), np.asarray(JA.to_dense()))
    JF, jlu, jpiv, jinfo, _ = jax_results["pallas_rec"]
    F = st.from_jax_state({"LU": jlu, "pivots": jpiv,
                           "info": np.asarray(JF.info)}, _meta(JF.LU),
                          device="cpu")
    assert isinstance(F, st.LUFactors)
    assert np.array_equal(F.LU.data.numpy(), jlu)
    assert np.array_equal(F.pivots.numpy(), jpiv)
    assert F.pivots.dtype == torch.int32 and int(F.info) == jinfo
    assert _meta(F.LU) == _meta(JF.LU)
    # band factors (gbtrf's) carry over with their flag since the band
    # slice (tests/test_torch_band.py solves with them)
    Fb = st.from_jax_state({"LU": jlu, "pivots": jpiv},
                           dict(_meta(JF.LU), band=True), device="cpu")
    assert Fb.band and not F.band
    assert np.array_equal(Fb.LU.data.numpy(), jlu)


def test_getrf_rectangular_and_ragged_tiles_match_jax():
    """m != n and a size that is not a tile multiple: the identity
    padding of the diagonal and the carry form's rectangular
    assembly."""
    rng = np.random.default_rng(2)
    a, _ = permuted_boosted_system(rng, 300, 1)
    a = a[:, :200]
    JF = jst.getrf(jst.Matrix(a, mb=64), {jst.Option.BlockSize: 64})
    F = st.getrf(st.Matrix(a, mb=64, device="cpu"),
                 {st.Option.BlockSize: 64})
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    jlu = np.asarray(JF.LU.data)
    # as in test_gesv_matches_jax
    assert np.abs(F.LU.data.numpy() - jlu).max() \
        <= 1e-4 * np.abs(jlu).max()


def test_getrf_single_block_and_fused_match_jax(system):
    """nt == 1 (the unrolled loop) and MethodFactor.Fused (one library
    LU): pivots bitwise, factors as above."""
    a, _ = system
    for opts in ({"nb": 1024}, {st.Option.MethodFactor:
                                st.MethodFactor.Fused}):
        jopts = {jst.Option.BlockSize: 1024} if "nb" in opts else \
            {jst.Option.MethodFactor: JMethodFactor.Fused}
        JF = jst.getrf(jst.Matrix(a, mb=NB), jopts)
        F = st.getrf(st.Matrix(a, mb=NB, device="cpu"), opts)
        jlu = np.asarray(JF.LU.data)
        assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
        assert np.abs(F.LU.data.numpy() - jlu).max() \
            <= 1e-4 * np.abs(jlu).max()


def test_singular_info_matches_jax():
    # an exactly zero column: U(k,k) == 0 at the same k in both
    rng = np.random.default_rng(4)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    a[:, 77] = 0.0
    JF = jst.getrf(jst.Matrix(a, mb=64), {jst.Option.BlockSize: 64})
    F = st.getrf(st.Matrix(a, mb=64, device="cpu"),
                 {st.Option.BlockSize: 64})
    assert int(F.info) == int(JF.info) == 78


def test_native_panel_pivots_match_xla(system):
    """The cold panel: torch.linalg.lu_factor's 1-based pivots become
    the 0-based swap targets of jax.lax.linalg.lu."""
    import jax
    a, _ = system
    panel = a[:, :64]
    jl, jp, _ = jax.lax.linalg.lu(jnp.asarray(panel))
    lu, piv = tlu._native_lu(torch.as_tensor(panel))
    assert piv.dtype == torch.int32
    assert np.array_equal(piv.numpy(), np.asarray(jp))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("opts,match", [
    ({st.Option.MethodLU: st.MethodLU.CALU, st.Option.Grid: object()},
     "getrf_tntpiv"),
    ({st.Option.MethodLU: st.MethodLU.NoPiv, st.Option.Grid: object()},
     "getrf_nopiv"),
    ({st.Option.Grid: object()}, "grid"),
])
def test_unported_branches_raise(opts, match):
    """The grid paths of every MethodLU route take Option.Grid only as a
    parallel.ProcessGrid and raise naming the route on anything else,
    instead of taking another route (the grid routes themselves:
    tests/test_torch_grid.py)."""
    a = np.eye(1024, dtype=np.float32)
    with pytest.raises(TypeError, match=match):
        st.getrf(st.Matrix(a, mb=128, device="cpu"), opts)


def test_pipelined_form_raises_for_non_native_dtype(monkeypatch):
    """A dtype the library LU lacks (bf16) takes the pipelined form,
    also where the reference takes its scan form (more than
    LU_SCAN_THRESHOLD block steps): eye(1024) at nb 8 runs the
    pipelined loop at width 8 and factors to itself."""
    calls = []
    orig = tlu._getrf_pipelined
    monkeypatch.setattr(tlu, "_getrf_pipelined",
                        lambda a, nb: calls.append(nb) or orig(a, nb))
    a = torch.eye(256, dtype=torch.bfloat16)
    F = st.getrf(st.Matrix(a, mb=64, device="cpu"), {"nb": 64})
    assert calls == [64] and F.LU.dtype == torch.bfloat16
    assert torch.equal(F.LU.data, a) and int(F.info) == 0
    eye = torch.eye(1024, dtype=torch.bfloat16)
    F = st.getrf(st.Matrix(eye, mb=128, device="cpu"), {"nb": 8})
    assert calls == [64, 8]
    assert torch.equal(F.LU.data, eye) and int(F.info) == 0


@pytest.mark.parametrize("n,mb,nb,width", [
    (520, 8, 8, 8),        # nb divides N: the scan at nb
    (264, 4, 4, 4),
    (536, 8, 7, 8),        # nb does not divide N, the tile (8) does
])
def test_scan_route_matches_jax(n, mb, nb, width, monkeypatch):
    """Squares with more than LU_SCAN_THRESHOLD block steps, where the
    reference runs _lu_scan: the port runs its carry loop at the width
    the reference resolves. The permuted boosted matrix forces every
    pivot: bitwise; the factors as in test_gesv_matches_jax."""
    calls = []
    orig = tlu._getrf_carry
    monkeypatch.setattr(tlu, "_getrf_carry",
                        lambda a, w: calls.append(w) or orig(a, w))
    a, _ = permuted_boosted_system(np.random.default_rng(n), n, 1)
    JF = jst.getrf(jst.Matrix(a, mb=mb), {jst.Option.BlockSize: nb})
    F = st.getrf(st.Matrix(a, mb=mb, device="cpu"),
                 {st.Option.BlockSize: nb})
    assert calls == [width]
    assert np.array_equal(F.pivots.numpy(), np.asarray(JF.pivots))
    assert int(F.info) == int(JF.info) == 0
    jlu = np.asarray(JF.LU.data)
    assert np.abs(F.LU.data.numpy() - jlu).max() \
        <= 1e-4 * np.abs(jlu).max()


@pytest.mark.parametrize("n,mb,nb", [(200, 8, 3), (512, 16, 6)])
def test_scan_fall_through_matches_scipy(n, mb, nb, monkeypatch):
    """More than LU_SCAN_THRESHOLD steps at a width that divides
    nothing usable (200 at nb 3: 67 steps, the tile's 25 would leave
    the scan regime; 512 at nb 6: 86 steps, the tile's 32 likewise):
    the reference falls through to its carry form at the caller's nb,
    and so does the port. That form takes the reference over 120 s on
    the CPU at 67 steps, so these cases are held against
    scipy.linalg.lu_factor instead: pivots bitwise (the matrix forces
    every pivot) and P L U to 1e-5 of A."""
    import scipy.linalg
    calls = []
    orig = tlu._getrf_carry
    monkeypatch.setattr(tlu, "_getrf_carry",
                        lambda a, w: calls.append(w) or orig(a, w))
    a, _ = permuted_boosted_system(np.random.default_rng(n), n, 1)
    F = st.getrf(st.Matrix(a, mb=mb, device="cpu"),
                 {st.Option.BlockSize: nb})
    assert calls == [nb] and int(F.info) == 0
    _, spiv = scipy.linalg.lu_factor(a.astype(np.float64))
    piv = F.pivots.numpy()[:n]
    assert np.array_equal(piv, spiv)
    lu = F.LU.data.numpy()[:n, :n].astype(np.float64)
    L = np.tril(lu, -1) + np.eye(n)
    U = np.triu(lu)
    pa = a.astype(np.float64).copy()
    for j, p in enumerate(piv):
        pa[[j, p]] = pa[[p, j]]
    assert np.abs(pa - L @ U).max() <= 1e-5 * np.abs(a).max()


# -- BLAS-3 and blocked pieces the solve uses -------------------------------

@pytest.mark.parametrize("lower,unit", [(True, True), (True, False),
                                        (False, False), (False, True)])
def test_invert_triangular_matches_jax(lower, unit):
    """Leaf (<= 512) and the recursive halves above it; a diagonally
    dominant triangle keeps the inverse O(1), so 1e-5 relative is f32
    rounding of the substitutions."""
    from slate_tpu.linalg.blocked import invert_triangular as jinv
    from slate_tpu_torch.linalg.blocked import invert_triangular
    n = 640 if unit else 200
    rng = np.random.default_rng(n + lower)
    a = (rng.standard_normal((n, n)) / n + 2 * np.eye(n)).astype(np.float32)
    a = np.tril(a) if lower else np.triu(a)
    ref = np.asarray(jinv(jnp.asarray(a), lower, unit))
    out = invert_triangular(torch.as_tensor(a), lower, unit).numpy()
    assert np.linalg.norm(out - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("side,uplo", [("Left", "Upper"), ("Right", "Lower"),
                                       ("Right", "Upper")])
def test_trsm_matches_jax(side, uplo):
    # a well-conditioned triangle: f32 solves agree to 1e-5 relative
    rng = np.random.default_rng(9)
    n, k = 96, 40
    a = (rng.standard_normal((n, n)) / n + 2 * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, k) if side == "Left" else (k, n)) \
        .astype(np.float32)
    JA = jst.TriangularMatrix(jst.Uplo[uplo], a, mb=32)
    ref = jst.trsm(jst.Side[side], 2.0, JA, jst.Matrix(b, mb=32)).to_numpy()
    A = st.TriangularMatrix(st.Uplo[uplo], a, mb=32, device="cpu")
    out = st.trsm(st.Side[side], 2.0, A,
                  st.Matrix(b, mb=32, device="cpu")).to_numpy()
    assert np.linalg.norm(out - ref) <= 1e-5 * np.linalg.norm(ref)


def test_gemm_matches_jax():
    # O(1) entries, sums of 70 products: 1e-5 relative is f32 rounding
    rng = np.random.default_rng(10)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((50, 70), (50, 30), (70, 30)))
    ref = jst.gemm(1.5, jst.Matrix(a, mb=16).T, jst.Matrix(b, mb=16), -0.5,
                   jst.Matrix(c, mb=16)).to_numpy()
    out = st.gemm(1.5, st.Matrix(a, mb=16, device="cpu").T,
                  st.Matrix(b, mb=16, device="cpu"), -0.5,
                  st.Matrix(c, mb=16, device="cpu")).to_numpy()
    assert np.linalg.norm(out - ref) <= 1e-5 * np.linalg.norm(ref)
    with pytest.raises(st.DimensionError):
        st.gemm(1.0, st.Matrix(a, mb=16, device="cpu"),
                st.Matrix(a, mb=16, device="cpu"), 0.0,
                st.Matrix(c, mb=16, device="cpu"))


def test_tune_decisions_counted(tmp_path, monkeypatch):
    from slate_tpu_torch.tune import stats
    _route("pallas_rec", monkeypatch, tmp_path)
    stats.reset()
    a, b = permuted_boosted_system(np.random.default_rng(6), 256, 2)
    st.gesv(st.Matrix(a, mb=64, device="cpu"),
            st.Matrix(b, mb=64, device="cpu"), {"nb": 64})
    snap = stats.snapshot()
    # getrf.nb explicit; one cached panel route per panel (4)
    assert snap["decisions"]["getrf.nb[explicit]"] == 1
    assert snap["decisions"]["lu_panel.method_lu_panel[cached]"] == 4
    assert snap["cache_hits"] >= 4


# -- the recursive panel's deferred row swaps ------------------------------

def _segment_immediate(out, piv, c0, e):
    """The base case with each row swap applied to the whole row at its
    column (the form before the swaps outside the segment were deferred
    to one gather, ops/kernels._segment_plain)."""
    ct = torch.promote_types(out.dtype, torch.float32)
    for j in range(c0, min(e, out.shape[0])):
        p = j + int(torch.argmax(out[j:, j].to(ct).abs()))
        piv[j] = p
        if p != j:
            out[[j, p]] = out[[p, j]]
        pivval = out[j, j].to(ct)
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        mults = (out[j + 1:, j].to(ct) / safe).to(out.dtype)
        out[j + 1:, j] = mults
        out[j + 1:, j + 1:e] -= torch.outer(mults, out[j, j + 1:e])


def _rec_cases():
    """(name, panel, ib): the adversarial suite (m = 256, w = 32,
    ib = 8) and a 256 x 128 panel at the frozen ib = 32, spiked so the
    pivots cross every segment."""
    from slate_tpu_torch.testing import panel_cases, spiked
    cases = [(k, a, 8) for k, a in
             panel_cases(np.random.default_rng(42), 256, 32, 8).items()]
    rng = np.random.default_rng(11)
    cases.append(("w128", spiked(rng, 256, 128,
                                 [255 - (37 * j) % 200 for j in range(128)]),
                  32))
    return cases


REC_CASES = _rec_cases()


@pytest.mark.parametrize("case", range(len(REC_CASES)),
                         ids=[c[0] for c in REC_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferred_swaps_equal_immediate_and_jax(case, dtype, monkeypatch):
    """The plain panel with the swaps outside each base-case segment
    deferred to one gather (as the kernel does) is bitwise the panel
    with every swap applied at its column, in pivots and values (row
    swaps are exact); its pivots are bitwise those of the JAX
    lu_panel_rec (the Pallas interpreter)."""
    from slate_tpu.ops import pallas_kernels as jpk
    name, a, ib = REC_CASES[case]
    t = torch.as_tensor(a).to(dtype)
    got, piv = pk.panel_rec_plain(t, ib)
    monkeypatch.setattr(pk, "_segment_plain", _segment_immediate)
    ref, rpiv = pk.panel_rec_plain(t, ib)
    assert torch.equal(piv, rpiv)
    assert torch.equal(got, ref)
    if dtype == torch.float32:
        _, jpiv = jpk.lu_panel_rec(jnp.asarray(a), ib=ib)
        assert np.array_equal(piv.numpy(), np.asarray(jpiv))


@pytest.mark.parametrize("seed,c0,ncols,m", [(0, 0, 32, 256), (1, 64, 32, 256),
                                             (2, 8, 8, 40), (3, 0, 16, 16)])
def test_swap_gather_composes_the_swaps(seed, c0, ncols, m):
    """swap_gather's (dst, src) moves exactly the rows the swap sequence
    c0+jj <-> piv[c0+jj] moves, to where the sequence puts them."""
    rng = np.random.default_rng(seed)
    piv = list(range(c0)) + [c0 + jj + int(rng.integers(0, m - c0 - jj))
                             for jj in range(ncols)]
    rows = np.arange(m)
    for jj in range(ncols):
        j, p = c0 + jj, piv[c0 + jj]
        rows[[j, p]] = rows[[p, j]]
    dst, src = pk.swap_gather(piv, c0, ncols)
    moved = np.arange(m)
    moved[dst] = np.asarray(src, dtype=int)
    assert np.array_equal(moved, rows)
    assert sorted(dst) == sorted(set(dst))
    assert all(rows[r] != r for r in dst)


# -- the rest of LU: no-pivot, CALU, getri, the butterfly, the aliases -------

N_V, NB_V = 192, 32


def _dominant(seed, n=N_V):
    """A diagonally dominant f32 matrix (|a_jj| > sum of the row's other
    |a_jk|): no-pivot LU is stable on it, so both packages agree to
    rounding."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    return a


def test_getrf_nopiv_and_gesv_nopiv_match_jax():
    a = _dominant(10)
    b = np.random.default_rng(11).standard_normal((N_V, 4)) \
        .astype(np.float32)
    Fj, Xj = jst.gesv_nopiv(jst.Matrix(a, mb=NB_V), jst.Matrix(b, mb=NB_V))
    Ft, Xt = st.gesv_nopiv(st.Matrix(a, mb=NB_V, device="cpu"),
                           st.Matrix(b, mb=NB_V, device="cpu"))
    np.testing.assert_allclose(Ft.LU.data.numpy(), np.asarray(Fj.LU.data),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(Ft.pivots.numpy(), np.asarray(Fj.pivots))
    assert int(Ft.info) == int(Fj.info) == 0
    np.testing.assert_allclose(Xt.to_numpy(), Xj.to_numpy(), rtol=1e-5,
                               atol=1e-5)
    # MethodLU.NoPiv routes getrf to the same factor
    Fr = st.getrf(st.Matrix(a, mb=NB_V, device="cpu"),
                  {st.Option.MethodLU: st.MethodLU.NoPiv})
    assert torch.equal(Fr.LU.data, Ft.LU.data)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m,w,chunk", [(256, 16, 32), (200, 8, 24),
                                       (96, 32, 32)])
def test_tournament_pivot_rows_match_jax(seed, m, w, chunk):
    """An explicit chunk under the panel's height runs the bracket:
    local LUs of every chunk, then the pairwise rounds; the selected
    rows, in order, are the reference's."""
    from slate_tpu.linalg import ca as jca
    from slate_tpu_torch.linalg import ca as tca
    p = np.random.default_rng(100 + seed).standard_normal((m, w)) \
        .astype(np.float32)
    ref = np.asarray(jca.tournament_pivot_rows(jnp.asarray(p), chunk=chunk))
    out = tca.tournament_pivot_rows(torch.as_tensor(p), chunk=chunk)
    assert np.array_equal(out.numpy(), ref)


def test_tournament_fori_nomination_matches_jax(monkeypatch):
    """The nomination's column-loop route (a panel route other than the
    library LU, e.g. a measured fori entry) selects the reference's
    rows too."""
    from slate_tpu.linalg import ca as jca
    from slate_tpu_torch.linalg import ca as tca
    p = np.random.default_rng(7).standard_normal((128, 8)) \
        .astype(np.float32)
    blocks = p.reshape(4, 32, 8)
    ref = np.asarray(jca._local_pivot_rows(jnp.asarray(blocks)))
    out = tca._local_pivot_rows(torch.as_tensor(blocks))
    assert np.array_equal(out.numpy(), ref)


def test_getrf_tntpiv_matches_jax():
    a, _ = permuted_boosted_system(np.random.default_rng(12), N_V, 1)
    Fj = jst.getrf_tntpiv(jst.Matrix(a, mb=NB_V))
    Ft = st.getrf_tntpiv(st.Matrix(a, mb=NB_V, device="cpu"))
    assert np.array_equal(Ft.pivots.numpy(), np.asarray(Fj.pivots))
    np.testing.assert_allclose(Ft.LU.data.numpy(), np.asarray(Fj.LU.data),
                               rtol=1e-5, atol=1e-5)
    Fr = st.getrf(st.Matrix(a, mb=NB_V, device="cpu"),
                  {st.Option.MethodLU: st.MethodLU.CALU})
    assert torch.equal(Fr.LU.data, Ft.LU.data)
    assert torch.equal(Fr.pivots, Ft.pivots)


def test_tnt_swap_sequence_matches_jax():
    from slate_tpu.linalg import lu as jlu
    rows = np.array([7, 0, 3, 9, 1], np.int32)
    jpiv, jperm = jlu._tnt_swap_sequence(jnp.asarray(rows), 12)
    piv, perm = tlu._tnt_swap_sequence(torch.as_tensor(rows), 12)
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert np.array_equal(perm.numpy()[:5], rows)


@pytest.mark.parametrize("sel,live,wf", [
    ([3, 1, 2, 0], 8, 4),              # healthy: returned as is
    ([3, 9, 2, 11], 8, 4),             # dead rows selected
    ([3, 3, 5, 1], 8, 4),              # a row selected twice
    ([6, 7, 0, 1, 2], 3, 3),           # a live prefix shorter than w
])
def test_fix_degenerate_selection_matches_jax(sel, live, wf):
    from slate_tpu.linalg import ca as jca
    from slate_tpu_torch.linalg import ca as tca
    ref = jca.fix_degenerate_selection(np.array(sel), live, wf)
    out = tca.fix_degenerate_selection(torch.tensor(sel), live, wf)
    assert out.dtype == ref.dtype == np.int64
    assert np.array_equal(out, ref)


def test_fix_degenerate_selection_on_dead_rows_panel():
    """A live-prefix panel (dead rows masked to exact zero, as the
    out-of-core streams mask them) whose last column is zero: every
    candidate ties at |0| there. Both tournaments select the same rows,
    and both repairs return the same live selection."""
    from slate_tpu.linalg import ca as jca
    from slate_tpu_torch.linalg import ca as tca
    p = np.random.default_rng(13).standard_normal((64, 8)) \
        .astype(np.float32)
    live = 40
    p[live:] = 0.0
    p[:, 7] = 0.0
    jsel = np.asarray(jca.tournament_pivot_rows(jnp.asarray(p), chunk=16))
    tsel = tca.tournament_pivot_rows(torch.as_tensor(p), chunk=16).numpy()
    assert np.array_equal(tsel, jsel)
    ref = jca.fix_degenerate_selection(jsel, live, 8)
    out = tca.fix_degenerate_selection(tsel, live, 8)
    assert np.array_equal(out, ref)
    assert (out < live).all() and len(set(out.tolist())) == 8


def test_getri_matches_jax():
    a, _ = permuted_boosted_system(np.random.default_rng(14), N_V, 1)
    Ij = jst.getri(jst.getrf(jst.Matrix(a, mb=NB_V)))
    Ft = st.getrf(st.Matrix(a, mb=NB_V, device="cpu"))
    It = st.getri(Ft)
    np.testing.assert_allclose(It.to_numpy(), Ij.to_numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(Ij.to_numpy()).max())
    assert torch.equal(st.getriOOP(Ft).data, It.data)
    err = np.abs(a.astype(np.float64) @ It.to_numpy() - np.eye(N_V)).max()
    assert err <= 1e-4


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_apply_butterfly_matches_jax(transpose, depth):
    from slate_tpu.linalg import lu as jlu
    rng = np.random.default_rng(15)
    n = 64
    diags = [np.exp(rng.uniform(-0.05, 0.05, n)).astype(np.float32)
             for _ in range(depth)]
    x = rng.standard_normal((n, 5)).astype(np.float32)
    ref = np.asarray(jlu._apply_butterfly([jnp.asarray(d) for d in diags],
                                          jnp.asarray(x), transpose))
    out = tlu._apply_butterfly(diags, torch.as_tensor(x), transpose)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    v = tlu._apply_butterfly(diags, torch.as_tensor(x[:, 0]), transpose)
    np.testing.assert_allclose(v.numpy(), ref[:, 0], rtol=1e-6, atol=1e-6)


def test_gesv_rbt_solves():
    """The butterflies come from a torch.Generator (the reference's
    from a jax key), so the factors differ; both solutions meet the
    backward error, and they agree with each other."""
    a, b = permuted_boosted_system(np.random.default_rng(16), 200, 3)
    b64 = b.astype(np.float64)
    _, Xj = jst.gesv_rbt(jst.Matrix(a, mb=NB_V), jst.Matrix(b, mb=NB_V))
    F, Xt = st.gesv_rbt(st.Matrix(a, mb=NB_V, device="cpu"),
                        st.Matrix(b, mb=NB_V, device="cpu"))
    x = Xt.to_numpy().astype(np.float64)
    a64 = a.astype(np.float64)
    berr = np.linalg.norm(a64 @ x - b64) / (np.linalg.norm(a64)
                                            * np.linalg.norm(x))
    assert berr <= 1e-5
    assert Xt.to_numpy().shape == (200, 3)
    np.testing.assert_allclose(x, Xj.to_numpy(), rtol=1e-4, atol=1e-4)
    g = torch.Generator()
    g.manual_seed(0)
    _, Xg = st.gesv_rbt(st.Matrix(a, mb=NB_V, device="cpu"),
                        st.Matrix(b, mb=NB_V, device="cpu"), generator=g)
    assert torch.equal(Xg.data, Xt.data)


def test_aliases_match_their_targets():
    from slate_tpu_torch.linalg import blas3
    rng = np.random.default_rng(17)
    A = st.Matrix(rng.standard_normal((40, 24)).astype(np.float32), mb=16,
                  device="cpu")
    B = st.Matrix(rng.standard_normal((24, 30)).astype(np.float32), mb=16,
                  device="cpu")
    C = st.Matrix(rng.standard_normal((40, 30)).astype(np.float32), mb=16,
                  device="cpu")
    ref = blas3.gemm(1.5, A, B, 0.5, C)
    for fn in (st.gemmA, st.gemmC):
        assert torch.equal(fn(1.5, A, B, 0.5, C).data, ref.data)
    T = st.TriangularMatrix(st.Uplo.Lower, _dominant(18, 40), mb=16,
                            device="cpu")
    R = st.Matrix(rng.standard_normal((40, 6)).astype(np.float32), mb=16,
                  device="cpu")
    ref = blas3.trsm(st.Side.Left, 2.0, T, R)
    for fn in (st.trsmA, st.trsmB):
        assert torch.equal(fn(st.Side.Left, 2.0, T, R).data, ref.data)
    F = st.geqrf(st.Matrix(_dominant(19, 48), mb=16, device="cpu"))
    Cq = st.Matrix(rng.standard_normal((48, 5)).astype(np.float32), mb=16,
                   device="cpu")
    assert torch.equal(st.qr_multiply_by_q(st.Side.Left, F, Cq).data,
                       st.unmqr(st.Side.Left, F, Cq).data)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rejected_cached_pallas_takes_the_cold_route(dtype, monkeypatch,
                                                     tmp_path):
    """A cached ``pallas`` entry (the rank-1 kernel) whose gate rejects
    the panel (512 wide, past its 256) takes the panel's cold route, as
    a rejected ``pallas_rec`` does: for f32 the library LU (bitwise
    _native_lu, the column loop never entered), for bf16 (no library
    LU; off the card the kernel's gate rejects) the chain ends at the
    column loop. A panel the gate takes keeps the kernel (its plain
    version on the CPU)."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path))
    tcache.reset_cache()
    fori = []
    real_fori = tlu.lu_panel_fori
    monkeypatch.setattr(tlu, "lu_panel_fori",
                        lambda a: fori.append(a.shape) or real_fori(a))
    kernel = []
    real_kernel = pk.lu_panel
    monkeypatch.setattr(pk, "lu_panel",
                        lambda a: kernel.append(a.shape) or real_kernel(a))
    try:
        tcache.get_cache().put("lu_panel", dtype, 512,
                               {"method_lu_panel": "pallas"})
        a, _ = permuted_boosted_system(np.random.default_rng(3), 512, 1)
        a = torch.as_tensor(a).to(dtype)
        lu, piv = tlu._lu_panel(a)
        assert kernel == [(512, 512)]
        if dtype == torch.float32:
            ref_lu, ref_piv = tlu._native_lu(a)
            assert fori == []
        else:
            ref_lu, ref_piv = real_fori(a)
            assert fori == [(512, 512)]
        assert torch.equal(lu, ref_lu) and torch.equal(piv, ref_piv)
        del kernel[:], fori[:]
        lu, piv = tlu._lu_panel(a[:, :256])
        assert kernel == [(512, 256)] and fori == []
        plu, ppiv = pk.lu_panel_plain(a[:, :256])
        assert torch.equal(lu, plu) and torch.equal(piv, ppiv)
    finally:
        tcache.reset_cache()

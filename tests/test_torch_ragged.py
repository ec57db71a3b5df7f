"""slate_tpu_torch's ragged kernels and the queue's ragged strategy
against the JAX package, on the CPU (the counterpart of
tests/test_ragged.py): the port's wrappers take their plain versions
for CPU tensors; the JAX side runs ragged_getrf / ragged_trsm through
the Pallas interpreter. The JAX package's own ragged_potrf does not run
on this jax (pl.load / pl.store are gone), so the port's is held
against numpy's Cholesky and the reference's potrf_core per element,
and the ragged queue routes against the reference's bucket strategy.
The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from slate_tpu import batch as jbatch
from slate_tpu.batch import drivers as jdrivers
from slate_tpu.linalg.lu import lu_panel_fori as j_lu_panel_fori
from slate_tpu.ops import pallas_kernels as jpk
from slate_tpu.tune import cache as jcache

from slate_tpu_torch import batch
from slate_tpu_torch.batch import bucket
from slate_tpu_torch.core.methods import MethodBatchStrategy
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.tune import cache as tcache


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


def _spd(rng, n):
    x = rng.standard_normal((n, n))
    return x @ x.T + n * np.eye(n)


def _stack_garbage(mats, ceil):
    """Stack to the ceiling with GARBAGE in the pad region (the
    reference test's values): nothing the stacker leaves there may
    reach any element's answer."""
    out = np.zeros((len(mats), ceil, ceil), np.asarray(mats[0]).dtype)
    for i, a in enumerate(mats):
        s = a.shape[0]
        out[i, s:, :] = 7.25
        out[i, :, s:] = -3.5
        out[i, :s, :s] = a
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -- ragged_potrf ----------------------------------------------------------

def test_ragged_potrf_adversarial(rng):
    """Orders 1 ... ceiling with garbage in the pad: each [:s, :s] crop
    equals numpy's Cholesky and the reference's potrf_core to 1e-12,
    and the pad comes back as the exact identity."""
    sizes = [1, 33, 70, 96]
    mats = [_spd(rng, s) for s in sizes]
    ceil = 96
    out = pk.ragged_potrf(_t(_stack_garbage(mats, ceil)), np.asarray(sizes))
    assert out is not None and out.dtype == torch.float64
    out = out.numpy()
    for i, s in enumerate(sizes):
        ref = np.linalg.cholesky(mats[i])
        core = np.asarray(jdrivers.potrf_core(jnp.asarray(mats[i])))
        np.testing.assert_allclose(out[i, :s, :s], ref, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(out[i, :s, :s], core, rtol=1e-12,
                                   atol=1e-12)
        assert np.array_equal(out[i, s:, :], np.eye(ceil)[s:])
        assert np.array_equal(out[i, :s, s:], np.zeros((s, ceil - s)))


def test_ragged_potrf_donate_writes_in_place(rng):
    """donate=True may factor in the caller's stack (the plain version
    returns a new tensor, which is allowed); donate=False never writes
    the input."""
    sizes = [20, 32]
    stack = _t(_stack_garbage([_spd(rng, s) for s in sizes], 32))
    before = stack.clone()
    pk.ragged_potrf(stack, sizes, donate=False)
    assert torch.equal(stack, before)


def test_ragged_potrf_bf16_against_f32(rng):
    """bf16: every stored value rounded to bf16 (u = 2^-8), so the
    factor agrees with the f64 Cholesky of the bf16 inputs to a few
    hundredths normwise; the pad is the exact identity."""
    sizes = [17, 64, 40]
    mats = [_spd(rng, s) / s for s in sizes]
    st = _t(_stack_garbage(mats, 64)).to(torch.bfloat16)
    out = pk.ragged_potrf(st, sizes)
    assert out.dtype == torch.bfloat16
    for i, s in enumerate(sizes):
        a = st[i, :s, :s].double().numpy()
        ref = np.linalg.cholesky(a)
        L = out[i, :s, :s].double().numpy()
        assert np.linalg.norm(L - ref) / np.linalg.norm(ref) < 2e-2
        assert torch.equal(out[i, s:].float(), torch.eye(64)[s:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ragged_potrf_plain_partial_stripes(rng, dtype):
    """The plain twin on orders that leave a partial last stripe of 32
    (s mod 32 = 1 and 31), an empty element (s = 0) and the ceiling
    (s = N = 96), garbage in the pad: each live block against numpy's
    Cholesky (f64, of the same stored inputs) and the reference's
    potrf_core (f32), to 1e-5 (f32, relative to the factor's largest
    entry) or 2e-2 normwise (bf16: every stored value rounded to 2^-8);
    the pad, and the whole of the empty element, the exact identity."""
    sizes = [33, 63, 0, 65, 95, 96]
    ceil = 96
    mats = [_spd(rng, s) / max(s, 1) for s in sizes]
    st = _t(_stack_garbage(mats, ceil)).to(dtype)
    out = pk.ragged_potrf_plain(st, sizes, 32)
    assert out.dtype == dtype
    eye = torch.eye(ceil, dtype=torch.float64)
    for i, s in enumerate(sizes):
        assert torch.equal(out[i, s:].double(), eye[s:])
        assert torch.equal(out[i, :s, s:].double(),
                           torch.zeros((s, ceil - s), dtype=torch.float64))
        if s == 0:
            continue
        a = st[i, :s, :s].double().numpy()
        L = out[i, :s, :s].double().numpy()
        ref = np.linalg.cholesky(a)
        core = np.asarray(jdrivers.potrf_core(jnp.asarray(a, jnp.float32)),
                          np.float64)
        for r in (ref, core):
            if dtype == torch.float32:
                assert np.abs(L - r).max() <= 1e-5 * np.abs(r).max()
            else:
                assert np.linalg.norm(L - r) <= 2e-2 * np.linalg.norm(r)
        assert np.array_equal(L, np.tril(L))


# -- ragged_getrf ----------------------------------------------------------

def _getrf_batch(rng, ceil=64):
    mats = []
    a = rng.standard_normal((40, 40))
    mats.append(a[rng.permutation(40)])            # cross-element pivots
    b = rng.standard_normal((33, 33))
    b[:, 7] = 0.0                                  # rank-deficient
    mats.append(b)
    mats.append(np.array([[3.5]]))                 # size 1
    c = rng.standard_normal((ceil, ceil))
    c[5] = c[11]                                   # exact tie rows
    mats.append(c[rng.permutation(ceil)])          # ceiling size
    return mats


def test_ragged_getrf_pivots_match_reference(rng):
    """Pivots bitwise equal to the reference kernel (interpreted) and
    to the per-element lu_panel_fori, values to 1e-11, padded columns
    identity swaps and the pad the identity."""
    ceil = 64
    mats = _getrf_batch(rng, ceil)
    sizes = [m.shape[0] for m in mats]
    stack = _stack_garbage(mats, ceil)
    lu, piv = pk.ragged_getrf(_t(stack), np.asarray(sizes))
    assert piv.dtype == torch.int32
    jlu, jpiv = jpk.ragged_getrf(jnp.asarray(stack), np.asarray(sizes))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-11,
                               atol=1e-11)
    for i, (a, s) in enumerate(zip(mats, sizes)):
        ref_lu, ref_piv = j_lu_panel_fori(jnp.asarray(a))
        np.testing.assert_array_equal(piv[i, :s].numpy(),
                                      np.asarray(ref_piv))
        np.testing.assert_allclose(lu[i, :s, :s].numpy(),
                                   np.asarray(ref_lu), rtol=1e-11,
                                   atol=1e-11)
        np.testing.assert_array_equal(piv[i, s:].numpy(),
                                      np.arange(s, ceil))
        assert np.array_equal(lu[i, s:].numpy(), np.eye(ceil)[s:])


def test_ragged_getrf_matches_scipy(rng):
    sizes = [24, 64, 50]
    mats = [rng.standard_normal((s, s)) + 0.1 * s * np.eye(s)
            for s in sizes]
    lu, piv = pk.ragged_getrf(_t(_stack_garbage(mats, 64)), sizes)
    for i, (a, s) in enumerate(zip(mats, sizes)):
        ref_lu, ref_piv = sla.lu_factor(a)
        np.testing.assert_allclose(lu[i, :s, :s].numpy(), ref_lu,
                                   rtol=1e-9, atol=1e-10)
        np.testing.assert_array_equal(piv[i, :s].numpy(), ref_piv)


def test_ragged_getrf_bf16_matches_reference(rng):
    """bf16 through both kernels (the reference interpreted): pivots
    bitwise, values to 2 bf16 ulps of each element's scale (sums of
    products rounded at the same points, taken in another order)."""
    ceil = 64
    mats = _getrf_batch(rng, ceil)
    sizes = [m.shape[0] for m in mats]
    stack = _stack_garbage(mats, ceil).astype(np.float32)
    st = _t(stack).to(torch.bfloat16)
    lu, piv = pk.ragged_getrf(st, sizes)
    jlu, jpiv = jpk.ragged_getrf(jnp.asarray(st.float().numpy(),
                                             jnp.bfloat16), np.asarray(sizes))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    jl = np.asarray(jlu).astype(np.float32)
    for i, s in enumerate(sizes):
        d = np.abs(lu[i].float().numpy() - jl[i]).max()
        assert d <= 2 * 2.0 ** -7 * max(np.abs(jl[i]).max(), 1.0)


def test_ragged_getrf_c_signature():
    """The ragged LU keeps its C entry; a second entry gives the
    cluster size the launch takes at a ceiling (reports read it from
    there)."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build.LIBS["ragged_getrf"] == (
        "ragged_getrf.cu", {"slate_set_device": [I],
                            "ragged_getrf": [P, P, P, P, I, I, I, I, P],
                            "ragged_getrf_cluster": [I]})


def test_ragged_getrf_ceiling_1024_matches_reference(rng):
    """The gate's largest ceiling on the plain path: an element of order
    1024 (two equal rows, permuted) beside a short one, against the
    reference kernel (interpreted): pivots bitwise, values to 1e-9, the
    pad the identity with identity swaps."""
    ceil = 1024
    c = rng.standard_normal((ceil, ceil))
    c[3] = c[900]
    mats = [c[rng.permutation(ceil)], rng.standard_normal((45, 45))]
    sizes = [m.shape[0] for m in mats]
    stack = _stack_garbage(mats, ceil)
    assert pk.ragged_getrf_eligible(ceil, torch.float64)
    lu, piv = pk.ragged_getrf(_t(stack), np.asarray(sizes))
    jlu, jpiv = jpk.ragged_getrf(jnp.asarray(stack), np.asarray(sizes))
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_array_equal(piv[1, 45:].numpy(), np.arange(45, ceil))
    assert np.array_equal(lu[1, 45:].numpy(), np.eye(ceil)[45:])


# -- ragged_trsm -----------------------------------------------------------

MODES = [(False, False, False),     # posv forward sweep
         (False, True, False),      # posv backward sweep (L^T)
         (True, False, False),      # gesv U back-solve
         (False, False, True),      # gesv unit-L forward sweep
         (True, True, False)]       # U^T


def _trsm_case(rng, upper, sizes=(17, 64, 40), ceil=64, k=3):
    tris, rhss = [], []
    for s in sizes:
        t = rng.standard_normal((s, s)) + 3.0 * s * np.eye(s)
        tris.append(np.tril(t) if not upper else np.triu(t))
        rhss.append(rng.standard_normal((s, k)))
    packed = _stack_garbage(tris, ceil)
    rhs = np.zeros((len(sizes), ceil, k))
    for i, b in enumerate(rhss):
        rhs[i, :b.shape[0]] = b
        rhs[i, b.shape[0]:] = 11.0          # garbage pad rows
    return list(sizes), tris, rhss, packed, rhs


#: one right-hand side (the serving flushes'), orders off the block
#: width (45, 7, 33 against blk 32), the ceiling 64
K1 = {"sizes": (45, 7, 33), "k": 1}


@pytest.mark.parametrize(
    "upper,trans,unit,case",
    [pytest.param(*m, {}, id="-".join(map(str, m))) for m in MODES]
    + [pytest.param(*m, K1, id="-".join(map(str, m)) + "-K1")
       for m in MODES])
def test_ragged_trsm_modes_match_reference(rng, upper, trans, unit, case):
    """Every solve mode the compositions use, plus U^T, with 3
    right-hand sides and (K1) with one: against the reference kernel
    (interpreted) to 1e-10 and scipy per element; padded rhs rows come
    back exact zeros."""
    sizes, tris, rhss, packed, rhs = _trsm_case(rng, upper, **case)
    out = pk.ragged_trsm(_t(packed), _t(rhs), sizes, upper=upper,
                         trans=trans, unit=unit)
    jout = np.asarray(jpk.ragged_trsm(jnp.asarray(packed), jnp.asarray(rhs),
                                      np.asarray(sizes), upper=upper,
                                      trans=trans, unit=unit))
    out = out.numpy()
    for i, (t, b, s) in enumerate(zip(tris, rhss, sizes)):
        ref = sla.solve_triangular(t, b, lower=not upper,
                                   trans=1 if trans else 0,
                                   unit_diagonal=unit)
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(out[i, :s], jout[i, :s], rtol=1e-10,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(out[i, :s], ref, rtol=1e-10,
                                   atol=1e-10 * scale)
        assert np.array_equal(out[i, s:], np.zeros((64 - s, rhs.shape[-1])))


def test_ragged_trsm_bf16_matches_reference(rng):
    """bf16 forward sweep through both kernels: to 2 bf16 ulps of the
    scale (the substitution sums are f32, taken in another order)."""
    sizes, tris, rhss, packed, rhs = _trsm_case(rng, False)
    tb = _t(packed).to(torch.bfloat16)
    bb = _t(rhs).to(torch.bfloat16)
    out = pk.ragged_trsm(tb, bb, sizes).float().numpy()
    jout = np.asarray(jpk.ragged_trsm(
        jnp.asarray(tb.float().numpy(), jnp.bfloat16),
        jnp.asarray(bb.float().numpy(), jnp.bfloat16),
        np.asarray(sizes))).astype(np.float32)
    for i, s in enumerate(sizes):
        scale = max(np.abs(jout[i]).max(), 1e-30)
        assert np.abs(out[i] - jout[i]).max() <= 2 * 2.0 ** -7 * scale


# -- gates, ceiling, report ------------------------------------------------

def test_ragged_eligibility_gates():
    """On the CPU any real float type runs the plain versions (the
    reference's interpreter rule); on the card only f32/bf16, and a
    ceiling that is a positive multiple of blk and at most
    RAGGED_MAX_N. An ineligible entry returns None."""
    cuda = torch.device("cuda")
    assert pk.ragged_potrf_eligible(64, np.float64)
    assert pk.ragged_potrf_eligible(64, torch.float64)
    assert not pk.ragged_potrf_eligible(65, np.float64)
    assert not pk.ragged_potrf_eligible(64, np.complex128)
    assert not pk.ragged_trsm_eligible(64, 0, np.float64)
    assert pk.ragged_trsm_eligible(64, 1, np.float64)
    assert pk.ragged_supported(np.float64)
    assert not pk.ragged_supported(np.complex128)
    assert not pk.ragged_getrf_eligible(64, torch.float64, device=cuda)
    assert pk.ragged_getrf_eligible(64, torch.bfloat16, device=cuda)
    assert pk.ragged_potrf_eligible(1024, torch.float32, device=cuda)
    assert not pk.ragged_potrf_eligible(1056, torch.float32, device=cuda)
    assert not pk.ragged_supported(torch.float32, cuda, n=1025)
    assert pk.ragged_supported(torch.float32, cuda, n=1024)
    assert pk.ragged_supported(torch.float64, n=4096)
    bad = torch.zeros((2, 40, 40), dtype=torch.float64)
    assert pk.ragged_potrf(bad, [40, 40]) is None
    assert pk.ragged_getrf(bad, [40, 40]) is None
    assert pk.ragged_trsm(torch.zeros((2, 64, 64)), torch.zeros((2, 64, 0)),
                          [3, 4]) is None


@pytest.mark.parametrize("blk", [None, 8, 33, 3])
def test_ragged_blk_matches_reference(blk):
    assert pk.ragged_blk(blk) == jpk.ragged_blk(blk)


def test_ragged_ceiling_and_report_match_reference():
    for ns, blk in (([70, 24], 32), ([1], 32), ([96], 32), ([130], 32),
                    ([5, 17], 8)):
        assert bucket.ragged_ceiling(ns, blk=blk) \
            == jbatch.bucket.ragged_ceiling(ns, blk=blk)
    with pytest.raises(ValueError):
        bucket.ragged_ceiling([], blk=32)
    for ns in ([70, 32], [64, 32], [1, 200, 33]):
        assert bucket.ragged_report(ns, 32) \
            == jbatch.bucket.ragged_report(ns, 32)
    rep = bucket.ragged_report([70, 32], 32)
    assert rep["flops_saved"] == pytest.approx(
        (128 ** 3 - 96 ** 3) + (64 ** 3 - 32 ** 3))


# -- the queue's ragged strategy -------------------------------------------

def test_queue_ragged_coalesces_across_buckets(rng):
    """Sizes spanning buckets 64 and 128 merge into ONE ragged dispatch
    (against two bucket dispatches), with less cubic padding, and
    results equal to numpy and to the reference's bucket route."""
    sizes = [24, 40, 70]
    spds = [_spd(rng, s) for s in sizes]
    with batch.CoalescingQueue(max_wait_us=0, strategy="ragged",
                               device="cpu") as qr:
        tickets = [qr.submit("potrf", a) for a in spds]
        qr.flush()
        rag = [t.result() for t in tickets]
    sr = qr.stats()
    with batch.CoalescingQueue(max_wait_us=0, strategy="bucket",
                               device="cpu") as qb:
        tickets = [qb.submit("potrf", a) for a in spds]
        qb.flush()
        buc = [t.result() for t in tickets]
    sb = qb.stats()
    assert sr["dispatches"] == 1 and sr["ragged_dispatches"] == 1
    assert sb["dispatches"] == 2 and sb["ragged_dispatches"] == 0
    assert sr["mean_padding_waste_flops"] < sb["mean_padding_waste_flops"]
    assert sr["ragged_flops_saved"] > 0
    jbuc = jbatch.run("potrf", spds, strategy="bucket")
    for a, r, b, jb in zip(spds, rag, buc, jbuc):
        np.testing.assert_allclose(r.numpy(), np.linalg.cholesky(a),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(r.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(r.numpy(), np.asarray(jb), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("op", ["posv", "gesv"])
def test_queue_ragged_solves_match_reference_bucket(rng, op):
    """posv/gesv through the ragged route: heterogeneous orders,
    two-column rhs, answers equal to the reference's bucket route to
    1e-10 and solving A x = b to 1e-8."""
    sizes = [9, 33, 64]
    if op == "posv":
        mats = [_spd(rng, s) for s in sizes]
    else:
        mats = [rng.standard_normal((s, s)) + 0.1 * s * np.eye(s)
                for s in sizes]
    rhss = [rng.standard_normal((s, 2)) for s in sizes]
    outs = batch.run(op, mats, rhs=rhss, strategy="ragged", device="cpu")
    refs = jbatch.run(op, mats, rhs=rhss, strategy="bucket")
    for x, r, a, b in zip(outs, refs, mats, rhss):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(a @ x.numpy(), b, rtol=1e-8, atol=1e-8)


def test_queue_ragged_getrf_roundtrip(rng):
    """getrf through the ragged route equals the reference's ragged
    route (pivots bitwise) and scipy."""
    sizes = [12, 40]
    mats = [rng.standard_normal((s, s)) + s * np.eye(s) for s in sizes]
    outs = batch.run("getrf", mats, strategy="ragged", device="cpu")
    refs = jbatch.run("getrf", mats, strategy="ragged")
    for (lu, piv), (jlu, jpiv), a in zip(outs, refs, mats):
        np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
        np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-11,
                                   atol=1e-11)
        ref_lu, ref_piv = sla.lu_factor(a)
        np.testing.assert_allclose(lu.numpy(), ref_lu, rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_array_equal(piv.numpy(), ref_piv)


@pytest.mark.parametrize("op", ["potrs", "getrs"])
def test_ragged_dispatch_solve_only_ops(rng, op):
    """The solve-only ops on cached factors: one ragged_trsm pair,
    equal to the bucket cores on the same factors."""
    sizes = [9, 30]
    if op == "potrs":
        facs = [np.linalg.cholesky(_spd(rng, s)) for s in sizes]
    else:
        facs = [sla.lu_factor(rng.standard_normal((s, s))
                              + s * np.eye(s))[0] for s in sizes]
    rhss = [rng.standard_normal((s, 1)) for s in sizes]
    stack = np.stack([bucket.pad_square(f, 32).numpy() for f in facs])
    rhs = np.stack([bucket.pad_rhs(b, 32, 1).numpy() for b in rhss])
    out = batch.ragged_dispatch(op, stack, sizes, rhs, device="cpu")
    ref = batch.drivers._dispatch(op, _t(stack), _t(rhs))
    for i, s in enumerate(sizes):
        np.testing.assert_allclose(out[i, :s].numpy(), ref[i, :s].numpy(),
                                   rtol=1e-10, atol=1e-12)


def test_ragged_dispatch_rejects():
    with pytest.raises(ValueError, match="no ragged route"):
        batch.ragged_dispatch("geqrf", np.zeros((1, 32, 32)), [3],
                              device="cpu")
    with pytest.raises(ValueError, match="ineligible"):
        batch.ragged_dispatch("potrf", np.zeros((1, 40, 40)), [3],
                              device="cpu")
    with pytest.raises(ValueError, match="right-hand"):
        batch.ragged_dispatch("posv", np.zeros((1, 32, 32)), [3],
                              device="cpu")


def test_cold_route_is_bucket_bitwise(rng):
    """The FROZEN ``batch/strategy`` row is "bucket": a cold tune cache
    coalesces exactly as an explicit bucket queue, bitwise."""
    q = batch.CoalescingQueue(device="cpu")
    assert q._strategy is MethodBatchStrategy.Bucket
    q.close()
    spds = [_spd(rng, s) for s in (24, 70)]
    cold = batch.run("potrf", spds, device="cpu")
    explicit = batch.run("potrf", spds, strategy="bucket", device="cpu")
    for a, b in zip(cold, explicit):
        assert torch.equal(a, b)


def test_tuned_strategy_routes_ragged(rng):
    """An earned ``batch/strategy`` = "ragged" cache row flips the
    queue's Auto route; an unknown value demotes to Bucket."""
    tcache.get_cache().put("batch", None, None, {"strategy": "ragged"})
    q = batch.CoalescingQueue(device="cpu")
    assert q._strategy is MethodBatchStrategy.Ragged
    q.close()
    spds = [_spd(rng, s) for s in (10, 33)]
    with batch.CoalescingQueue(device="cpu") as q:
        outs = [q.submit("potrf", a) for a in spds]
        q.flush()
        outs = [t.result() for t in outs]
    assert q.stats()["ragged_dispatches"] == 1
    for L, a in zip(outs, spds):
        np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(a),
                                   rtol=1e-10, atol=1e-10)
    tcache.reset_cache()
    tcache.get_cache().put("batch", None, None, {"strategy": "hexagonal"})
    q = batch.CoalescingQueue(device="cpu")
    assert q._strategy is MethodBatchStrategy.Bucket
    q.close()


def test_ragged_ineligible_dtype_degrades_to_bucket(rng):
    """A complex request keeps the bucket path under strategy="ragged":
    a correct answer and no ragged dispatch."""
    n = 12
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a = x @ np.conj(x.T) + n * np.eye(n)
    with batch.CoalescingQueue(max_wait_us=0, strategy="ragged",
                               device="cpu") as q:
        t = q.submit("potrf", a)
        q.flush()
        L = t.result().numpy()
    assert q.stats()["ragged_dispatches"] == 0
    np.testing.assert_allclose(L @ np.conj(L.T), a, rtol=1e-10, atol=1e-9)


def test_ragged_zero_column_rhs_degrades_to_bucket(rng):
    a = _spd(rng, 12)
    with batch.CoalescingQueue(max_wait_us=0, strategy="ragged",
                               device="cpu") as q:
        t = q.submit("posv", a, np.zeros((12, 0)))
        q.flush()
        x = t.result()
    assert tuple(x.shape) == (12, 0)
    assert q.stats()["ragged_dispatches"] == 0


def test_ragged_submit_snapshots_operands(rng):
    """submit() captures the operand VALUES: mutating the caller's
    arrays between submit and flush does not change the answer."""
    a = _spd(rng, 20)
    b = rng.standard_normal((20, 2))
    a0, b0 = a.copy(), b.copy()
    with batch.CoalescingQueue(max_wait_us=10 ** 7, strategy="ragged",
                               device="cpu") as q:
        t = q.submit("posv", a, b)
        a[:] = 0.0
        b[:] = 0.0
        q.flush()
        x = t.result().numpy()
    np.testing.assert_allclose(a0 @ x, b0, rtol=1e-9, atol=1e-9)


def test_mean_occupancy_weighted(rng):
    """Each dispatch weighted by its scheduled cubic extent, as the
    reference."""
    small = [_spd(rng, 10)]
    big = [_spd(rng, 70), _spd(rng, 100)]
    with batch.CoalescingQueue(max_wait_us=0, device="cpu") as q:
        for a in small:
            q.submit("potrf", a)
        q.flush()
        for a in big:
            q.submit("potrf", a)
        q.flush()
    s = q.stats()
    f1, f2 = 1 * 64.0 ** 3, 2 * 128.0 ** 3
    assert s["mean_occupancy_weighted"] == pytest.approx(
        (1 * f1 + 2 * f2) / (f1 + f2))
    assert s["mean_occupancy"] == pytest.approx(1.5)


def test_ragged_queue_bf16(rng):
    """A bf16 posv on the ragged route (torch tensors in, since numpy
    has no bf16): the answer within a few hundredths of the f64 solve
    of the bf16 system, as the bf16 factor and sweeps round."""
    sizes = [17, 40]
    mats = [torch.as_tensor(_spd(rng, s) / s).to(torch.bfloat16)
            for s in sizes]
    rhss = [torch.as_tensor(rng.standard_normal((s, 1))).to(torch.bfloat16)
            for s in sizes]
    with batch.CoalescingQueue(strategy="ragged", device="cpu") as q:
        ts = [q.submit("posv", a, b) for a, b in zip(mats, rhss)]
        q.flush()
        xs = [t.result() for t in ts]
    assert q.stats()["ragged_dispatches"] == 1
    for x, a, b in zip(xs, mats, rhss):
        assert x.dtype == torch.bfloat16
        ref = np.linalg.solve(a.double().numpy(), b.double().numpy())
        assert np.linalg.norm(x.double().numpy() - ref) \
            / np.linalg.norm(ref) < 5e-2

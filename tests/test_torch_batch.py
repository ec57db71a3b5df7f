"""slate_tpu_torch.batch against the JAX package's batch layer on the
CPU (the counterpart of tests/test_batch.py): ladders and pads, the
nine batched drivers on the same stacks, validation, and the
coalescing queue (stats, batch-1 against coalesced, max_batch splits,
forced flushes, the background flusher and its death)."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

from slate_tpu import batch as jbatch
from slate_tpu.batch import bucket as jbucket
from slate_tpu.batch import drivers as jdrivers
from slate_tpu.tune import cache as jcache

from slate_tpu_torch import batch
from slate_tpu_torch.batch import bucket, drivers
from slate_tpu_torch.tune import cache as tcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def tune_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    yield
    tcache.reset_cache()
    jcache.reset_cache()


@pytest.fixture
def problems(rng):
    sizes = [24, 32, 40]
    mats, spds, rhss = [], [], []
    for n in sizes:
        x = rng.standard_normal((n, n))
        mats.append(x + n * np.eye(n) * 0.1)
        spds.append(x @ x.T + n * np.eye(n))
        rhss.append(rng.standard_normal((n, 2)))
    return sizes, mats, spds, rhss


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ladders and pads ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 1024, 1500])
def test_bucket_for_matches_reference(n):
    assert bucket.bucket_for(n) == jbucket.bucket_for(n)
    assert bucket.bucket_ladder(n) == jbucket.bucket_ladder(n)


@pytest.mark.parametrize("m,n", [(40, 20), (100, 30), (64, 64), (70, 65)])
def test_rect_buckets_match_reference(m, n):
    bm, bn = bucket.rect_buckets(m, n)
    assert (bm, bn) == jbucket.rect_buckets(m, n)
    assert bm - m >= bn - n


@pytest.mark.parametrize("mode", ["identity", "shift", "zero"])
def test_pad_square_matches_reference(rng, mode):
    a = rng.standard_normal((5, 5))
    a = a + a.T
    p = bucket.pad_square(a, 8, mode)
    assert isinstance(p, torch.Tensor) and p.dtype == torch.float64
    assert np.array_equal(p.numpy(), jbucket.pad_square(a, 8, mode))


def test_pad_errors_and_rect(rng):
    a = rng.standard_normal((5, 5))
    with pytest.raises(ValueError):
        bucket.pad_square(a, 4)
    with pytest.raises(ValueError):
        bucket.pad_square(a, 8, "bogus")
    m, n = 12, 6
    r = rng.standard_normal((m, n))
    bm, bn = bucket.rect_buckets(m, n)
    assert np.array_equal(bucket.pad_rect(r, bm, bn).numpy(),
                          jbucket.pad_rect(r, bm, bn))
    with pytest.raises(ValueError):
        bucket.pad_rect(r, m + 1, n + 8)
    b = rng.standard_normal((5, 2))
    assert np.array_equal(bucket.pad_rhs(b, 8, 3).numpy(),
                          jbucket.pad_rhs(b, 8, 3))
    # bf16, which numpy lacks, pads as a torch tensor
    p = bucket.pad_square(torch.ones((3, 3), dtype=torch.bfloat16), 8)
    assert p.dtype == torch.bfloat16 and float(p[7, 7]) == 1.0


def test_padding_waste_and_report_match_reference():
    assert bucket.padding_waste([2], 4, exponent=2) == pytest.approx(
        1 - 4 / 16)
    assert bucket.padding_waste([2], 4, exponent=3) == pytest.approx(
        1 - 8 / 64)
    assert bucket.padding_waste([4, 4], 4) == 0.0
    for ns, mb in (([(2, 2), (4, 4)], 4), ([10, 30], 64)):
        assert bucket.stack_report(ns, mb) == jbucket.stack_report(ns, mb)


def test_batch_align_is_tuned():
    from slate_tpu_torch.core.options import Option
    assert bucket.batch_align() == 8 == bucket.ALIGN
    tcache.get_cache().put("batch", None, None, {"align": 128})
    assert bucket.batch_align() == 128
    assert all(r % 128 == 0 for r in bucket.bucket_ladder(1024))
    assert bucket.ragged_ceiling([70], blk=32) == 128
    assert bucket.bucket_for(30, align=8) == 64
    assert bucket.batch_align(opts={Option.Tune: False}) == 8
    q = batch.CoalescingQueue(opts={Option.Tune: False}, device="cpu")
    assert q._align == 8
    q.close()


# -- the batched drivers against the reference's -------------------------

def _stacks(rng, B=3, n=48):
    xs = rng.standard_normal((B, n, n))
    spd = np.einsum("bij,bkj->bik", xs, xs) + n * np.eye(n)
    gen = xs + 0.1 * n * np.eye(n)
    rhs = rng.standard_normal((B, n, 2))
    return spd, gen, rhs


@pytest.mark.parametrize("nb", [16, 256])
def test_potrf_batched_matches_reference(rng, nb):
    spd, _, _ = _stacks(rng)
    got = drivers.potrf_batched(spd, nb=nb, device="cpu")
    ref = jdrivers.potrf_batched(jnp.asarray(spd), nb=nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    assert torch.equal(got, torch.tril(got))


@pytest.mark.parametrize("nb", [16, 256])
def test_getrf_batched_pivots_bitwise(rng, nb):
    _, gen, _ = _stacks(rng)
    lu, piv = drivers.getrf_batched(gen, nb=nb, device="cpu")
    jlu, jpiv = jdrivers.getrf_batched(jnp.asarray(gen), nb=nb)
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-11,
                               atol=1e-11)


def test_geqrf_batched_matches_reference(rng):
    a = rng.standard_normal((3, 40, 24))
    pk_, taus = drivers.geqrf_batched(a, nb=16, ib=8, device="cpu")
    jp, jt = jdrivers.geqrf_batched(jnp.asarray(a), nb=16, ib=8)
    np.testing.assert_allclose(pk_.numpy(), np.asarray(jp), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(taus.numpy(), np.asarray(jt), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("op", ["posv", "gesv"])
def test_solve_batched_matches_reference(rng, op):
    spd, gen, rhs = _stacks(rng)
    a = spd if op == "posv" else gen
    fn = getattr(drivers, op + "_batched")
    got = fn(a, rhs, nb=16, device="cpu")
    ref = getattr(jdrivers, op + "_batched")(jnp.asarray(a),
                                             jnp.asarray(rhs), nb=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("op", ["potrs", "getrs"])
def test_solve_only_batched_matches_reference(rng, op):
    spd, gen, rhs = _stacks(rng)
    if op == "potrs":
        fac = np.linalg.cholesky(spd)
    else:
        fac = np.stack([sla.lu_factor(g)[0] for g in gen])
    got = getattr(drivers, op + "_batched")(fac, rhs, device="cpu")
    ref = getattr(jdrivers, op + "_batched")(jnp.asarray(fac),
                                             jnp.asarray(rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_gels_batched_matches_reference(rng):
    a = rng.standard_normal((2, 40, 20))
    b = rng.standard_normal((2, 40, 2))
    got = drivers.gels_batched(a, b, nb=8, ib=4, device="cpu")
    ref = jdrivers.gels_batched(jnp.asarray(a), jnp.asarray(b), nb=8, ib=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)
    for i in range(2):
        np.testing.assert_allclose(
            got[i].numpy(), np.linalg.lstsq(a[i], b[i], rcond=None)[0],
            rtol=1e-9, atol=1e-10)


def test_heev_batched_matches_reference(rng):
    x = rng.standard_normal((3, 20, 20))
    h = (x + x.transpose(0, 2, 1)) / 2
    w, v = drivers.heev_batched(h, device="cpu")
    jw, jv = jdrivers.heev_batched(jnp.asarray(h))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-10,
                               atol=1e-10)
    # eigenvectors up to sign: |V^T V_ref| is the identity
    np.testing.assert_allclose(
        np.abs(np.einsum("bji,bjk->bik", v.numpy(), np.asarray(jv))),
        np.broadcast_to(np.eye(20), (3, 20, 20)), atol=1e-8)


def test_bf16_stacks_run(rng):
    """bf16 stacks through the cores: potrf (f32 factor rounded), gesv
    (the fori panel in bf16), geqrf (element-wise panels), within
    bf16 rounding of the f64 answers."""
    spd, gen, rhs = _stacks(rng, B=2, n=24)
    spd, gen = spd / 24, gen + 24 * np.eye(24)      # cond O(1)
    sb, gb, rb = (torch.as_tensor(x).to(torch.bfloat16)
                  for x in (spd, gen, rhs))
    L = drivers.potrf_batched(sb, device="cpu")
    ref = np.linalg.cholesky(sb.double().numpy())
    assert np.linalg.norm(L.double().numpy() - ref) \
        / np.linalg.norm(ref) < 2e-2
    x = drivers.gesv_batched(gb, rb, device="cpu")
    xr = np.linalg.solve(gb.double().numpy(), rb.double().numpy())
    assert np.linalg.norm(x.double().numpy() - xr) \
        / np.linalg.norm(xr) < 5e-2
    p, t = drivers.geqrf_batched(gb, device="cpu")
    r = np.triu(p.double().numpy())
    rr = np.linalg.qr(gb.double().numpy())[1]
    np.testing.assert_allclose(np.abs(np.diagonal(r, axis1=1, axis2=2)),
                               np.abs(np.diagonal(rr, axis1=1, axis2=2)),
                               rtol=5e-2)


def test_batched_driver_input_validation(rng):
    a2 = rng.standard_normal((4, 4))
    with pytest.raises(ValueError, match="stacked"):
        drivers.potrf_batched(a2, device="cpu")
    with pytest.raises(ValueError, match="square"):
        drivers.potrf_batched(rng.standard_normal((2, 4, 6)), device="cpu")
    with pytest.raises(ValueError, match="right-hand"):
        drivers.gesv_batched(rng.standard_normal((2, 4, 4)), None,
                             device="cpu")
    with pytest.raises(ValueError, match="overdetermined"):
        drivers.gels_batched(rng.standard_normal((2, 4, 6)),
                             rng.standard_normal((2, 4, 1)), device="cpu")
    with pytest.raises(ValueError, match="rhs must be"):
        drivers.posv_batched(rng.standard_normal((2, 4, 4)),
                             rng.standard_normal((2, 5, 1)), device="cpu")


def test_batched_entry_without_device_needs_a_card(rng, monkeypatch):
    """No silent CPU fall back: without a card, an entry given no
    device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drivers.potrf_batched(np.eye(4)[None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.CoalescingQueue()


# -- the coalescing queue --------------------------------------------------

def test_queue_round_trips_match_reference(problems):
    """run() through both packages' bucket strategies on the same
    requests: potrf, gesv, posv, getrf (pivots bitwise), heev, gels,
    geqrf."""
    sizes, mats, spds, rhss = problems
    for op, ms, rs in (("potrf", spds, None), ("posv", spds, rhss),
                       ("gesv", mats, rhss)):
        got = batch.run(op, ms, rhs=rs, device="cpu")
        ref = jbatch.run(op, ms, rhs=rs)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-10,
                                       atol=1e-11)
    for (lu, piv), (jlu, jpiv) in zip(batch.run("getrf", mats,
                                                device="cpu"),
                                      jbatch.run("getrf", mats)):
        np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
        np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-11,
                                   atol=1e-11)
    herm = [(m + m.T) / 2 for m in mats]
    for (w, v), a in zip(batch.run("heev", herm, device="cpu"), herm):
        np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(a),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a @ v.numpy(), v.numpy() * w.numpy(),
                                   atol=1e-8)
    gm = [np.random.default_rng(3).standard_normal((2 * n, n))
          for n in (10, 17)]
    gb = [np.random.default_rng(4).standard_normal((2 * n, 2))
          for n in (10, 17)]
    for x, r in zip(batch.run("gels", gm, rhs=gb, device="cpu"),
                    jbatch.run("gels", gm, rhs=gb)):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-10)
    for (p, t), a in zip(batch.run("geqrf", gm, device="cpu"), gm):
        n = a.shape[1]
        np.testing.assert_allclose(np.abs(np.diag(np.triu(p.numpy())[:n])),
                                   np.abs(np.diag(np.linalg.qr(a)[1])),
                                   rtol=1e-9)
        assert t.shape[0] == n


def test_queue_coalesces_and_reports(problems):
    sizes, mats, spds, rhss = problems
    with batch.CoalescingQueue(max_batch=8, max_wait_us=0,
                               device="cpu") as q:
        tickets = [q.submit("potrf", a) for a in spds]
        assert q.pending() == len(spds)
        assert list(q.stats()["pending_by_key"].values())[0]["count"] == 3
        q.flush()
        outs = [t.result() for t in tickets]
    s = q.stats()
    assert s["dispatches"] == 1 and s["requests"] == 3
    assert s["dispatches_saved"] == 2 and s["max_occupancy"] == 3
    assert 0 < s["mean_padding_waste"] < 1
    assert s["pending_by_key"] == {}
    for L, a in zip(outs, spds):
        np.testing.assert_allclose(L.numpy() @ L.numpy().T, a, rtol=1e-10,
                                   atol=1e-9)
        assert tickets[0].latency_s is not None


@pytest.mark.parametrize("op", ["potrf", "gesv"])
def test_queue_batch1_bitwise_vs_coalesced(problems, op):
    """Per-request dispatch (occupancy 1) is bit-identical to the
    coalesced dispatch on the CPU (the reference's determinism
    contract)."""
    _sizes, mats, spds, rhss = problems
    ms, rs = (spds, None) if op == "potrf" else (mats, rhss)
    with batch.CoalescingQueue(max_batch=1, device="cpu") as q1:
        singles = [q1.submit(op, a, *([] if rs is None else [b])).result()
                   for a, b in zip(ms, rs or ms)]
    assert q1.stats()["dispatches"] == len(ms)
    coalesced = batch.run(op, ms, rhs=rs, device="cpu")
    for a, b in zip(singles, coalesced):
        assert torch.equal(a, b)


def test_queue_max_batch_splits(problems):
    _sizes, _mats, spds, _ = problems
    with batch.CoalescingQueue(max_batch=2, max_wait_us=0,
                               device="cpu") as q:
        tickets = [q.submit("potrf", a) for a in spds]
        q.flush()
        [t.result() for t in tickets]
    assert q.stats()["dispatches"] == 2


def test_queue_result_forces_flush(problems):
    _sizes, _mats, spds, _ = problems
    with batch.CoalescingQueue(max_batch=64, max_wait_us=10 ** 7,
                               device="cpu") as q:
        t = q.submit("potrf", spds[0])
        L = t.result(timeout=60).numpy()
    np.testing.assert_allclose(L @ L.T, spds[0], rtol=1e-10, atol=1e-9)


def test_queue_background_flusher(problems):
    _sizes, _mats, spds, _ = problems
    q = batch.CoalescingQueue(max_batch=64, max_wait_us=2000,
                              background=True, device="cpu")
    try:
        t = q.submit("potrf", spds[0])
        deadline = time.time() + 10
        while not t.done() and time.time() < deadline:
            time.sleep(0.01)
        assert t.done(), "max-wait deadline never flushed the bucket"
    finally:
        q.close()
    assert not q._flusher.is_alive()


@pytest.mark.parametrize("strategy,fail", [("bucket", False),
                                           ("ragged", False),
                                           ("bucket", True)])
def test_queue_counts_flush_before_result(problems, monkeypatch, strategy,
                                          fail):
    """A flush is counted before its tickets resolve, on the bucket and
    the ragged flush and when the dispatch fails: through the background
    flusher, the dispatch count read right after result() already holds
    the flush, every time (counted after resolving, a reader could see
    it lag). The count is made slow so that a lag would show."""
    _sizes, _mats, spds, _ = problems
    q = batch.CoalescingQueue(max_batch=64, max_wait_us=100,
                              background=True, strategy=strategy,
                              device="cpu")
    record = q._record

    def slow_record(*args, **kw):
        time.sleep(0.005)
        record(*args, **kw)

    monkeypatch.setattr(q, "_record", slow_record)
    if fail:
        def boom(op, fn):
            raise ValueError("dispatch boom")
        monkeypatch.setattr(q, "_dispatch_guarded", boom)
    try:
        for k in range(1, 21):
            t = q.submit("potrf", spds[k % 3])
            deadline = time.time() + 10     # the flusher resolves it
            while not t.done() and time.time() < deadline:
                time.sleep(0.0005)
            assert t.done()
            if fail:
                with pytest.raises(ValueError, match="dispatch boom"):
                    t.result(timeout=60)
            else:
                t.result(timeout=60)
            assert q.stats()["dispatches"] == k
    finally:
        q.close()


def test_queue_flusher_death_fails_pending(problems, monkeypatch):
    """A dying background flusher fails every pending ticket with its
    death error instead of leaving it to hang; result() raises it."""
    _sizes, _mats, spds, _ = problems
    q = batch.CoalescingQueue(max_batch=64, max_wait_us=10 ** 7,
                              background=True, device="cpu")
    t = q.submit("potrf", spds[0])
    boom = RuntimeError("flusher boom")
    died = threading.Event()
    orig = q._on_flusher_death

    def death(e):
        orig(e)
        died.set()

    monkeypatch.setattr(q, "_on_flusher_death", death)
    monkeypatch.setattr(q._wake, "clear",
                        lambda: (_ for _ in ()).throw(boom))
    q._wake.set()
    assert died.wait(10)
    assert t.done()
    with pytest.raises(RuntimeError, match="flusher died") as ei:
        t.result(timeout=1)
    assert ei.value.__cause__ is boom
    # degraded synchronous mode: new submits still resolve
    L = q.submit("potrf", spds[1]).result(timeout=60)
    assert L.shape == (32, 32)
    q._closed = True


def test_queue_submit_validation(problems):
    _sizes, mats, spds, rhss = problems
    with batch.CoalescingQueue(device="cpu") as q:
        with pytest.raises(ValueError, match="unknown batched op"):
            q.submit("svd", spds[0])
        with pytest.raises(ValueError, match="square"):
            q.submit("potrf", np.zeros((4, 6)))
        with pytest.raises(ValueError, match="right-hand"):
            q.submit("gesv", mats[0])
        with pytest.raises(ValueError, match="rhs rows"):
            q.submit("gesv", mats[0], np.zeros((7, 1)))
        with pytest.raises(ValueError, match="rhs dtype"):
            q.submit("gesv", mats[0].astype(np.float32), rhss[0])
        with pytest.raises(ValueError, match="2-D"):
            q.submit("potrf", np.zeros((2, 4, 4)))
    with pytest.raises(RuntimeError, match="closed"):
        q.submit("potrf", spds[0])


def test_queue_batch_pads_to_pow2(problems):
    """Three requests of one bucket dispatch as a batch of 3: eager
    launches take any batch, so the queue does not round it up to a
    power of two as the reference does (for XLA's compiled shapes)."""
    _sizes, _mats, spds, _ = problems
    seen = []
    orig = drivers._dispatch

    def spy(op, stack, rhs=None, **kw):
        seen.append(stack.shape[0])
        return orig(op, stack, rhs, **kw)

    drivers._dispatch = spy
    try:
        out = batch.run("potrf", spds, device="cpu")
    finally:
        drivers._dispatch = orig
    assert seen == [3]
    assert [o.shape for o in out] == [a.shape for a in spds]


def test_obs_instant_per_flush(problems):
    from slate_tpu_torch.obs import events as obs
    _sizes, _mats, spds, _ = problems
    obs.enable()
    obs.clear()
    try:
        batch.run("potrf", spds, device="cpu")
        evs = [e for e in obs.events() if e.name == "batch:potrf"]
    finally:
        obs.disable()
        obs.clear()
    assert len(evs) == 1 and evs[0].args["occupancy"] == 3


def test_batch_package_imports_no_jax():
    """slate_tpu_torch.batch imports neither jax nor slate_tpu (checked
    in a fresh interpreter)."""
    code = ("import sys\n"
            "import slate_tpu_torch.batch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'slate_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

"""slate_tpu_torch/ops/kernels.py against the JAX package's Pallas
kernels, on the CPU: the port's wrappers take their plain versions for
CPU tensors, the JAX side runs its kernels through the Pallas
interpreter (pallas_interpret() is on by default off-TPU), as its own
tests do. The CUDA kernels themselves run only on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slate_tpu.linalg.lu import lu_panel_fori as j_lu_panel_fori
from slate_tpu.ops import pallas_kernels as jpk
from slate_tpu.tune import cache as jcache

from slate_tpu_torch.linalg.lu import lu_panel_fori
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import EXACT_KINDS, panel_cases, spiked
from slate_tpu_torch.tune import cache as tcache

KINDS = ("antidiag", "boundary", "randperm", "ties", "zerocol")


@pytest.fixture(autouse=True)
def tune_env(tmp_path, monkeypatch):
    """Isolated tune caches for both packages (a measured entry must
    not change the ib or routing the comparisons were written for)."""
    monkeypatch.setenv("SLATE_TPU_TORCH_TUNE_CACHE", str(tmp_path / "t"))
    monkeypatch.setenv("SLATE_TPU_TUNE_CACHE", str(tmp_path / "j"))
    tcache.reset_cache()
    jcache.reset_cache()
    yield
    tcache.reset_cache()
    jcache.reset_cache()


@pytest.fixture(scope="module")
def adversarial():
    """The adversarial suite (m=256, w=32, ib=8) through the JAX kernel
    and the JAX fori oracle, once."""
    cases = panel_cases(np.random.default_rng(42), 256, 32, 8)
    out = {}
    for kind, a in cases.items():
        jp, jpiv = jpk.lu_panel_rec(jnp.asarray(a), ib=8)
        fp, fpiv = j_lu_panel_fori(jnp.asarray(a))
        out[kind] = (a, np.asarray(jp), np.asarray(jpiv), np.asarray(fp),
                     np.asarray(fpiv))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_lu_panel_rec_adversarial_matches_jax(adversarial, kind):
    a, jp, jpiv, fp, fpiv = adversarial[kind]
    packed, piv = pk.lu_panel_rec(torch.as_tensor(a), ib=8)
    assert piv.dtype == torch.int32
    # the spikes force the pivot sequence: bitwise, against both the
    # JAX kernel and the fori oracle
    assert np.array_equal(piv.numpy(), jpiv)
    assert np.array_equal(piv.numpy(), fpiv)
    if kind in EXACT_KINDS:
        # zero-noise panels: every operation is exact, so the packed
        # factors match bitwise
        assert np.array_equal(packed.numpy(), jp)
        assert np.array_equal(packed.numpy(), fp)
    else:
        # dyadic noise: pivots are forced but the update order differs
        # (rank-ib products vs the rank-1 chain), so values agree to
        # f32 rounding only — the JAX test's own tolerance
        np.testing.assert_allclose(packed.numpy(), jp, atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(packed.numpy(), fp, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_lu_panel_fori_matches_jax(adversarial, kind):
    # the port's oracle against the reference's oracle: the same
    # column loop. XLA on the CPU contracts the rank-1 update into a
    # fused multiply-add where torch rounds the product first, so the
    # noise kinds differ by an ulp or two (1e-6 relative, or absolute
    # for values near 0); the exact kinds match bitwise
    a, _, _, fp, fpiv = adversarial[kind]
    p, piv = lu_panel_fori(torch.as_tensor(a))
    assert np.array_equal(piv.numpy(), fpiv)
    if kind in EXACT_KINDS:
        assert np.array_equal(p.numpy(), fp)
    else:
        np.testing.assert_allclose(p.numpy(), fp, atol=1e-6, rtol=1e-6)


def test_lu_panel_rec_default_ib_matches_jax():
    # the frozen ib (tune ("lu_panel", "ib") = 32), w = ib * 2^2
    rng = np.random.default_rng(3)
    m, w = 256, 128
    a = spiked(rng, m, w, [m - 1 - j for j in range(w)])
    jp, jpiv = jpk.lu_panel_rec(jnp.asarray(a))
    packed, piv = pk.lu_panel_rec(torch.as_tensor(a))
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    # f32 rounding of differently ordered updates, as the JAX test
    np.testing.assert_allclose(packed.numpy(), np.asarray(jp), atol=1e-4)


def test_lu_panel_rec_reconstructs_random_panel():
    # generic panel (pivots not forced): P A = L U to f32 accuracy
    rng = np.random.default_rng(5)
    m, w = 256, 64
    a = rng.standard_normal((m, w)).astype(np.float32)
    packed, piv = pk.lu_panel_rec(torch.as_tensor(a), ib=16)
    perm = pk.lu_pivots_to_permutation(piv, m).numpy()
    L = np.tril(packed.numpy(), -1)[:, :w] + np.eye(m, w, dtype=np.float32)
    U = np.triu(packed.numpy()[:w])
    # entries are O(1) and each is a sum of <= w products: 1e-4
    # absolute is a few hundred f32 ulps
    np.testing.assert_allclose(a[perm], L @ U, atol=1e-4)


def test_lu_panel_rec_tall_split_matches_jax():
    """The tall-panel path with the single-dispatch budget forced down
    to (m, 8): two host-level splits and two trailing updates, with the
    pivot sequence bitwise equal to the JAX split and the fori oracle."""
    rng = np.random.default_rng(7)
    m, w = 1024, 32
    a = (rng.integers(-8, 9, (m, w)) / 16.0).astype(np.float32)
    for j in range(w):
        a[m - 1 - j, j] = 64.0
    calls = []
    orig = pk._rank_update

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return orig(*args)

    pk._rank_update, saved = spy, pk._rank_update
    try:
        packed, piv = pk.lu_panel_rec(torch.as_tensor(a), ib=8,
                                      max_elems=m * 8)
    finally:
        pk._rank_update = saved
    assert calls == [(m - 8, 8), (m - 16, 16), (m - 24, 8)]
    jp, jpiv = jpk.lu_panel_rec(jnp.asarray(a), ib=8, max_elems=m * 8)
    fp, fpiv = j_lu_panel_fori(jnp.asarray(a))
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert np.array_equal(piv.numpy(), np.asarray(fpiv))
    # differently ordered f32 updates of O(1) values (the JAX test's
    # tolerance)
    np.testing.assert_allclose(packed.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(packed.numpy(), np.asarray(fp), atol=1e-4)


@pytest.mark.parametrize("m2,w1,w2", [(256, 16, 32), (16128, 32, 16),
                                      (200, 24, 40)])
def test_rank_update_matches_jax(m2, w1, w2):
    """A22 - L21 U12 against the reference's gridded kernel (or its
    matmul where no row-block height divides m2)."""
    rng = np.random.default_rng(m2 + w1)
    a22 = rng.standard_normal((m2, w2)).astype(np.float32)
    l21 = rng.standard_normal((m2, w1)).astype(np.float32)
    u12 = rng.standard_normal((w1, w2)).astype(np.float32)
    ref = np.asarray(jpk._rank_update(jnp.asarray(a22), jnp.asarray(l21),
                                      jnp.asarray(u12)))
    out = pk._rank_update(*map(torch.as_tensor, (a22, l21, u12))).numpy()
    # sums of w1 <= 32 O(1) products taken in different orders: 1e-5
    # relative to the result's norm is a few dozen ulps
    assert np.linalg.norm(out - ref) <= 1e-5 * np.linalg.norm(ref)


def test_rank_update_exact_on_dyadic_inputs():
    # exactly representable inputs: every product and sum is exact
    rng = np.random.default_rng(11)
    a22, l21, u12 = ((rng.integers(-8, 9, s) / 16.0).astype(np.float32)
                     for s in ((256, 32), (256, 16), (16, 32)))
    out = pk._rank_update(*map(torch.as_tensor, (a22, l21, u12))).numpy()
    assert np.array_equal(out, a22 - l21 @ u12)


def test_pivots_to_permutation_matches_xla():
    rng = np.random.default_rng(13)
    m = 300
    piv = np.array([j + rng.integers(0, m - j) for j in range(64)],
                   np.int32)
    ref = np.asarray(jax.lax.linalg.lu_pivots_to_permutation(
        jnp.asarray(piv), m))
    out = pk.lu_pivots_to_permutation(torch.as_tensor(piv), m)
    assert np.array_equal(out.numpy(), ref)


# -- gates, constants, counters -------------------------------------------

def test_gate_constants_match_jax():
    assert (pk.LU_REC_MAX_W, pk.LU_REC_IB, pk.LU_REC_MAX_ELEMS) == \
        (jpk.LU_REC_MAX_W, jpk.LU_REC_IB, jpk.LU_REC_MAX_ELEMS)
    assert tcache.FROZEN[("lu_panel", "ib")] == pk.LU_REC_IB
    frozen_ops = {k[0] for k in tcache.FROZEN}
    assert {t for _, t in pk.KERNEL_REGISTRY.values()} <= frozen_ops
    for name, (gate, op) in pk.KERNEL_REGISTRY.items():
        assert jpk.KERNEL_REGISTRY[name] == (gate, op)
        assert callable(getattr(pk, gate)) and callable(getattr(pk, name))


@pytest.mark.parametrize("w,ib", [(512, None), (128, None), (96, None),
                                  (64, 16), (24, 8), (40, None),
                                  (512, 48)])
def test_rec_ib_matches_jax(w, ib):
    assert pk._rec_ib(w, ib) == jpk._rec_ib(w, ib)


@pytest.mark.parametrize("m,w,kw", [
    (256, 1024, {}), (128, 256, {}), (200, 64, {}), (256, 60, {}),
    (1 << 20, 64, {"max_elems": 1024}), (256, 64, {}),
    (16384, 512, {}), (16384, 128, {}), (65536, 64, {})])
def test_shape_reasons_match_jax(m, w, kw):
    """Same numbers as the reference's gates, so routing and split
    points agree."""
    assert pk._rec_shape_reason(m, w, torch.float32, **kw) == \
        jpk._rec_shape_reason(m, w, jnp.float32, **kw)


def test_reject_reasons():
    # the reference's 'platform' is the tensor's device here
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float32) \
        == pk.NOT_CUDA
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float32,
                                         "cpu") == pk.NOT_CUDA
    cuda = torch.device("cuda")
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.bfloat16,
                                         cuda) == "dtype"
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float32,
                                         cuda) is None
    assert pk.lu_panel_rec_eligible(256, 64, torch.float32, cuda)
    assert not pk.lu_panel_rec_eligible(256, 64, torch.float32, "cpu")


def test_ineligible_panel_returns_none():
    # CPU runs the plain versions only where the shape is eligible and
    # the dtype is f32, as the reference's interpret mode
    a = torch.zeros((200, 24))
    assert pk.lu_panel_rec(a) is None                  # align
    assert pk.lu_panel_rec(torch.zeros((256, 64),
                                       dtype=torch.bfloat16)) is None


def test_cpu_calls_count_no_launch():
    """A wrapper given CPU tensors computes the plain version and
    increments no kernel launch counter."""
    pk.reset_launch_counts()
    rng = np.random.default_rng(17)
    a = torch.as_tensor(rng.standard_normal((512, 64)).astype(np.float32))
    pk.lu_panel_rec(a, ib=8, max_elems=512 * 16)       # split path
    pk._rank_update(a[:, :8], a[:, 8:16], a[:8, :8])
    assert pk.launch_counts() == {"lu_panel_rec": 0, "rank_update": 0}

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
from slate_tpu_torch.testing import (EXACT_KINDS, bf16_ulps, chol_cases,
                                     panel_cases, qr_before_tie,
                                     qr_panel_cases, qr_sign_tie,
                                     qr_sign_tie_panel, spd_system, spiked,
                                     trtri_cases)
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


def test_lu_panel_fori_stack_matches_each_panel(adversarial):
    # a (B, m, w) stack runs the same column loop per element: packed
    # factors and pivots bitwise those of each panel alone, the rank-1
    # update of one element untouched by the others' pivots
    stack = torch.as_tensor(np.stack([adversarial[k][0] for k in KINDS]))
    p, piv = lu_panel_fori(stack)
    assert p.shape == stack.shape and piv.shape == (len(KINDS), 32)
    for i in range(len(KINDS)):
        pi, pivi = lu_panel_fori(stack[i])
        assert torch.equal(p[i], pi) and torch.equal(piv[i], pivi)


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
    # the CPU wrapper (the plain version) and the plain version itself,
    # up to the main path's 512 swaps over 16384 rows
    rng = np.random.default_rng(13)
    for m, w in ((300, 64), (16384, 512)):
        piv = np.array([j + rng.integers(0, m - j) for j in range(w)],
                       np.int32)
        ref = np.asarray(jax.lax.linalg.lu_pivots_to_permutation(
            jnp.asarray(piv), m))
        out = pk.lu_pivots_to_permutation(torch.as_tensor(piv), m)
        assert out.dtype == torch.int64
        assert np.array_equal(out.numpy(), ref)
        assert np.array_equal(
            pk.compose_swaps_plain(torch.as_tensor(piv), m).numpy(), ref)


from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as hst  # noqa: E402

#: the swap sequences the kernel's composition is held to XLA's over:
#: LU sequences (piv[j] in [j, m), the kernel's sorted path), with the
#: ragged pad's identity tail, any targets in range, targets outside
#: [-2m, 2m), (B, w) stacks mixing them, more swaps than rows (XLA
#: raises), and no swaps
SWAP_KINDS = ("lu", "lu_pads", "any", "out_of_range", "stack", "w_over_m",
              "empty")


@hst.composite
def swap_case(draw, kind):
    m = draw(hst.integers(1, 40))
    if kind == "empty":
        return np.zeros(0, np.int32), draw(hst.integers(0, 40))
    if kind == "w_over_m":
        w = draw(hst.integers(m + 1, m + 8))
        return np.asarray(draw(hst.lists(hst.integers(0, m - 1), min_size=w,
                                         max_size=w)), np.int32), m
    w = draw(hst.integers(1, m))

    def row(k):
        if k == "lu":
            return [j + draw(hst.integers(0, m - 1 - j)) for j in range(w)]
        if k == "lu_pads":
            live = draw(hst.integers(0, w))
            return [j + draw(hst.integers(0, m - 1 - j)) if j < live else j
                    for j in range(w)]
        if k == "any":
            return draw(hst.lists(hst.integers(0, m - 1), min_size=w,
                                  max_size=w))
        return draw(hst.lists(hst.integers(-2 * m, 2 * m - 1), min_size=w,
                              max_size=w))

    if kind == "stack":
        b = draw(hst.integers(1, 4))
        rows = [row(draw(hst.sampled_from(SWAP_KINDS[:4]))) for _ in range(b)]
        return np.asarray(rows, np.int32).reshape(b, w), m
    return np.asarray(row(kind), np.int32), m


@pytest.mark.parametrize("kind", SWAP_KINDS)
def test_compose_swaps_matches_xla(kind):
    """The plain walk, the kernel's sorted composition on the host and
    the CPU wrapper against XLA's lu_pivots_to_permutation (the
    reference's swap composition), bitwise; more swaps than rows raise
    in all of them."""
    fns = (pk.compose_swaps_plain, pk.compose_swaps_sorted_plain,
           pk.lu_pivots_to_permutation)

    @settings(max_examples=30, deadline=None, derandomize=True,
              database=None, suppress_health_check=list(HealthCheck))
    @given(swap_case(kind))
    def check(case):
        p, m = case
        if p.shape[-1] > m:
            with pytest.raises(ValueError):
                jax.lax.linalg.lu_pivots_to_permutation(jnp.asarray(p), m)
            for fn in fns:
                with pytest.raises(ValueError):
                    fn(torch.as_tensor(p), m)
            return
        ref = np.asarray(jax.lax.linalg.lu_pivots_to_permutation(
            jnp.asarray(p), m))
        for fn in fns:
            out = fn(torch.as_tensor(p), m)
            assert out.dtype == torch.int64
            assert np.array_equal(out.numpy(), ref), fn.__name__

    check()


@pytest.mark.parametrize("m,w", [(16384, 512), (16384, 32), (16384, 16384),
                                 (608, 608)])
def test_compose_swaps_sorted_path_shapes(m, w):
    """The sorted composition at the paths' sizes (gesv's 512 swaps and
    the recursive panel's smallest split over 16384 rows, getrs' whole
    pivot vector, a ragged element) and on long chains of earlier swaps
    (each step targets the next row: one chain through every step)
    equals the walk."""
    rng = np.random.default_rng(w)
    for piv in (np.array([j + rng.integers(0, m - j) for j in range(w)]),
                np.minimum(np.arange(w) + 1, m - 1)):
        t = torch.as_tensor(piv.astype(np.int32))
        assert torch.equal(pk.compose_swaps_sorted_plain(t, m),
                           pk.compose_swaps_plain(t, m))


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
    # the reference's 'platform' is the tensor's device here; bf16 is a
    # panel type of the kernel now, other types are 'dtype'
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float32) \
        == pk.NOT_CUDA
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float32,
                                         "cpu") == pk.NOT_CUDA
    cuda = torch.device("cuda")
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float16,
                                         cuda) == "dtype"
    assert pk.lu_panel_rec_reject_reason(256, 64, torch.float64,
                                         cuda) == "dtype"
    for dt in (torch.float32, torch.bfloat16):
        assert pk.lu_panel_rec_reject_reason(256, 64, dt, cuda) is None
        assert pk.lu_panel_rec_eligible(256, 64, dt, cuda)
    assert not pk.lu_panel_rec_eligible(256, 64, torch.float32, "cpu")
    # the bf16 element budget (2^20) splits a 16384x512 panel down to
    # 16384x64 dispatches: 16384 * 32 fits, 65536 * 32 does not
    assert pk._rec_max_elems(torch.bfloat16, None) == 1 << 20
    assert pk.lu_panel_rec_reject_reason(16384, 512, torch.bfloat16,
                                         cuda) is None
    assert pk.lu_panel_rec_reject_reason(65536, 64, torch.bfloat16,
                                         cuda) == "height"


def test_ineligible_panel_returns_none():
    # CPU runs the plain versions only where the shape is eligible and
    # the dtype is one the kernel takes (f32, bf16), as the reference's
    # interpret mode
    a = torch.zeros((200, 24))
    assert pk.lu_panel_rec(a) is None                  # align
    assert pk.lu_panel_rec(torch.zeros((256, 64),
                                       dtype=torch.float64)) is None
    assert pk.lu_panel(torch.zeros((200, 24))) is None
    assert pk.lu_panel(torch.zeros((256, 64), dtype=torch.float64)) is None
    assert pk.lu_panel(torch.zeros((256, 264))) is None   # width
    out = pk.lu_panel_rec(torch.eye(256, 64, dtype=torch.bfloat16))
    assert out is not None and out[0].dtype == torch.bfloat16


def test_cpu_calls_count_no_launch():
    """A wrapper given CPU tensors computes the plain version and
    increments no kernel launch counter."""
    pk.reset_launch_counts()
    rng = np.random.default_rng(17)
    a = torch.as_tensor(rng.standard_normal((512, 64)).astype(np.float32))
    pk.lu_panel_rec(a, ib=8, max_elems=512 * 16)       # split path
    pk._rank_update(a[:, :8], a[:, 8:16], a[:8, :8])
    pk.lu_panel(a)
    pk.lu_panel_rec(a.bfloat16(), ib=8, max_elems=512 * 16)
    pk.lu_pivots_to_permutation(torch.arange(64, dtype=torch.int32), 512)
    pk.qr_panel(a[:, :32])
    pk.qr_panel(a[:, :32].bfloat16())
    s = a[:256, :32] @ a[:256, :32].T + 256 * torch.eye(256)
    pk.trtri_lower(pk.chol_panel(s))
    stack, sizes = s[None, :64, :64].repeat(2, 1, 1), [40, 64]
    pk.ragged_potrf(stack, sizes)
    pk.ragged_getrf(stack, sizes)
    pk.ragged_trsm(stack, stack[:, :, :2], sizes)
    pk.lu_pivots_to_permutation(torch.zeros((2, 8), dtype=torch.int32), 64)
    assert pk.givens_chain_apply(s, torch.ones(255),
                                 torch.zeros(255)) is not None
    pk.steqr_sweep(s[0, :16], s[1, :15])
    pk.bdsqr_sweep(s[0, :16], s[1, :15])
    pk.lu_solve_packed(s[:64, :64].bfloat16(), torch.arange(64),
                       s[:64, :2].bfloat16(), 2)
    assert pk.launch_counts() == {"lu_panel_rec": 0, "rank_update": 0,
                                  "lu_panel": 0, "compose_swaps": 0,
                                  "qr_panel": 0, "chol_panel": 0,
                                  "trtri_lower": 0, "ragged_potrf": 0,
                                  "ragged_getrf": 0, "ragged_trsm": 0,
                                  "givens_chain_apply": 0,
                                  "steqr_sweep": 0, "bdsqr_sweep": 0,
                                  "lu_solve_packed": 0}


# -- bf16 panels, the rank-1 panel, the swap composition ---------------------

DTYPES = ("float32", "bfloat16")


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _to_torch(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _f32(x):
    """float32 numpy view of a port tensor or a JAX array (bf16 ones
    included: both convert exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_values(kind, dtype, out, ref):
    """Values of a port panel against the JAX kernel's. The zero-noise
    kinds are exact in every operation: bitwise. Otherwise f32 agrees
    to rounding of differently ordered sums (1e-5), and bf16 to 2 ulps:
    XLA on the CPU may keep excess f32 precision inside a bf16 fusion
    where the port rounds after each op."""
    out, ref = _f32(out), _f32(ref)
    if kind in EXACT_KINDS:
        assert np.array_equal(out, ref)
    elif dtype == "bfloat16":
        assert bf16_ulps(out, ref) <= 2.0
    else:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def adversarial_rank1():
    """The adversarial suite through the JAX rank-1 kernel, in both
    types, once."""
    cases = panel_cases(np.random.default_rng(42), 256, 32, 8)
    return {(kind, dt): (a,) + tuple(map(np.asarray,
                                         jpk.lu_panel(_to_jax(a, dt))))
            for kind, a in cases.items() for dt in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_lu_panel_adversarial_matches_jax(adversarial_rank1, kind, dtype):
    a, jp, jpiv = adversarial_rank1[(kind, dtype)]
    packed, piv = pk.lu_panel(_to_torch(a, dtype))
    assert piv.dtype == torch.int32
    assert packed.dtype == getattr(torch, dtype)
    # the spikes force the pivot sequence: bitwise
    assert np.array_equal(piv.numpy(), jpiv)
    _assert_values(kind, dtype, packed, jp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,w,seg", [(256, 96, 32), (384, 136, 32),
                                     (128, 256, 32), (40, 64, 32),
                                     (96, 64, 8), (200, 100, 64)])
def test_lu_panel_segmented_plain_shapes(m, w, seg, dtype):
    """The segmented order gives lu_panel_plain's packed LU and pivots
    bitwise on random panels of every kind of edge: a width off the
    segment width, fewer rows than columns (the last segment factors
    only the columns that have a pivot row), and other segment
    widths."""
    a = np.random.default_rng(m + w + seg).standard_normal((m, w))
    t = _to_torch(a.astype(np.float32), dtype)
    sp, spiv = pk.lu_panel_segmented_plain(t, seg)
    pp, ppiv = pk.lu_panel_plain(t)
    assert torch.equal(sp, pp) and torch.equal(spiv, ppiv)


@pytest.fixture(scope="module")
def adversarial_rank1_wide():
    """The adversarial suite at 256 x 96 with the boundary spikes at the
    kernel's segment edges (ib = 32), through the JAX rank-1 kernel, in
    both types, once."""
    cases = panel_cases(np.random.default_rng(42), 256, 96, 32)
    return {(kind, dt): (a,) + tuple(map(np.asarray,
                                         jpk.lu_panel(_to_jax(a, dt))))
            for kind, a in cases.items() for dt in DTYPES}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_lu_panel_segmented_plain_bitwise(adversarial_rank1_wide, kind,
                                          dtype):
    """The kernel's order on the plain side (segments of 32 columns,
    then each segment's rank-1 updates of the trailing columns) gives
    lu_panel_plain's packed LU and pivots bitwise, across three
    segments; against the JAX rank-1 kernel (interpreted) the pivots
    are bitwise, and so are the bf16 values."""
    a, jp, jpiv = adversarial_rank1_wide[(kind, dtype)]
    t = _to_torch(a, dtype)
    sp, spiv = pk.lu_panel_segmented_plain(t)
    pp, ppiv = pk.lu_panel_plain(t)
    assert torch.equal(sp, pp) and torch.equal(spiv, ppiv)
    assert np.array_equal(spiv.numpy(), jpiv)
    if dtype == "bfloat16":
        assert np.array_equal(_f32(sp), _f32(jp))
    else:
        _assert_values(kind, dtype, sp, jp)


def test_lu_panel_scratch_and_c_signature():
    """The rank-1 kernel keeps its C entry; its first scratch pointer
    carries the segments' exchange, sized for the most blocks the base
    case takes (the entry zeroes it, so every panel's epochs start above
    every word). A second entry tells a report which segments run their
    base case in one block."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build.LIBS["lu_panel"] == (
        "lu_panel.cu", {"slate_set_device": [I],
                        "lu_panel": [P, P, I, I, P, P, I, P],
                        "lu_panel_block_takes": [I, I, I]})
    assert pk._LG_MAX_BLOCKS == 160
    assert pk.lu_grid_scratch_words(pk._LG_MAX_BLOCKS) == \
        2 + 2 * (160 * 34 + 32)


@pytest.mark.parametrize("kind", KINDS)
def test_lu_panel_rec_bf16_adversarial_matches_jax(kind):
    a = panel_cases(np.random.default_rng(42), 256, 32, 8)[kind]
    jp, jpiv = jpk.lu_panel_rec(_to_jax(a, "bfloat16"), ib=8)
    packed, piv = pk.lu_panel_rec(_to_torch(a, "bfloat16"), ib=8)
    assert packed.dtype == torch.bfloat16
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    _assert_values(kind, "bfloat16", packed, jp)


def test_lu_panel_rec_bf16_tall_split_matches_jax():
    """The bf16 tall split (budget forced down to (m, 8)): the pivot
    sequence bitwise, values within 2 bf16 ulps of the JAX split."""
    rng = np.random.default_rng(7)
    m, w = 1024, 32
    a = spiked(rng, m, w, [m - 1 - j for j in range(w)])
    jp, jpiv = jpk.lu_panel_rec(_to_jax(a, "bfloat16"), ib=8,
                                max_elems=m * 8)
    packed, piv = pk.lu_panel_rec(_to_torch(a, "bfloat16"), ib=8,
                                  max_elems=m * 8)
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    # the split's U12 solve runs in f32 and rounds once
    # (blocked.solve_triangular) where XLA's expander rounds bf16
    # intermediates: a few entries that cancel far below the noise scale
    # (1/2) differ by more ulps of their own, so 2 bf16 ulps at that
    # scale absolute, 2 ulps relative elsewhere
    np.testing.assert_allclose(_f32(packed), _f32(jp), atol=2.0 ** -8,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("m,w", [(256, 256), (512, 128)])
def test_lu_panel_random_bf16_matches_jax(m, w):
    """A random Gaussian panel (pivots not forced by spikes): the JAX
    rank-1 kernel and the port's plain version pick the same pivots and
    factor to within 2 bf16 ulps; their residuals agree."""
    a = np.random.default_rng(m + w).standard_normal((m, w)) \
        .astype(np.float32)
    jp, jpiv = jpk.lu_panel(_to_jax(a, "bfloat16"))
    packed, piv = pk.lu_panel(_to_torch(a, "bfloat16"))
    assert np.array_equal(piv.numpy(), np.asarray(jpiv))
    assert bf16_ulps(_f32(packed), _f32(jp)) <= 2.0


@pytest.mark.parametrize("m2,w1,w2", [(256, 16, 32), (16128, 32, 16),
                                      (200, 24, 40)])
def test_rank_update_bf16_matches_jax(m2, w1, w2):
    """bf16 A22 - bf16(L21 U12), the product accumulated in f32, against
    the reference's kernel (or its matmul where no row-block height
    divides m2)."""
    rng = np.random.default_rng(m2 + w2)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in ((m2, w2), (m2, w1), (w1, w2))]
    ref = jpk._rank_update(*(_to_jax(x, "bfloat16") for x in ops))
    out = pk._rank_update(*(_to_torch(x, "bfloat16") for x in ops))
    assert out.dtype == torch.bfloat16
    # the f32 sums differ in order only: the rounded products may differ
    # by an ulp, and the subtract is exact up to its own rounding
    assert bf16_ulps(_f32(out), _f32(ref)) <= 2.0


def test_rank_update_bf16_exact_on_dyadic_inputs():
    # A22 = k/16 (|k| <= 8), L21 and U12 = k/4 (|k| <= 2), w1 = 4: every
    # product, sum and difference is a multiple of 1/16 below 2, exact
    # in bf16 (8 significant bits): bitwise
    rng = np.random.default_rng(12)
    a22 = (rng.integers(-8, 9, (256, 32)) / 16.0).astype(np.float32)
    l21, u12 = ((rng.integers(-2, 3, s) / 4.0).astype(np.float32)
                for s in ((256, 4), (4, 32)))
    out = pk._rank_update(*(_to_torch(x, "bfloat16")
                            for x in (a22, l21, u12)))
    assert np.array_equal(_f32(out), a22 - l21 @ u12)


def test_rank_update_c_signature():
    """The C entry takes the bf16 path's (w2, w1) scratch pointer before
    the stream; the Cholesky entry is unchanged."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build.LIBS["rank_update"] == (
        "rank_update.cu", {"slate_set_device": [I],
                           "rank_update": [P, P, P, P, I, I, I, I, P, P]})
    assert _build.LIBS["chol_panel"][1]["chol_panel"] == [P, P, I, I, P]


def test_qr_panel_and_ragged_trsm_c_signatures():
    """The Householder panel takes its block count and one exchange
    scratch (no barrier word, no scratch-size entry); the ragged solve's
    entry is unchanged."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    assert _build.LIBS["qr_panel"] == (
        "qr_panel.cu", {"slate_set_device": [I],
                        "qr_panel": [P, P, I, I, I, P, I, P]})
    assert _build.LIBS["ragged_trsm"] == (
        "ragged_trsm.cu", {"slate_set_device": [I],
                           "ragged_trsm": [P, P, P, P, I, I, I, I, I, I, I,
                                           I, P]})
    # per column parity: a partial vector a block, then row j
    assert pk.qr_scratch_words(64, 128) == 2 * 65 * 128


@pytest.mark.parametrize("m,sms,blocks", [(8192, 132, 64), (4096, 132, 64),
                                          (1024, 132, 32), (256, 132, 8),
                                          (128, 132, 4), (32, 132, 1),
                                          (8192, 48, 48), (200, 132, 7)])
def test_qr_panel_blocks(m, sms, blocks):
    """The Householder panel's blocks: one for every 32 rows, at most 64
    of them and one a SM."""
    assert pk.qr_panel_blocks(m, sms) == blocks
    assert -(-m // blocks) <= 32 or blocks == min(64, sms)


def test_panel_and_chain_c_signatures():
    """The recursive panel's base case takes the exchange scratch and
    the block count before the type flag; the chain apply takes the
    rows a block before the stream."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert _build.LIBS["lu_panel_rec"][1]["lu_rec_base"] == \
        [P, P, I, I, I, I, P, P, P, I, I, P]
    assert _build.LIBS["givens_chain"][1]["givens_chain"] == \
        [P, L, L, P, L, L, P, P, I, I, I, P]
    # the scratch: a counter and its pad, per parity the slots and row j
    assert pk.lu_grid_scratch_words(132) == 2 + 2 * (132 * 34 + 32)


@pytest.mark.parametrize("shapes,dtypes", [
    (((64, 32), (64, 16), (16, 32)), (torch.float32,) * 3),
    (((64, 32), (64, 16), (16, 32)), (torch.bfloat16,) * 3),
    (((64, 32), (64, 16), (16, 32)),
     (torch.float32, torch.bfloat16, torch.float32)),
    (((64, 32), (64, 16), (16, 32)), (torch.float64,) * 3),
    (((64, 32), (63, 16), (16, 32)), (torch.float32,) * 3),
    (((64, 32), (64, 16), (16, 31)), (torch.float32,) * 3),
])
def test_rank_update_checks(shapes, dtypes):
    """The kernel's checks: one type, f32 or bf16, matching shapes; the
    first two cases pass, the rest raise."""
    ops = [torch.zeros(sh, dtype=dt) for sh, dt in zip(shapes, dtypes)]
    ok = len(set(dtypes)) == 1 and dtypes[0] in pk.PANEL_DTYPES \
        and shapes[1][0] == shapes[0][0] and shapes[2] == (shapes[1][1],
                                                           shapes[0][1])
    if ok:
        pk._check_rank_update(*ops)
    else:
        with pytest.raises(ValueError, match="rank_update kernel"):
            pk._check_rank_update(*ops)


@pytest.mark.parametrize("shape,dtype,ok", [
    ((256, 256), torch.float32, True), ((1024, 1024), torch.float32, True),
    ((200, 200), torch.float32, False), ((256, 128), torch.float32, False),
    ((256, 256), torch.bfloat16, False)])
def test_chol_panel_checks(shape, dtype, ok):
    """The Cholesky kernel's checks: an f32 square of order % 128."""
    a = torch.zeros(shape, dtype=dtype)
    if ok:
        pk._check_chol_block(a)
    else:
        with pytest.raises(ValueError, match="chol_panel kernel"):
            pk._check_chol_block(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m2,w", [(16128, 256), (16091, 128), (200, 64)])
def test_rank_update_cpu_equals_plain_and_jax(dtype, m2, w):
    """On the CPU the wrapper is its plain twin (bitwise), counts no
    launch, and agrees with the reference at the split's widths and at
    a height that is not a multiple of the kernels' 128-row tile."""
    rng = np.random.default_rng(m2 + w)
    ops = [rng.standard_normal(s).astype(np.float32)
           for s in ((m2, w), (m2, w), (w, w))]
    tops = [_to_torch(x, dtype) for x in ops]
    pk.reset_launch_counts()
    out = pk._rank_update(*tops)
    assert pk.launch_counts()["rank_update"] == 0
    assert torch.equal(out, pk.rank_update_plain(*tops))
    ref = jpk._rank_update(*(_to_jax(x, dtype) for x in ops))
    if dtype == "bfloat16":
        # as test_rank_update_bf16_matches_jax
        assert bf16_ulps(_f32(out), _f32(ref)) <= 2.0
    else:
        # sums of w <= 256 O(1) products in another order: 1e-5 of the
        # result's norm is far above f32 rounding
        ref = np.asarray(ref)
        assert np.linalg.norm(out.numpy() - ref) \
            <= 1e-5 * np.linalg.norm(ref)


def test_lu_panel_gates_match_jax():
    """The rank-1 panel's numbers are the reference's: the same shapes
    pass its shape gate in both types, and the reasons come in its
    order (with the card in place of the TPU)."""
    assert (pk.LU_PANEL_MAX_W, pk.LU_PANEL_MAX_M) == \
        (jpk.LU_PANEL_MAX_W, jpk.LU_PANEL_MAX_M)
    assert tcache.FROZEN[("lu_panel", "max_w")] == pk.LU_PANEL_MAX_W
    assert pk._lu_max_w() == jpk._lu_max_w()
    for m in (128, 200, 4096, 4224, 8192, 8320):
        for w in (8, 60, 64, 256, 264):
            for dt in DTYPES:
                assert pk._lu_shape_ok(m, w, getattr(torch, dt)) == \
                    jpk._lu_shape_ok(m, w, jnp.dtype(dt)), (m, w, dt)
    cuda = torch.device("cuda")
    reason = pk.lu_panel_reject_reason
    assert reason(4096, 256, torch.bfloat16) == pk.NOT_CUDA
    assert reason(4096, 256, torch.float64, cuda) == "dtype"
    assert reason(9000, 264, torch.float32, cuda) == "width"
    assert reason(4224, 256, torch.bfloat16, cuda) == "height"
    assert reason(8192, 256, torch.float32, cuda) is None
    assert reason(200, 64, torch.float32, cuda) == "align"
    assert reason(4096, 256, torch.bfloat16, cuda) is None
    assert pk.lu_panel_eligible(4096, 256, torch.bfloat16, cuda)


def test_cuda_paths_make_no_host_copy():
    """The pivot paths read nothing back to the host on the card: no
    .cpu(), .numpy(), .item(), .tolist() or int() in apply_pivots,
    _getrf_carry, _getrf_pipelined, _lu_rec_split, or the CUDA branch of
    lu_pivots_to_permutation (the plain version, for CPU tensors, is
    the only host loop)."""
    import inspect
    import re
    from slate_tpu_torch.linalg import lu as tlu
    bad = re.compile(r"\.cpu\(|\.numpy\(|\.item\(|\.tolist\(|\bint\(")
    for fn in (tlu.apply_pivots, tlu._getrf_carry, tlu._getrf_pipelined,
               pk._lu_rec_split):
        body = inspect.getsource(fn).split('"""')[-1]
        assert not bad.search(body), fn.__name__
    src = inspect.getsource(pk.lu_pivots_to_permutation).split('"""')[-1]
    cuda_branch = src.split("return compose_swaps_plain(piv, m)")[1]
    assert not bad.search(cuda_branch)
    assert "compose_swaps_plain" in inspect.getsource(
        pk.lu_pivots_to_permutation)


# -- the Householder panel, the Cholesky block, the triangular inverse -------

QR_KINDS = ("zerocol", "triu", "equal", "tiny", "huge")


@pytest.fixture(scope="module")
def qr_adversarial():
    """The Householder suite (m=256, w=32) through the JAX kernel in
    both types, once."""
    cases = qr_panel_cases(np.random.default_rng(21), 256, 32)
    return {(kind, dt): (a,) + tuple(map(np.asarray,
                                         jpk.qr_panel(_to_jax(a, dt))))
            for kind, a in cases.items() for dt in DTYPES}


def _assert_qr(kind, dtype, packed, taus, jp, jt):
    """A port panel against the JAX kernel's. Scale-relative, since the
    tiny/huge kinds sit at 2^-60 / 2^56. f32: the norms and v^T A sums
    are taken in another order (1e-5 of the scale). bf16: the first
    rounding that flips differently feeds every later column; the
    factors agree normwise to a bf16 ulp (2^-8 relative). "equal":
    after the first column the rest is rounding noise, whose reflectors
    are arbitrary, so only R and the first tau are compared."""
    out, ref = _f32(packed), _f32(jp)
    if kind == "equal":
        out, ref = np.triu(out), np.triu(ref)
        taus, jt = taus[:1], jt[:1]
    scale = np.abs(ref).max()
    if dtype == "bfloat16":
        assert np.linalg.norm(out - ref) <= 2.0 ** -8 * np.linalg.norm(ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * scale
    # taus lie in [0, 2]
    assert np.abs(_f32(taus) - _f32(jt)).max() <= \
        (2.0 ** -7 if dtype == "bfloat16" else 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", QR_KINDS)
def test_qr_panel_adversarial_matches_jax(qr_adversarial, kind, dtype):
    a, jp, jt = qr_adversarial[(kind, dtype)]
    packed, taus = pk.qr_panel(_to_torch(a, dtype))
    assert packed.dtype == taus.dtype == getattr(torch, dtype)
    _assert_qr(kind, dtype, packed, taus, jp, jt)
    t = _f32(taus)
    if kind == "zerocol":
        # the zero column: tau 0 in both
        assert t[16] == 0 and _f32(jt)[16] == 0
    if kind == "triu":
        # every column already zero below the diagonal: the kernel's
        # tau is exactly 2 (reflect's would be 0)
        assert np.all(t == 2.0) and np.all(_f32(jt) == 2.0)


@pytest.mark.parametrize("m,w,dtype", [
    (512, 128, "float32"), (512, 128, "bfloat16"), (256, 64, "float32"),
    (256, 64, "bfloat16"),
    # the bf16 gels path's sub-panel width at one of its last heights
    (256, 128, "float32")])
def test_qr_panel_random_matches_jax(m, w, dtype):
    a = np.random.default_rng(m + w).standard_normal((m, w)) \
        .astype(np.float32)
    jp, jt = jpk.qr_panel(_to_jax(a, dtype))
    packed, taus = pk.qr_panel(_to_torch(a, dtype))
    _assert_qr("random", dtype, packed, taus, jp, jt)


def _qr_residual(a, packed, taus):
    """||A - Q R||_F / ||A||_F of a packed (m, w) Householder panel, in
    f64 (chip_smoke.qr_residual's)."""
    m, w = a.shape
    p = _f32(packed).astype(np.float64)
    x = np.zeros((m, w))
    x[:w] = np.triu(p[:w])
    V = np.tril(p, -1)
    V[np.arange(w), np.arange(w)] = 1.0
    t = _f32(taus).astype(np.float64)
    for j in reversed(range(w)):
        x -= t[j] * np.outer(V[:, j], V[:, j] @ x)
    return np.linalg.norm(a - x) / np.linalg.norm(a)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [128, 256])
def test_qr_panel_gels_subpanels_match_jax(m, dtype):
    """The bf16 gels path's last sub-panels (w = 128, m = 128 and 256):
    both packages' factors reconstruct the panel (chip_smoke.py's
    QR_RES_LIMIT: f32 1e-5, bf16 0.05), their taus lie in [0, 2], and in
    f32 the factors agree to 1e-5 of the scale. Not compared at
    test_qr_panel_random_matches_jax's limits: with w close to m the
    last columns hold a few rows, whose reflectors follow each sum's
    rounding (f32 taus 1.3e-6 apart at 128 x 128; bf16 factors 0.009 /
    0.0041 apart normwise at 128 / 256, where a bf16 ulp is 0.0039)."""
    w = 128
    a = np.random.default_rng(m + w).standard_normal((m, w)) \
        .astype(np.float32)
    a_in = _f32(_to_torch(a, dtype)).astype(np.float64)
    jp, jt = jpk.qr_panel(_to_jax(a, dtype))
    packed, taus = pk.qr_panel(_to_torch(a, dtype))
    limit = 0.05 if dtype == "bfloat16" else 1e-5
    assert _qr_residual(a_in, packed, taus) <= limit
    assert _qr_residual(a_in, np.asarray(jp), np.asarray(jt)) <= limit
    t = _f32(taus)
    assert np.all((t >= 0) & (t <= 2))
    if dtype == "float32":
        out, ref = _f32(packed), _f32(jp)
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_qr_panel_sign_tie_panel_matches_jax():
    """The bf16 1024 x 128 sign-tie panel (testing.qr_sign_tie_panel,
    regenerated from its seed): qr_panel_plain against the JAX kernel
    through the Pallas interpreter, held as chip_smoke.py holds the
    kernel against the plain version: normwise to a bf16 ulp (2^-8) and
    taus to 2^-7 on what precedes their first sign tie, and both
    factors to the residual (0.05)."""
    a = qr_sign_tie_panel(0)
    jp, jt = jpk.qr_panel(_to_jax(a, "bfloat16"))
    packed, taus = pk.qr_panel(_to_torch(a, "bfloat16"))
    out, ref = _f32(packed).astype(np.float64), _f32(jp).astype(np.float64)
    tout, tref = _f32(taus), _f32(jt)
    t = qr_sign_tie(out, tout, ref, tref)
    o, r = qr_before_tie(out, t), qr_before_tie(ref, t)
    assert np.linalg.norm(o - r) <= 2.0 ** -8 * np.linalg.norm(r)
    assert np.abs(tout[:t] - tref[:t]).max() <= 2.0 ** -7
    a_in = _f32(_to_torch(a, "bfloat16")).astype(np.float64)
    assert _qr_residual(a_in, packed, taus) <= 0.05
    assert _qr_residual(a_in, np.asarray(jp), np.asarray(jt)) <= 0.05


def test_qr_sign_tie_finds_the_flipped_reflector():
    """qr_sign_tie on two factorizations of a panel whose column 5 has
    alpha exactly 0 in one copy and -2^-30 in the other (beta then takes
    opposite signs, both valid): the tie is column 5; a factor against
    itself has none (w), and a flip at a large alpha (-1) is no tie (the
    values before any later tie, column 5 included, stay held)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((256, 32)).astype(np.float32)
    # columns 0-4 upper triangular with a positive diagonal: their
    # reflectors leave column 5's top rows alone, so alpha_5 = a[5, 5]
    a[:, :5] = np.triu(a[:, :5])
    a[np.arange(5), np.arange(5)] = 1.0 + np.arange(5)
    b = a.copy()
    a[5, 5], b[5, 5] = 0.0, -2.0 ** -30
    pa, ta = (_f32(x) for x in pk.qr_panel(_to_torch(a, "float32")))
    pb, tb = (_f32(x) for x in pk.qr_panel(_to_torch(b, "float32")))
    assert np.sign(pa[5, 5]) != np.sign(pb[5, 5])
    assert qr_sign_tie(pa, ta, pb, tb) == 5
    assert qr_sign_tie(pa, ta, pa, ta) == 32
    c = a.copy()
    c[5, 5] = -1.0
    pc, tc = (_f32(x) for x in pk.qr_panel(_to_torch(c, "float32")))
    assert np.sign(pa[5, 5]) != np.sign(pc[5, 5])
    assert qr_sign_tie(pa, ta, pc, tc) > 5


@pytest.mark.parametrize("kind", ["zerocol", "diag", "equal", "tiny",
                                  "huge", "random"])
def test_chol_panel_matches_jax(kind):
    """The Cholesky block (n = 256: two stripes, so the left-looking
    update runs) against the JAX kernel; only the lower triangle is
    compared, the upper being unspecified. The exact kinds (a diagonal
    matrix, all ones) match bitwise; the others to 1e-5 of the scale
    (products summed in another order)."""
    rng = np.random.default_rng(22)
    a = spd_system(rng, 256, 1)[0] if kind == "random" \
        else chol_cases(rng, 256)[kind]
    ref = np.tril(np.asarray(jpk.chol_panel(jnp.asarray(a))))
    out = pk.chol_panel(torch.as_tensor(a)).numpy()
    assert np.array_equal(out, np.tril(out))
    if kind in ("diag", "equal"):
        assert np.array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n", [128, 512])
def test_chol_panel_cpu_equals_plain(n):
    """On the CPU the entry is the plain twin, bitwise, and counts no
    launch (n = 128: one stripe; 512: four, the main path's middle
    shape)."""
    s = torch.as_tensor(spd_system(np.random.default_rng(n), n, 1)[0])
    pk.reset_launch_counts()
    out = pk.chol_panel(s)
    assert pk.launch_counts()["chol_panel"] == 0
    assert torch.equal(out, pk.chol_panel_plain(s))


@pytest.mark.parametrize("kind,unit", [
    pytest.param(k, u, id="%s-%s" % (k, u))
    for k in ("zerodiag", "diag", "equal", "tiny", "huge",
              "chol128", "chol512")
    for u in (False, True) if (k, u) != ("huge", True)])
def test_trtri_lower_matches_jax(kind, unit):
    """The triangular inverse against the JAX kernel (interpret mode),
    unit and non-unit: the adversarial suite at n = 256 (a unit
    triangle with 2^40 off the diagonal has no f32 inverse, so that
    pair is left out) and Cholesky factors at n = 128 and 512, the
    shapes chip_smoke.py times. The exact kinds match bitwise; the
    others to 1e-5 of the scale."""
    if kind.startswith("chol"):
        n = int(kind[4:])
        s = spd_system(np.random.default_rng(n), n, 1)[0]
        a = np.linalg.cholesky(s.astype(np.float64)).astype(np.float32)
    else:
        a = trtri_cases(np.random.default_rng(23), 256)[kind]
    ref = np.asarray(jpk.trtri_lower(jnp.asarray(a), unit_diagonal=unit))
    out = pk.trtri_lower(torch.as_tensor(a), unit_diagonal=unit).numpy()
    if kind in ("diag", "equal"):
        assert np.array_equal(out, ref)
    else:
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_qr_chol_trtri_gates_match_jax():
    """The three kernels' numbers are the reference's: the same shapes
    pass the shape gates, and the reasons put the card first."""
    assert (pk.QR_PANEL_MAX_W, pk.QR_PANEL_MAX_M, pk.CHOL_FUSED_MAX,
            pk.TRTRI_FUSED_MAX) == (jpk.QR_PANEL_MAX_W, jpk.QR_PANEL_MAX_M,
                                    jpk.CHOL_FUSED_MAX, jpk.TRTRI_FUSED_MAX)
    for m in (128, 200, 4096, 8192, 8320):
        for w in (8, 60, 64, 128, 136):
            assert pk._qr_shape_ok(m, w) == jpk._qr_shape_ok(m, w), (m, w)
    for n in (128, 200, 512, 640, 1024, 1152):
        assert pk._chol_shape_ok(n) == jpk._chol_shape_ok(n), n
        assert pk._trtri_shape_ok(n) == jpk._trtri_shape_ok(n), n
    cuda = torch.device("cuda")
    assert pk.qr_panel_reject_reason(8192, 128, torch.bfloat16) == pk.NOT_CUDA
    assert pk.qr_panel_reject_reason(8192, 128, torch.float64,
                                     cuda) == "dtype"
    assert pk.qr_panel_reject_reason(8320, 128, torch.bfloat16,
                                     cuda) == "shape"
    for dt in (torch.float32, torch.bfloat16):
        assert pk.qr_panel_eligible(8192, 128, dt, cuda)
    assert pk.chol_panel_eligible(1024, torch.float32, cuda)
    assert not pk.chol_panel_eligible(1024, torch.bfloat16, cuda)
    assert not pk.chol_panel_eligible(1024, torch.float32, "cpu")
    assert pk.trtri_eligible(512, torch.float32, cuda)
    assert not pk.trtri_eligible(640, torch.float32, cuda)


def test_ineligible_blocks_take_the_library():
    """Where the gate rejects and no plain version stands in, the
    entries return what the reference's fallbacks return: None for the
    QR panel (the caller's column loop), the library Cholesky and the
    library solve against the identity for the other two."""
    assert pk.qr_panel(torch.zeros((200, 32))) is None
    assert pk.qr_panel(torch.zeros((256, 32), dtype=torch.float64)) is None
    s = torch.as_tensor(spd_system(np.random.default_rng(24), 200, 1)[0])
    pk.reset_launch_counts()
    assert torch.equal(pk.chol_panel(s), torch.linalg.cholesky(s))
    L = torch.linalg.cholesky(s.double())
    assert torch.equal(pk.trtri_lower(L), torch.linalg.solve_triangular(
        L, torch.eye(200, dtype=torch.float64), upper=False))
    assert pk.launch_counts()["chol_panel"] == 0


# -- the Givens chain apply and the QR sweeps (eig / svd slice) --------------

import importlib  # noqa: E402

# both packages re-export the svd FUNCTION under the module's name
jsvd = importlib.import_module("slate_tpu.linalg.svd")
tsvd = importlib.import_module("slate_tpu_torch.linalg.svd")
from slate_tpu.linalg import eig as jeig  # noqa: E402


def _angles(rng, n):
    th = rng.standard_normal(n - 1)
    return np.cos(th), np.sin(th)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_givens_chain_matrix_matches_jax_scan(rng, dtype):
    """The vectorized compose (one cumulative product) against the
    reference's scan on the CPU: bitwise in f64 (the factors multiply
    in the scan's order; torch's CPU cumprod runs sequentially). In f32
    XLA's compiled scan rounds some products an ulp apart (up to 5 ulps
    seen); an entry is a product of at most n - 1 factors, so f32 is
    held to n eps relative."""
    n = 96
    c, s = (x.astype(dtype) for x in _angles(rng, n))
    G = tsvd._givens_chain_matrix(torch.as_tensor(c), torch.as_tensor(s), n)
    JG = jsvd._givens_chain_matrix(jnp.asarray(c), jnp.asarray(s), n,
                                   jnp.dtype(dtype))
    if dtype == np.float64:
        assert np.array_equal(G.numpy(), np.asarray(JG))
    else:
        np.testing.assert_allclose(G.numpy(), np.asarray(JG),
                                   rtol=n * np.finfo(np.float32).eps,
                                   atol=0)


def test_givens_chain_apply_plain_matches_jax(rng):
    """The plain streamed apply against the reference's Pallas kernel
    (interpreted) and against Z @ G, f64, to 1e-12 (the products are
    summed in another order)."""
    n = 256
    c, s = _angles(rng, n)
    Z = rng.standard_normal((n, n))
    got = pk.givens_chain_apply(torch.as_tensor(Z), torch.as_tensor(c),
                                torch.as_tensor(s))
    ref = jpk.givens_chain_apply(jnp.asarray(Z), jnp.asarray(c),
                                 jnp.asarray(s))
    assert got is not None and ref is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12)
    G = tsvd._givens_chain_matrix(torch.as_tensor(c), torch.as_tensor(s), n)
    np.testing.assert_allclose(got.numpy(), Z @ G.numpy(), atol=1e-12)
    # a transposed view (bdsqr's right chain on Gvh^T) takes the same
    # path and gives the transposed operand's product
    Zt = torch.as_tensor(Z).T
    np.testing.assert_allclose(
        pk.givens_chain_apply(Zt, torch.as_tensor(c),
                              torch.as_tensor(s)).numpy(),
        Z.T @ G.numpy(), atol=1e-12)


@pytest.mark.parametrize("rows,n,trans", [(64, 256, False),
                                           (512, 256, True)])
def test_givens_chain_apply_f32_matches_jax(rng, rows, n, trans):
    """f32 at rows != n, row-major and a transposed view (bdsqr's right
    chain on Gvh^T): the streamed apply against the reference's Pallas
    kernel (interpreted) and the f64 chain. Each output is n-1 rounded
    rotation steps away from its inputs, so both are held to
    n eps max|Z| (the reference's window products round in another
    order; on the CPU the two differ by ~1% of that)."""
    c, s = (x.astype(np.float32) for x in _angles(rng, n))
    Z = rng.standard_normal((n, rows) if trans else (rows, n)
                            ).astype(np.float32)
    if trans:
        Z = Z.T
    Zt = torch.as_tensor(Z)
    assert Zt.stride(0 if trans else 1) == 1
    got = pk.givens_chain_apply(Zt, torch.as_tensor(c), torch.as_tensor(s))
    ref = jpk.givens_chain_apply(jnp.asarray(Z), jnp.asarray(c),
                                 jnp.asarray(s))
    assert got is not None and ref is not None
    tol = n * np.finfo(np.float32).eps * np.abs(Z).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol,
                               rtol=0)
    exact = pk.givens_chain_apply_plain(
        torch.as_tensor(Z.astype(np.float64)),
        torch.as_tensor(c.astype(np.float64)),
        torch.as_tensor(s.astype(np.float64)))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("rows,sms,rb", [(2048, 132, 16), (512, 132, 8),
                                         (8192, 132, 32), (64, 132, 8),
                                         (3168, 132, 32), (3136, 132, 16)])
def test_chain_rows_per_block(rows, sms, rb):
    """The chain kernel's rows a block: the most of 32, 16, 8 whose
    blocks still cover three quarters of the SMs."""
    assert pk.chain_rows_per_block(rows, sms) == rb
    blocks = -(-rows // rb)
    assert rb == 8 or 4 * blocks >= 3 * sms


@pytest.mark.parametrize("case", ["rowmajor", "transposed", "unaligned",
                                  "odd_width", "odd_transposed"])
def test_chain_operand_layouts(case):
    """What the kernel's tensor maps take: a unit stride on one axis,
    the other a multiple of 4 elements, 16-byte aligned; anything else
    becomes a padded row-major copy. Outputs keep the operand's
    orientation with a padded leading stride."""
    base = torch.arange(64 * 40, dtype=torch.float32)
    Z = {"rowmajor": base.view(64, 40),
         "transposed": base.view(40, 64).T,
         "unaligned": base[1:1 + 64 * 36].view(64, 36),
         "odd_width": base[:64 * 37].view(64, 37),
         "odd_transposed": base[:37 * 63].view(37, 63).T}[case]
    op, kmaj = pk._chain_operand(Z)
    assert torch.equal(op, Z)
    assert kmaj == (case != "transposed")
    lead = op.stride(0) if kmaj else op.stride(1)
    assert op.stride(1 if kmaj else 0) == 1 and lead % 4 == 0
    assert op.data_ptr() % 16 == 0
    assert (op.data_ptr() == Z.data_ptr()) == (case in ("rowmajor",
                                                        "transposed"))
    out = pk._chain_out(op, kmaj)
    assert out.shape == Z.shape
    assert out.stride(1 if kmaj else 0) == 1
    assert (out.stride(0) if kmaj else out.stride(1)) % 4 == 0


def test_givens_chain_factors_compose_to_dense(rng):
    """The banded block factors, embedded at their anchors and
    multiplied in group order, ARE the dense chain matrix (the
    reference test's identity), and equal the reference's factors."""
    n, blk = 256, 64
    c, s = _angles(rng, n)
    facs = pk.givens_chain_factors(torch.as_tensor(c), torch.as_tensor(s),
                                   n, blk).numpy()
    jfacs = np.asarray(jpk.givens_chain_factors(jnp.asarray(c),
                                                jnp.asarray(s), n, blk,
                                                jnp.float64))
    np.testing.assert_array_equal(facs, jfacs)
    G = np.eye(n)
    for j in range(n // blk):
        a0 = pk._chain_anchor(j, n, blk)
        assert a0 == jpk._chain_anchor(j, n, blk)
        B = np.eye(n)
        B[a0:a0 + 2 * blk, a0:a0 + 2 * blk] = facs[j]
        G = G @ B
    dense = tsvd._givens_chain_matrix(torch.as_tensor(c),
                                      torch.as_tensor(s), n).numpy()
    np.testing.assert_allclose(G, dense, atol=1e-12)


@pytest.mark.parametrize("rows,n,blk", [(256, 256, None), (64, 64, 16),
                                        (256, 128, None), (60, 256, None),
                                        (4096, 4096, None), (64, 48, 16)])
def test_givens_chain_gate_matches_jax(rows, n, blk):
    """The shape rule is the reference's (n % blk, two windows,
    rows % 8, its row-block budget): both gates agree on the CPU for
    f64; on the card only f32 passes."""
    assert pk.givens_chain_eligible(rows, n, torch.float64, blk) \
        == jpk.givens_chain_eligible(rows, n, jnp.float64, blk)
    ok = pk.givens_chain_eligible(rows, n, torch.float32, blk, "cuda")
    assert ok == jpk.givens_chain_eligible(rows, n, jnp.float32, blk)
    assert not pk.givens_chain_eligible(rows, n, torch.float64, blk, "cuda")


def test_chain_apply_cold_routes_dense():
    """Cold cache: both drivers keep the dense compose."""
    assert tsvd._select_chain_apply("steqr2", 256, 256,
                                    torch.float64) is None
    assert tsvd._select_chain_apply("bdsqr", 256, 256, torch.float64) is None


def _tri_case(rng, kind, n):
    """(d, e) of one pass's input: the whole matrix active, or a block
    [ll, m] inside split-off parts (zero off-diagonals around it)."""
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    if kind == "block":
        e[5] = 0.0
        e[20:] = 0.0
    return d, e


def _wilkinson(d, e, m):
    delta = (d[m - 1] - d[m]) / 2
    sgn = 1.0 if delta >= 0 else -1.0
    denom = abs(delta) + np.hypot(delta, e[m - 1])
    return d[m] - sgn * e[m - 1] ** 2 / (denom or 1.0)


@pytest.mark.parametrize("kind", ["full", "block"])
def test_steqr_sweep_plain_matches_reference_scan(rng, kind):
    """One tridiagonal pass: the plain version (clamp, block, Wilkinson
    shift, chase over the active steps only) against the reference's
    gated scan over all n-1 steps from the same (d, e, ll, m, shift),
    f64, to 1e-13 of the scale; identity rotations outside the
    block."""
    n = 40
    d, e = _tri_case(rng, kind, n)
    ll, m = (0, n - 1) if kind == "full" else (6, 20)
    got = pk.steqr_sweep(torch.as_tensor(d), torch.as_tensor(e))
    jd, je, jc, js = jeig._steqr_shifted_sweep(
        jnp.asarray(d), jnp.asarray(e), ll, m, _wilkinson(d, e, m))
    for x, ref in zip(got[:4], (jd, je, jc, js)):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-13)
    assert got[2].dtype == torch.float64
    keep = np.abs(got[1].numpy()) > np.finfo(float).eps * (
        np.abs(got[0].numpy()[:-1]) + np.abs(got[0].numpy()[1:]))
    assert int(got[4]) == int(keep.sum())


@pytest.mark.parametrize("kind", ["full", "block"])
def test_bdsqr_sweep_plain_matches_reference_scan(rng, kind):
    """One bidiagonal pass against the reference's gated scan
    (_bdsqr_shifted_sweep) from the same (d, e, ll, m, shift): the
    dlas2 shift, zeroed when negligible, as the reference's driver
    computes it; f64 to 1e-13 of the scale."""
    n = 40
    d, e = _tri_case(rng, kind, n)
    ll, m = (0, n - 2) if kind == "full" else (6, 19)
    shift = float(jsvd._dlas2_min(jnp.asarray(d[m]), jnp.asarray(e[m]),
                                  jnp.asarray(d[m + 1])))
    assert shift == pk.dlas2_min_plain(d[m], e[m], d[m + 1])
    if (shift / d[ll]) ** 2 < np.finfo(float).eps:
        shift = 0.0
    got = pk.bdsqr_sweep(torch.as_tensor(d), torch.as_tensor(e))
    jd, je, rots = jsvd._bdsqr_shifted_sweep(jnp.asarray(d), jnp.asarray(e),
                                             ll, m, shift)
    for x, ref in zip(got[:6], (jd, je) + tuple(rots)):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-13)


def _sweeps_case(rng, kind, dtype):
    """(d, e, max_passes) of a multi-pass call: the whole matrix active
    or a block inside split-off parts, stopped by the cap; converged on
    input (no pass); converging inside the call (a count of 0 before the
    cap); no pass allowed."""
    if kind in ("full", "block"):
        d, e = _tri_case(rng, kind, 40)
        k = 3
    elif kind == "converged":
        d, e = rng.standard_normal(12), 1e-30 * rng.standard_normal(11)
        k = 4
    elif kind == "stop_at_zero":
        d, e = rng.standard_normal(6), rng.standard_normal(5)
        k = 64
    else:
        d, e = _tri_case(rng, "full", 12)
        k = 0
    return (torch.as_tensor(d.astype(dtype)), torch.as_tensor(e.astype(dtype)),
            k)


def _held_to_one_pass_calls(multi, one_pass, tol_eps, kind, d, e, k):
    """`multi(d, e, k)` IS `one_pass` called while the count above
    tol_eps * eps is above 0, at most k times: d, e, each pass's
    rotation rows, the passes run and the count bitwise; rows past the
    passes run are identity (cosines 1, sines 0)."""
    got = multi(d, e, k)
    n = d.shape[0]
    rots = got[2:-1]
    tol = tol_eps * torch.finfo(d.dtype).eps
    count, p = int(pk.unconverged(d, e, tol)), 0
    assert all(r.shape == (k, n - 1) for r in rots)
    while count > 0 and p < k:
        d, e, *rot, cnt = one_pass(d, e)
        assert all(torch.equal(r[p], x) for r, x in zip(rots, rot))
        count, p = int(cnt), p + 1
    assert torch.equal(got[0], d) and torch.equal(got[1], e)
    assert got[-1].tolist() == [p, count]
    for j, r in enumerate(rots):
        assert torch.equal(r[p:], torch.full_like(r[p:], 1 - j % 2))
    assert {"converged": p == 0 and count == 0,
            "stop_at_zero": 0 < p < k and count == 0,
            "no_pass": p == 0 and count > 0}.get(kind, p == k and count > 0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["full", "block", "converged",
                                  "stop_at_zero", "no_pass"])
def test_steqr_sweeps_plain_equals_one_pass_calls(rng, kind, dtype):
    """The multi-pass entry's plain version IS steqr_sweep_plain called
    while the count is above 0, at most max_passes times: d, e, each
    pass's rotation row, the passes run and the count bitwise; rows
    past the passes run are identity."""
    _held_to_one_pass_calls(pk.steqr_sweeps, pk.steqr_sweep_plain, 1, kind,
                            *_sweeps_case(rng, kind, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["full", "block", "converged",
                                  "stop_at_zero", "no_pass"])
def test_bdsqr_sweeps_plain_equals_one_pass_calls(rng, kind, dtype):
    """The bidiagonal multi-pass entry's plain version IS
    bdsqr_sweep_plain called while the count above 20 eps is above 0,
    at most max_passes times: d, e, each pass's four rotation rows
    (cosr, sinr, cosl, sinl), the passes run and the count bitwise;
    rows past the passes run are identity."""
    _held_to_one_pass_calls(pk.bdsqr_sweeps, pk.bdsqr_sweep_plain, 20, kind,
                            *_sweeps_case(rng, kind, dtype))


def test_sweep_c_signatures():
    """The one-pass entries keep their C signatures; the multi-pass
    entries take the pass cap after eps and return (passes, count) in
    one int pair; the floor measurements take (d, e, n) and two
    int64."""
    import ctypes
    from slate_tpu_torch.ops import _build
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = _build.LIBS["qr_sweep"][1]
    assert entries["steqr_sweep"] == [P, P, I, F, P, P, P, P, P, P]
    assert entries["steqr_sweeps"] == [P, P, I, F, I, P, P, P, P, P, P]
    assert entries["bdsqr_sweep"] == [P, P, I, F, P, P, P, P, P, P, P, P]
    assert entries["bdsqr_sweeps"] == [P, P, I, F, I, P, P, P, P, P, P, P, P]
    assert entries["steqr_chain_cycles"] == [P, P, I, P, P]
    assert entries["bdsqr_chain_cycles"] == [P, P, I, P, P]
    assert _build.LIBS["compose_swaps"][1]["compose_swaps"] == \
        [P, I, I, I, P, P]

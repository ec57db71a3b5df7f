"""The packed bf16 LU solve (ops/kernels.py lu_solve_packed) on the CPU:
its plain version, held against the library route it replaces in
getrs (B permuted, two library triangular solves on the masked, upcast
halves of the factor), and the gate that decides which getrs calls
take it. On the card chip_smoke.py's phase kernel.lu_solve_packed
holds the kernel against both."""

import dataclasses

import numpy as np
import pytest
import torch

import slate_tpu_torch as st
from slate_tpu_torch.core.enums import Op
from slate_tpu_torch.core.tiles import TiledMatrix
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import permuted_boosted_system

MB = 64


def _factor(n, dtype=torch.bfloat16, seed=0):
    """A packed LU factor of a permuted boosted system (every pivot a
    real row swap) in `dtype`, as getrs takes it, and the system."""
    a, _ = permuted_boosted_system(np.random.default_rng(seed), n, 1)
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(a))
    F = tlu.LUFactors(TiledMatrix.from_dense(lu.to(dtype), MB, device="cpu"),
                      (piv - 1).to(torch.int32))
    return F, a


def _rhs(n, k, dtype=torch.bfloat16, seed=1):
    b = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    return TiledMatrix.from_dense(torch.from_numpy(b).to(dtype), MB,
                                  device="cpu")


@pytest.fixture
def spy(monkeypatch):
    """Calls of the packed solve's wrapper, by right-hand sides."""
    calls = []
    orig = pk.lu_solve_packed

    def wrapped(lu, perm, b, k, out=None):
        calls.append(k)
        return orig(lu, perm, b, k, out=out)

    monkeypatch.setattr(pk, "lu_solve_packed", wrapped)
    return calls


def _library(F, B, monkeypatch):
    """getrs with the packed solve gated off: the library route."""
    with monkeypatch.context() as m:
        m.setattr(pk, "lu_solve_packed_reject_reason",
                  lambda *a, **kw: "off")
        return tlu.getrs(F, B).to_dense()


def _bf16_ulp(x):
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _agree(x, ref):
    """The kernel's agreement rule: normwise within 2^-7 and at least
    99% of the entries within one bf16 ulp of the library's. Not
    bitwise: a 1-ulp flip in the bf16 y carries into x through U."""
    x, ref = x.float(), ref.float()
    normwise = torch.linalg.norm(x - ref) / torch.linalg.norm(ref)
    within = (torch.abs(x - ref) <= _bf16_ulp(ref)).float().mean()
    return float(normwise) <= 2.0 ** -7 and float(within) >= 0.99


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [1, 33, 64, 200, 529])
def test_packed_solve_matches_library_route(n, k, spy, monkeypatch):
    """getrs on a bf16 factor takes the packed solve (its plain version
    here) and agrees with the library route by the kernel's rule; 200
    and 529 are not multiples of the kernel's 128-row blocks."""
    F, _ = _factor(n, seed=n)
    B = _rhs(n, k)
    X = tlu.getrs(F, B)
    assert spy == [k]
    assert X.data.shape == B.data.shape and X.dtype == torch.bfloat16
    assert torch.count_nonzero(X.data[n:]) == 0 \
        and torch.count_nonzero(X.data[:, k:]) == 0
    assert _agree(X.to_dense(), _library(F, B, monkeypatch))


def test_packed_solve_permutes_the_right_hand_side(monkeypatch):
    """The factor's swaps compose to a permutation far from the
    identity, and the solve answers the permuted system: A x ~ b."""
    n = 200
    F, a = _factor(n, seed=5)
    perm = tlu._compose_swaps(F.pivots, n)
    assert int((perm != torch.arange(n)).sum()) > n // 2
    B = _rhs(n, 1)
    x = tlu.getrs(F, B).to_dense().double().numpy()
    b = B.to_dense().double().numpy()
    assert np.linalg.norm(a @ x - b) <= 2e-2 * np.linalg.norm(b)
    assert _agree(tlu.getrs(F, B).to_dense(), _library(F, B, monkeypatch))


def test_packed_solve_of_a_zero_rhs_is_zero(spy):
    n = 150
    F, _ = _factor(n)
    X = tlu.getrs(F, TiledMatrix.from_dense(
        torch.zeros((n, 2), dtype=torch.bfloat16), MB, device="cpu"))
    assert spy == [2]
    assert torch.count_nonzero(X.data) == 0


def test_packed_solve_zero_pivot_matches_library(spy, monkeypatch):
    """A zero on U's diagonal: the same inf / nan pattern as the
    library route, and no exception."""
    n = 300
    F, _ = _factor(n, seed=2)
    lu = F.LU.data.clone()
    lu[170, 170] = 0
    F = F._replace(LU=dataclasses.replace(F.LU, data=lu))
    B = _rhs(n, 1)
    x = tlu.getrs(F, B).to_dense().float()
    ref = _library(F, B, monkeypatch).float()
    assert spy == [1]
    assert torch.isinf(x).any() and torch.isnan(x).any()
    assert torch.equal(torch.isnan(x), torch.isnan(ref))
    assert torch.equal(torch.isinf(x), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert torch.equal(x[fin], ref[fin])


def test_plain_version_rounding_points():
    """The plain version rounds y to bf16 between its sweeps: with U
    the identity, x is y rounded to bf16, and with L the identity too,
    x is P b."""
    n = 140
    rng = np.random.default_rng(4)
    eye = torch.eye(n, dtype=torch.bfloat16)
    low = torch.from_numpy(np.tril(rng.standard_normal((n, n)), -1)
                           .astype(np.float32) / n).to(torch.bfloat16)
    perm = torch.from_numpy(rng.permutation(n))
    b = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32)
                         ).to(torch.bfloat16)
    assert torch.equal(pk.lu_solve_packed_plain(eye, perm, b, 2), b[perm])
    y = torch.linalg.solve_triangular(
        (low + eye).float(), b[perm].float(), upper=False,
        unitriangular=True)
    x = pk.lu_solve_packed_plain(low + eye, perm, b, 2)
    assert torch.allclose(x.float(), y.to(torch.bfloat16).float(),
                          rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("case", ["f32", "trans", "conj_trans", "wide",
                                  "band"])
def test_other_solves_keep_the_library_route(case, spy):
    """f32 factors, transposed solves, right-hand sides wider than the
    cap and band factors never reach the packed solve."""
    n = 96
    if case == "band":
        # the windowed band factor, in bf16: getrs hands it to gbtrs
        rng = np.random.default_rng(0)
        a = np.triu(np.tril(rng.standard_normal((n, n)), 3), -2) \
            + 4 * np.eye(n)
        b = rng.standard_normal((n, 2))
        F, _ = st.gbsv(st.BandMatrix(3, 2, a.astype(np.float32), mb=16,
                                     device="cpu"),
                       st.Matrix(b.astype(np.float32), mb=16, device="cpu"))
        F = F._replace(LU=dataclasses.replace(
            F.LU, data=F.LU.data.to(torch.bfloat16)))
        assert F.band
        tlu.getrs(F, _rhs(n, 2))
        assert spy == []
        return
    F, _ = _factor(n, dtype=torch.float32 if case == "f32" else
                   torch.bfloat16)
    k = pk.LU_SOLVE_PACKED_MAX_K + 1 if case == "wide" else 2
    B = _rhs(n, k, dtype=torch.float32 if case == "f32" else torch.bfloat16)
    trans = {"trans": Op.Trans, "conj_trans": Op.ConjTrans}.get(
        case, Op.NoTrans)
    tlu.getrs(F, B, trans=trans)
    assert spy == []


@pytest.mark.parametrize("case,reason", [
    ("trans", "trans"), ("f32", "dtype"), ("f32_b", "dtype"),
    ("rect", "shape"),
    ("short_b", "shape"), ("k0", "rhs"), ("k9", "rhs"), ("ok", None)])
def test_gate_reasons(case, reason):
    lu = torch.zeros((64, 64), dtype=torch.bfloat16)
    b = torch.zeros((64, 16), dtype=torch.bfloat16)
    k = {"k0": 0, "k9": 9}.get(case, 1)
    if case == "f32":
        lu = lu.float()
    if case == "f32_b":
        b = b.float()
    if case == "rect":
        lu = lu[:, :60]
    if case == "short_b":
        b = b[:60]
    assert pk.lu_solve_packed_reject_reason(
        lu, b, k, transposed=case == "trans") == reason
    if reason not in (None, "trans"):
        # the wrapper raises on what its gate rejects
        with pytest.raises(ValueError, match=reason):
            pk.lu_solve_packed(lu, torch.arange(64), b, k)


def test_gesv_mixed_gmres_takes_the_packed_route(spy):
    """Every preconditioner solve of FGMRES on the bf16 factor is one
    packed solve: the first x and 30 a restart cycle (iters counts
    whole cycles of 30), and nothing else calls it."""
    n = 128
    a, b = permuted_boosted_system(np.random.default_rng(9), n, 1)
    F, X, iters = st.gesv_mixed_gmres(st.Matrix(a, mb=32, device="cpu"),
                                      st.Matrix(b, mb=32, device="cpu"))
    assert F.LU.dtype == torch.bfloat16
    assert iters > 0 and iters % 30 == 0
    assert spy == [1] * (1 + iters)
    x = X.to_numpy()
    assert np.linalg.norm(a @ x - b) <= 1e-5 * np.linalg.norm(b)


def test_gesv_mixed_sweeps_take_the_packed_route(spy, monkeypatch):
    """gesv_mixed's IR sweeps on the bf16 factor with 3 right-hand
    sides: each of its getrs calls is one packed solve."""
    n = 128
    a, b = permuted_boosted_system(np.random.default_rng(8), n, 3)
    calls = []
    orig = tlu.getrs
    monkeypatch.setattr(tlu, "getrs", lambda *x, **kw: calls.append(1)
                        or orig(*x, **kw))
    _, X, iters = st.gesv_mixed(st.Matrix(a, mb=32, device="cpu"),
                                st.Matrix(b, mb=32, device="cpu"))
    assert iters >= 0 and len(calls) >= 2
    assert spy == [3] * len(calls)
    x = X.to_numpy()
    assert np.linalg.norm(a @ x - b) <= 1e-5 * np.linalg.norm(b)

"""slate_tpu_torch.core.io and slate_tpu_torch.native against the JAX
package on the CPU: LAPACK and ScaLAPACK layout import / export round
trips (the same seeded numpy inputs through both packages, bitwise:
the repack moves values and computes nothing), the C++ layout engine
against its plain numpy loops (bitwise), where the library is built,
and a failed build raising."""

import os

import numpy as np
import pytest
import torch

from slate_tpu.core import io as jio

from slate_tpu_torch import native
from slate_tpu_torch.core import io as tio

SHAPES = [((70, 45), 32, 16), ((64, 64), 16, None), ((5, 130), 8, 64),
          ((1, 1), 4, 4)]


def _mat(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("shape,mb,nb", SHAPES)
def test_lapack_round_trip_matches_reference(rng, shape, mb, nb):
    a = _mat(rng, shape)
    T = tio.fromLAPACK(a, mb=mb, nb=nb, device="cpu")
    J = jio.fromLAPACK(a, mb=mb, nb=nb)
    assert (T.m, T.n, T.mb, T.nb) == (J.m, J.n, J.mb, J.nb)
    assert np.array_equal(T.data.numpy(), np.asarray(J.data))
    out = tio.toLAPACK(T)
    assert out.flags.f_contiguous
    assert np.array_equal(out, a)
    assert np.array_equal(out, jio.toLAPACK(J))


@pytest.mark.parametrize("p,q", [(1, 1), (2, 3)])
@pytest.mark.parametrize("shape,mb,nb", SHAPES)
def test_scalapack_round_trip_matches_reference(rng, shape, mb, nb, p, q):
    a = _mat(rng, shape)
    nb = nb or mb
    T = tio.fromLAPACK(a, mb=mb, nb=nb, device="cpu")
    J = jio.fromLAPACK(a, mb=mb, nb=nb)
    locs = tio.toScaLAPACK(T, p, q)
    jlocs = jio.toScaLAPACK(J, p, q)
    assert sorted(locs) == sorted(jlocs) == \
        [(i, j) for i in range(p) for j in range(q)]
    for k, loc in locs.items():
        assert loc.flags.f_contiguous
        assert np.array_equal(loc, jlocs[k]), k
    items = [(pi, qi, loc) for (pi, qi), loc in locs.items()]
    B = tio.fromScaLAPACK(items, *shape, mb, nb, p, q, device="cpu")
    JB = jio.fromScaLAPACK(items, *shape, mb, nb, p, q)
    assert np.array_equal(B.data.numpy(), np.asarray(JB.data))
    assert np.array_equal(B.to_numpy(), a)


def test_f64_round_trips():
    """f64 stays f64 (the reference's arrays follow JAX's x64 mode)."""
    a = np.random.default_rng(3).standard_normal((33, 17))
    T = tio.fromLAPACK(a, mb=8, device="cpu")
    assert T.dtype == torch.float64
    assert np.array_equal(tio.toLAPACK(T), a)
    locs = tio.toScaLAPACK(T, 2, 3)
    B = tio.fromScaLAPACK([(i, j, x) for (i, j), x in locs.items()],
                          33, 17, 8, 8, 2, 3, device="cpu")
    assert np.array_equal(B.to_numpy(), a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_bitwise_plain(rng, dtype):
    m, n, mb, nb = 70, 45, 16, 8
    a = np.asfortranarray(_mat(rng, (m, n), dtype))
    packed = native.pack_colmajor(a, 80, 48)
    assert np.array_equal(packed, native.pack_colmajor_plain(a, 80, 48))
    un = native.unpack_colmajor(packed, m, n)
    assert un.flags.f_contiguous
    assert np.array_equal(un, native.unpack_colmajor_plain(packed, m, n))
    for p, q in ((1, 1), (2, 3), (3, 2)):
        for pi in range(p):
            for qi in range(q):
                llm = max(sum(1 for t in range(-(-m // mb))
                              if t % p == pi), 1) * mb
                lln = max(sum(1 for t in range(-(-n // nb))
                              if t % q == qi), 1) * nb
                loc = native.bc_export(packed, m, n, mb, nb, p, q, pi, qi,
                                       llm, lln)
                assert np.array_equal(loc, native.bc_export_plain(
                    packed, m, n, mb, nb, p, q, pi, qi, llm, lln))
                d1 = np.zeros_like(packed)
                d2 = np.zeros_like(packed)
                native.bc_import(loc, d1, m, n, mb, nb, p, q, pi, qi)
                native.bc_import_plain(loc, d2, m, n, mb, nb, p, q, pi, qi)
                assert np.array_equal(d1, d2)


def test_native_builds_into_build_dir():
    """The library is built from the port's layout.cc into build/ at the
    checkout's root, never beside the source."""
    lib = native.get_lib()
    assert lib.slate_tpu_native_abi_version() == native.ABI_VERSION
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "build"
    assert os.path.exists(path)
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


def test_native_validates_before_passing_pointers():
    a = np.ones((10, 10), np.float32)
    with pytest.raises(ValueError):
        native.pack_colmajor(a, 8, 16)
    with pytest.raises(ValueError):
        native.unpack_colmajor(a, 11, 4)
    with pytest.raises(ValueError):
        native.bc_export(a, 10, 10, 4, 4, 2, 2, 2, 0, 8, 8)
    with pytest.raises(ValueError):
        native.bc_import(np.ones((2, 2), np.float32), a, 10, 10, 4, 4, 2,
                         2, 0, 0)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises: nothing quietly takes the
    numpy loops."""
    bad = tmp_path / "layout.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="build failed"):
        native.pack_colmajor(np.ones((4, 4), np.float32), 4, 4)

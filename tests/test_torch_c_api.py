"""The port's C API (``slate_tpu_torch/c_api``) against the JAX package.

  * the reference test's C program (tests/test_c_api.py), compiled
    against the port's header and run with ``slate_tpu_init("cpu")``,
    its embedded interpreter handed this interpreter's ``sys.path``;
  * the library loaded in this process with ``ctypes.CDLL`` (the shim's
    "Python already up" path): every ``slate_*`` function on seeded f64
    buffers, each result against the JAX package's driver on the same
    arrays within 1e-10, gesv's pivots equal;
  * the header's eight signatures equal the reference header's, and the
    build without ``python3-config`` (flags from ``sysconfig``)."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest

import slate_tpu as jst
from slate_tpu.c_api import HEADER as JHEADER

from slate_tpu_torch import c_api

TOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_c_program() -> str:
    src = open(os.path.join(REPO, "tests", "test_c_api.py")).read()
    return re.search(r'C_MAIN = r"""(.*?)"""', src, re.S).group(1)


def _signatures(path) -> list:
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    return [" ".join(s.split()) for s in
            re.findall(r"^int slate_\w+\([^)]*\);", text, re.M)]


def test_header_signatures_match_reference():
    sigs = _signatures(c_api.HEADER)
    assert len(sigs) == 8
    assert sigs == _signatures(JHEADER)


@pytest.fixture(scope="module")
def lib():
    return c_api.build_library()


@pytest.fixture(scope="module")
def c_program(lib, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("c_api")
    src = tmp / "main.c"
    src.write_text(_reference_c_program())
    exe = tmp / "c_demo"
    subprocess.run(
        ["gcc", "-O1", str(src), "-o", str(exe),
         f"-I{c_api.HEADER.parent}", str(lib),
         f"-Wl,-rpath,{lib.parent}", "-lm"],
        check=True, capture_output=True, timeout=180)
    return exe


def test_reference_c_program_end_to_end(c_program):
    out = subprocess.run([str(c_program)], env=c_api.embed_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, f"stdout:{out.stdout}\nstderr:{out.stderr}"
    assert "C API OK" in out.stdout
    assert "NONSPD INFO 6" in out.stdout     # exact failing minor


def test_unknown_platform_is_refused(c_program, tmp_path):
    """A C program naming an unknown platform gets -102."""
    src = tmp_path / "bad.c"
    src.write_text('#include <stdio.h>\n#include "slate_c.h"\n'
                   'int main(void) { printf("INIT %d\\n", '
                   'slate_tpu_init("tpu")); return 0; }\n')
    exe = tmp_path / "bad"
    lib = c_api.SO
    subprocess.run(["gcc", str(src), "-o", str(exe),
                    f"-I{c_api.HEADER.parent}", str(lib),
                    f"-Wl,-rpath,{lib.parent}"], check=True, timeout=120)
    out = subprocess.run([str(exe)], env=c_api.embed_env(),
                         capture_output=True, text=True, timeout=300)
    assert "INIT -102" in out.stdout, out.stderr


I64, DBL, PTR = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
CH = ctypes.c_char
#: slate_c.h's prototypes
ARGTYPES = {
    "slate_tpu_init": [ctypes.c_char_p],
    "slate_potrf": [CH, I64, PTR, I64],
    "slate_gesv": [CH, I64, I64, PTR, I64, PTR, PTR, I64],
    "slate_posv": [CH, I64, I64, PTR, I64, PTR, I64],
    "slate_gemm": [CH, I64, I64, I64, DBL, PTR, I64, PTR, I64, DBL, PTR,
                   I64],
    "slate_gels": [CH, I64, I64, I64, PTR, I64, PTR, I64],
    "slate_heev": [CH, I64, PTR, I64, PTR],
    "slate_svd_vals": [CH, I64, I64, PTR, I64, PTR],
}


@pytest.fixture(scope="module")
def cdll(lib):
    so = ctypes.CDLL(str(lib))
    for name, args in ARGTYPES.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    assert so.slate_tpu_init(b"cpu") == 0
    return so


def _p(x):
    return x.ctypes.data_as(ctypes.c_void_p)


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T / n + 4 * np.eye(n)


@pytest.mark.parametrize("n", [24, 70])
def test_potrf_posv_match_jax(cdll, rng, n):
    s = _spd(rng, n)
    a = s.copy()
    assert cdll.slate_potrf(ctypes.c_char(b"d"), I64(n), _p(a), I64(n)) == 0
    L = jst.potrf(jst.HermitianMatrix(jst.Uplo.Lower, s, mb=min(n, 256)))
    np.testing.assert_allclose(a, np.tril(L.to_numpy()), atol=TOL)

    b = rng.standard_normal((n, 3))
    a, x = s.copy(), b.copy()
    assert cdll.slate_posv(ctypes.c_char(b"d"), I64(n), I64(3), _p(a),
                           I64(n), _p(x), I64(3)) == 0
    _, X = jst.posv(jst.HermitianMatrix(jst.Uplo.Lower, s, mb=min(n, 256)),
                    jst.Matrix(b, mb=min(n, 256)))
    np.testing.assert_allclose(x, X.to_numpy(), atol=TOL)
    np.testing.assert_allclose(a, np.tril(a), atol=0)
    # a non-SPD matrix reports its failing minor, as the JAX driver
    bad = s.copy()
    bad[5, 5] = -1000.0
    _, _, jinfo = jst.posv(jst.HermitianMatrix(jst.Uplo.Lower, bad, mb=8),
                           jst.Matrix(b, mb=8), return_info=True)
    assert cdll.slate_posv(ctypes.c_char(b"d"), I64(n), I64(3),
                           _p(bad.copy()), I64(n), _p(b.copy()),
                           I64(3)) == int(jinfo) == 6


@pytest.mark.parametrize("n", [24, 300])
def test_gesv_matches_jax(cdll, rng, n):
    g = rng.standard_normal((n, n))
    b = rng.standard_normal((n, 2))
    a, x = g.copy(), b.copy()
    ipiv = np.zeros(n, np.int32)
    assert cdll.slate_gesv(ctypes.c_char(b"d"), I64(n), I64(2), _p(a),
                           I64(n), _p(ipiv), _p(x), I64(2)) == 0
    F, X = jst.gesv(jst.Matrix(g, mb=min(n, 256)),
                    jst.TiledMatrix.from_dense(b, min(n, 256)))
    assert np.array_equal(ipiv, np.asarray(F.pivots)[:n])
    np.testing.assert_allclose(a, F.LU.to_numpy(), atol=TOL)
    np.testing.assert_allclose(x, X.to_numpy(), atol=TOL)


def test_gemm_strided_matches_jax(cdll, rng):
    """Row strides wider than the columns (lda > k etc.)."""
    m, n, k = 20, 13, 9
    A = rng.standard_normal((m, k + 3))
    B = rng.standard_normal((k, n + 1))
    C = rng.standard_normal((m, n + 5))
    c = C.copy()
    assert cdll.slate_gemm(ctypes.c_char(b"d"), I64(m), I64(n), I64(k),
                           DBL(1.5), _p(A), I64(k + 3), _p(B), I64(n + 1),
                           DBL(-0.5), _p(c), I64(n + 5)) == 0
    J = jst.gemm(1.5, jst.Matrix(A[:, :k], mb=20),
                 jst.Matrix(B[:, :n], mb=20), -0.5,
                 jst.TiledMatrix.from_dense(C[:, :n].copy(), 20))
    np.testing.assert_allclose(c[:, :n], J.to_numpy(), atol=TOL)
    assert np.array_equal(c[:, n:], C[:, n:])      # outside: untouched


def test_gels_matches_jax(cdll, rng):
    m, n = 60, 20
    A = rng.standard_normal((m, n))
    b = rng.standard_normal((m, 2))
    x = b.copy()
    assert cdll.slate_gels(ctypes.c_char(b"d"), I64(m), I64(n), I64(2),
                           _p(A.copy()), I64(n), _p(x), I64(2)) == 0
    X = jst.gels(jst.Matrix(A, mb=60), jst.TiledMatrix.from_dense(b, 60))
    np.testing.assert_allclose(x[:n], X.to_numpy()[:n], atol=TOL)
    np.testing.assert_allclose(x[:n], np.linalg.lstsq(A, b, rcond=None)[0],
                               atol=1e-10)


def test_heev_svd_vals_match_jax(cdll, rng):
    n = 40
    g = rng.standard_normal((n, n))
    h = (g + g.T) / 2
    w = np.zeros(n)
    assert cdll.slate_heev(ctypes.c_char(b"d"), I64(n), _p(h.copy()),
                           I64(n), _p(w)) == 0
    jw, _ = jst.heev(jst.HermitianMatrix(jst.Uplo.Lower, h, mb=40))
    np.testing.assert_allclose(w, np.asarray(jw)[:n], atol=TOL)
    m = 50
    r = rng.standard_normal((m, n))
    s = np.zeros(n)
    assert cdll.slate_svd_vals(ctypes.c_char(b"d"), I64(m), I64(n),
                               _p(r.copy()), I64(n), _p(s)) == 0
    js = jst.svd_vals(jst.Matrix(r, mb=50))
    np.testing.assert_allclose(s, np.asarray(js)[:n], atol=TOL)


def test_f32_and_quick_returns(cdll, rng):
    n = 16
    s = _spd(rng, n).astype(np.float32)
    b = rng.standard_normal((n, 1)).astype(np.float32)
    x = b.copy()
    assert cdll.slate_posv(ctypes.c_char(b"s"), I64(n), I64(1),
                           _p(s.copy()), I64(n), _p(x), I64(1)) == 0
    assert np.abs(s @ x - b).max() < 1e-4
    assert cdll.slate_gesv(ctypes.c_char(b"d"), I64(0), I64(1), None,
                           I64(1), None, None, I64(1)) == 0
    # a dtype the bridge does not take fails with -1, no crash
    assert cdll.slate_potrf(ctypes.c_char(b"q"), I64(n), _p(s.copy()),
                            I64(n)) == -1


def test_build_without_python3_config(monkeypatch, tmp_path):
    """The flags from sysconfig alone build a library that exports the
    eight functions."""
    monkeypatch.setattr(c_api.shutil, "which", lambda name: None)
    monkeypatch.setattr(c_api, "SO", tmp_path / "libslate_alt.so")
    so = c_api.build_library()
    assert so == tmp_path / "libslate_alt.so" and so.exists()
    syms = subprocess.run(["nm", "-D", "--defined-only", str(so)],
                          capture_output=True, text=True).stdout
    for name in ("slate_tpu_init", "slate_potrf", "slate_gesv",
                 "slate_posv", "slate_gemm", "slate_gels", "slate_heev",
                 "slate_svd_vals"):
        assert name in syms

"""BLAS-3 (twin of examples/ex05_blas.py: gemm n=2048 nb=256 config of
the reference's ex05_blas.cc, scaled down)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch import Side, Uplo  # noqa: E402

n, nb = 512, 128     # scaled-down smoke config of ex05's 2048/256
rng = np.random.default_rng(0)
a = rng.standard_normal((n, n)).astype(np.float32)
b = rng.standard_normal((n, n)).astype(np.float32)
C = st.gemm(1.0, st.Matrix(a, mb=nb, device=dev),
            st.Matrix(b, mb=nb, device=dev),
            0.0, st.Matrix(np.zeros_like(a), mb=nb, device=dev))
assert np.allclose(C.to_numpy(), a @ b, atol=1e-2)
T = st.TriangularMatrix(Uplo.Lower, a + n * np.eye(n, dtype=np.float32),
                        mb=nb, device=dev)
X = st.trsm(Side.Left, 1.0, T, st.Matrix(b, mb=nb, device=dev))
print("gemm/trsm ok")

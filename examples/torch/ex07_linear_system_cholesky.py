"""Cholesky solve, the north-star config (twin of
examples/ex07_linear_system_cholesky.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

n = 256
rng = np.random.default_rng(0)
x = rng.standard_normal((n, n)).astype(np.float32)
a = x @ x.T / n + 4 * np.eye(n, dtype=np.float32)
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=64, device=dev)
b = rng.standard_normal((n, 4)).astype(np.float32)
L, X = st.posv(A, st.Matrix(b, mb=64, device=dev))
r = np.linalg.norm(a @ X.to_numpy() - b) / np.linalg.norm(b)
print(f"posv resid {r:.2e}")
assert r < 1e-4
Ainv = st.potri(L)
assert np.abs(Ainv.to_numpy() @ a - np.eye(n)).max() < 1e-2

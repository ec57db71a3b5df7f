"""Symmetric-indefinite Aasen solve (twin of
examples/ex08_linear_system_indefinite.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

n = 128
rng = np.random.default_rng(0)
a = rng.standard_normal((n, n)).astype(np.float32)
a = (a + a.T) / 2          # indefinite
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=32, device=dev)
b = rng.standard_normal((n, 2)).astype(np.float32)
F, X = st.hesv(A, st.Matrix(b, mb=32, device=dev))
r = np.linalg.norm(a @ X.to_numpy() - b) / np.linalg.norm(b)
print(f"hesv resid {r:.2e}")
assert r < 1e-3

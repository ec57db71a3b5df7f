"""Generalized Hermitian eigenproblem (twin of
examples/ex12_generalized_eig.py), in f32 as the reference's."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

n = 96
rng = np.random.default_rng(0)
a = rng.standard_normal((n, n)); a = ((a + a.T) / 2).astype(np.float32)
bm = rng.standard_normal((n, n))
b = (bm @ bm.T + n * np.eye(n)).astype(np.float32)
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=32, device=dev)
B = st.HermitianMatrix(st.Uplo.Lower, b, mb=32, device=dev)
w, V = st.hegv(1, A, B)
v = V.to_numpy()
w = w.cpu().numpy()
err = np.abs(a @ v - b @ v * w[None, :]).max()
scale = np.abs(a).max() + np.abs(w).max() * np.abs(b).max()
print("hegv resid:", err, "scale:", scale)
assert err < 2e-4 * scale   # ~n * eps_f32 * ||problem||

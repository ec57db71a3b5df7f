"""Hermitian eigensolver (twin of examples/ex11_hermitian_eig.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

n = 128
rng = np.random.default_rng(0)
a = rng.standard_normal((n, n)).astype(np.float32)
a = (a + a.T) / 2
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=32, device=dev)
w, V = st.heev(A)
v = V.to_numpy()
err = np.abs(a @ v - v * w.cpu().numpy()[None, :]).max()
print("heev resid:", err)
assert err < 1e-3

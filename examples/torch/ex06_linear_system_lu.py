"""LU solves incl. mixed precision (twin of
examples/ex06_linear_system_lu.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

n = 256
rng = np.random.default_rng(0)
a = rng.standard_normal((n, n)).astype(np.float32) \
    + 0.3 * n * np.eye(n, dtype=np.float32)
b = rng.standard_normal((n, 4)).astype(np.float32)
F, X = st.gesv(st.Matrix(a, mb=64, device=dev),
               st.Matrix(b, mb=64, device=dev))
r = np.linalg.norm(a @ X.to_numpy() - b) / np.linalg.norm(b)
print(f"gesv resid {r:.2e}")
assert r < 1e-4
F2, X2, iters = st.gesv_mixed(st.Matrix(a, mb=64, device=dev),
                              st.Matrix(b, mb=64, device=dev))
print(f"gesv_mixed ({F2.LU.dtype} factor) converged in {int(iters)} iters")
_, X3 = st.gesv_rbt(st.Matrix(a, mb=64, device=dev),
                    st.Matrix(b, mb=64, device=dev))
assert np.linalg.norm(a @ X3.to_numpy() - b) / np.linalg.norm(b) < 1e-3

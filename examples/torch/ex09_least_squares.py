"""Tall-skinny least squares (twin of examples/ex09_least_squares.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

m, n = 1024, 64
rng = np.random.default_rng(0)
a = rng.standard_normal((m, n)).astype(np.float32)
b = rng.standard_normal((m, 2)).astype(np.float32)
X = st.gels(st.Matrix(a, mb=64, device=dev), st.Matrix(b, mb=64, device=dev))
x = X.to_numpy()[:n]
xnp, *_ = np.linalg.lstsq(a, b, rcond=None)
assert np.allclose(x, xnp, atol=1e-2)
print("gels (router) ok; QR vs CholQR:")
x1 = st.gels_qr(st.Matrix(a, mb=64, device=dev),
                st.Matrix(b, mb=64, device=dev)).to_numpy()[:n]
x2 = st.gels_cholqr(st.Matrix(a, mb=64, device=dev),
                    st.Matrix(b, mb=64, device=dev)).to_numpy()[:n]
print("  max diff:", np.abs(x1 - x2).max())

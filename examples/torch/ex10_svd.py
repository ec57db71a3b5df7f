"""SVD (twin of examples/ex10_svd.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

m, n = 192, 128
rng = np.random.default_rng(0)
a = rng.standard_normal((m, n)).astype(np.float32)
s, U, Vh = st.svd(st.Matrix(a, mb=64, device=dev))
s = s.cpu().numpy()
rec = (U.to_numpy() * s[None, :]) @ Vh.to_numpy()
print("svd recon err:", np.abs(rec - a).max())
assert np.abs(rec - a).max() < 1e-3
vals = st.svd_vals(st.Matrix(a, mb=64, device=dev)).cpu().numpy()
assert np.allclose(vals, s, atol=1e-3)

"""Communication-avoiding kernels and method routing (twin of
examples/ex15_ca_and_methods.py: getrf_tntpiv tournament LU, ttqrt tree
QR, the method.hh variants)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.core.methods import MethodGels, MethodLU  # noqa: E402
from slate_tpu_torch.core.options import Option  # noqa: E402

rng = np.random.default_rng(1)

# CALU: tournament pivot selection instead of per-column argmax
n = 384
a = rng.standard_normal((n, n)).astype(np.float32) \
    + 0.1 * n * np.eye(n, dtype=np.float32)
b = rng.standard_normal((n, 2)).astype(np.float32)
F, X = st.gesv(st.Matrix(a, mb=64, device=dev),
               st.TiledMatrix.from_dense(b, 64, device=dev),
               {Option.MethodLU: MethodLU.CALU})
r = np.abs(a @ X.to_numpy() - b).max()
print(f"CALU gesv resid {r:.2e}")
assert r < 1e-2

# TSQR: tree QR for a very tall-skinny least squares problem
m, k = 4096, 24
t = rng.standard_normal((m, k)).astype(np.float32)
c = rng.standard_normal((m, 1)).astype(np.float32)
X2 = st.gels(st.Matrix(t, mb=256, device=dev),
             st.TiledMatrix.from_dense(c, 256, device=dev),
             {Option.MethodGels: MethodGels.TSQR})
x_ref = np.linalg.lstsq(t, c, rcond=None)[0]
err = np.abs(X2.to_numpy()[:k] - x_ref).max()
print(f"TSQR gels vs lstsq {err:.2e}")
assert err < 1e-4

# phase timers (reference timers map)
from slate_tpu_torch.utils import Timers  # noqa: E402
tm = Timers()
st.posv(st.HermitianMatrix(st.Uplo.Lower,
                           a @ a.T / n + 4 * np.eye(n, dtype=np.float32),
                           mb=64, device=dev),
        st.TiledMatrix.from_dense(b, 64, device=dev), {Option.Timers: tm})
print("phase timers:", tm)

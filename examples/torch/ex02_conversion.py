"""Transpose-by-flag and dtype conversion (twin of
examples/ex02_conversion.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import torch  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

a = np.random.default_rng(0).standard_normal((6, 4))
A = st.Matrix(a, mb=2, device=dev)
At = A.T
assert At.shape == (4, 6)
assert np.allclose(At.to_numpy(), a.T)
B32 = st.copy(A, st.TiledMatrix.zeros(6, 4, 2, dtype=torch.float32,
                                      device=dev))
print("converted:", B32.dtype)

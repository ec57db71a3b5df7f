"""sub() / slice() views (twin of examples/ex03_submatrix.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

a = np.random.default_rng(0).standard_normal((8, 8))
A = st.Matrix(a, mb=2, device=dev)
S = A.sub(1, 2, 1, 2)
assert np.allclose(S.to_numpy(), a[2:6, 2:6])
E = A.slice(1, 4, 3, 6)
assert np.allclose(E.to_numpy(), a[1:5, 3:7])
print("sub/slice ok")

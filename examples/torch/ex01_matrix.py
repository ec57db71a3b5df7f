"""Creating tiled matrices (twin of examples/ex01_matrix.py; reference
examples/ex01_matrix.cc). --device names where the data lives (default:
the CUDA card)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import torch  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

A = st.Matrix(np.arange(12.0).reshape(4, 3), mb=2, device=dev)
print("A:", A.shape, "tiles", A.mt, "x", A.nt)
Z = st.TiledMatrix.zeros(100, 50, 32, dtype=torch.float32, device=dev)
print("Z:", Z.shape, Z.dtype)
H = st.HermitianMatrix(st.Uplo.Lower, np.eye(6), mb=2, device=dev)
print("H uplo:", H.uplo.name)
assert A.tileMb(1) == 2 and A.tileNb(1) == 1

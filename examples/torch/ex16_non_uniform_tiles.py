"""Non-uniform tile sizes (twin of examples/ex16_non_uniform_tiles.py;
reference ex13_non_uniform_block_size.cc, BaseMatrix.hh:80-101
per-index tileMb/tileNb lambdas).

The storage stays one exact dense tensor, the boundaries are indexing
metadata; `uniform()` bridges into the factorization drivers, which
also re-tile a non-uniform input at entry."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch import TiledMatrix  # noqa: E402

rng = np.random.default_rng(0)
n = 24
a = rng.standard_normal((n, n)).astype(np.float32)

# custom per-index tile sizes: a small first block then wide blocks
# (the reference example's use case: boundary layers / domain edges)
sizes = [4, 8, 8, 4]
A = TiledMatrix.from_func(a, sizes, device=dev)
assert A.mt == A.nt == 4
assert [A.tileMb(i) for i in range(A.mt)] == sizes
assert np.allclose(A.tile(1, 2).cpu().numpy(), a[4:12, 12:20])

# lambda form (func.uniform_blocksize is the uniform special case)
from slate_tpu_torch.core.func import uniform_blocksize  # noqa: E402
B = TiledMatrix.from_func(a, uniform_blocksize(n, 7), device=dev)
assert [B.tileMb(i) for i in range(B.mt)] == [7, 7, 7, 3]

# sub() keeps the non-uniform structure, re-based
S = A.sub(1, 2, 1, 2)
assert np.allclose(S.to_numpy(), a[4:20, 4:20])
assert [S.tileMb(i) for i in range(S.mt)] == [8, 8]

# gemm consumes non-uniform operands directly
b = rng.standard_normal((n, n)).astype(np.float32)
C = st.gemm(1.0, A, TiledMatrix.from_func(b, sizes, device=dev), 0.0,
            TiledMatrix.from_func(np.zeros_like(a), sizes, device=dev))
assert np.allclose(C.to_numpy(), a @ b, atol=1e-4)

# factorizations re-tile uniformly at entry
F = st.getrf(A.uniform())
x = st.getrs(F, st.Matrix(b[:, :2], mb=8, device=dev))
assert np.allclose(a @ x.to_numpy(), b[:, :2], atol=1e-3)
print("non-uniform tiles ok")

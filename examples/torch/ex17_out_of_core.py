"""Out-of-core streaming drivers (twin of examples/ex17_out_of_core.py,
at its sizes; linalg/ooc.py): the matrix lives in host memory and
streams through the device one column panel at a time, the huge-n
regime where n^2 exceeds device memory (SURVEY §2.3.8). The streaming
engine (linalg/stream.py) adds a panel-residency cache on the device
and asynchronous prefetch / writeback; budget 0 (the default) is the
plain uncached stream, a byte budget turns revisit uploads into cache
hits (shown at the end)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
from slate_tpu_torch.linalg.ooc import (gels_ooc, gemm_ooc,  # noqa: E402
                                        gesv_ooc, posv_ooc, potrf_ooc)

rng = np.random.default_rng(0)

# out-of-core Cholesky: panels much smaller than the matrix, so the
# left-looking schedule revisits every prior panel (the streamed path)
n = 768
x = rng.standard_normal((n, n)).astype(np.float32)
a = x @ x.T / n + 4.0 * np.eye(n, dtype=np.float32)
L = potrf_ooc(a, panel_cols=128, device=dev)
r = np.abs(a - L @ L.T).max() / np.abs(a).max()
print(f"potrf_ooc n={n} panel=128 rel resid {r:.2e}")
assert r < 1e-5
assert np.allclose(L, np.tril(L))

# streamed Cholesky solve: each factor panel passes through the device
# twice (non-unit forward sweep, conjugate-transposed backward sweep)
bs = rng.standard_normal((n, 2)).astype(np.float32)
_, xs = posv_ooc(a, bs, panel_cols=128, device=dev)
rs = np.abs(a @ xs - bs).max() / np.abs(bs).max()
print(f"posv_ooc  n={n} panel=128 rel resid {rs:.2e}")
assert rs < 1e-4

# out-of-core LU solve: left-looking streamed panels with partial
# pivoting confined to the resident panel (pivot sequence identical
# to in-core getrf), host-side row fixups on the written factor
ag = (rng.standard_normal((n, n)) + 0.1 * n * np.eye(n)).astype(np.float32)
bg = rng.standard_normal((n, 3)).astype(np.float32)
_, xg = gesv_ooc(ag, bg, panel_cols=128, device=dev)
rg = np.abs(ag @ xg - bg).max()
print(f"gesv_ooc  n={n} panel=128 max resid {rg:.2e}")
assert rg < 1e-4

# out-of-core least squares: streamed Householder QR (compact-WY
# visits), Q^H b by reflector-panel stream, R back-substitution
mq, nq = 1500, 384
aq = rng.standard_normal((mq, nq)).astype(np.float32)
bq = rng.standard_normal((mq, 2)).astype(np.float32)
_, xq = gels_ooc(aq, bq, panel_cols=128, device=dev)
ref, *_ = np.linalg.lstsq(aq.astype(np.float64),
                          bq.astype(np.float64), rcond=None)
print(f"gels_ooc  {mq}x{nq} panel=128 vs lstsq "
      f"{np.abs(xq - ref).max():.2e}")
assert np.abs(xq - ref).max() < 1e-3      # f32 factorization

# streaming gemm: A and C move in row panels, B stays resident;
# beta=0 follows BLAS (C never read)
m, k, p = 1000, 256, 192
A = rng.standard_normal((m, k)).astype(np.float32)
B = rng.standard_normal((k, p)).astype(np.float32)
C = np.empty((m, p), np.float32)            # uninitialized is legal
got = gemm_ooc(1.0, A, B, 0.0, C, row_panel=256, device=dev)
err = np.abs(got - A @ B).max()
print(f"gemm_ooc {m}x{k}x{p} beta=0 err {err:.2e}")
assert err < 1e-2

# panel-residency cache: give the engine a budget (here: six full
# panels) and the left-looking revisits are served from device
# memory: bit-identical result, a fraction of the H2D traffic
from slate_tpu_torch.linalg import stream  # noqa: E402
budget = 6 * n * 128 * a.itemsize
Lc = potrf_ooc(a, panel_cols=128, cache_budget_bytes=budget, device=dev)
s = stream.last_stats()
assert np.array_equal(L, Lc)            # cache-on == cache-off, exactly
print(f"potrf_ooc cached: hit rate {s['hit_rate']:.0%} "
      f"({s['hits']} hits / {s['misses']} misses, "
      f"{s['evictions']} evictions), "
      f"served {s['served_bytes'] / 1e6:.1f} MB from the device")
assert s["hits"] > 0

print("out-of-core streaming ok")

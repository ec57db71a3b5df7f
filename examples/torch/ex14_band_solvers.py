"""Band solvers exploiting band structure (twin of
examples/ex14_band_solvers.py: pbtrf/gbtrf/tbsm, the windowed
O(n*kd^2) algorithms of linalg/band.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402

rng = np.random.default_rng(0)
n, kd, nb = 512, 8, 32

# SPD band: pbsv runs the windowed band Cholesky + band solves
a = rng.standard_normal((n, n)).astype(np.float32)
band = np.triu(np.tril(a + a.T, kd), -kd) \
    + 30 * np.eye(n, dtype=np.float32)
A = st.HermitianBandMatrix(st.Uplo.Lower, kd, band, mb=nb, device=dev)
b = rng.standard_normal((n, 3)).astype(np.float32)
L, X = st.pbsv(A, st.TiledMatrix.from_dense(b, nb, device=dev))
r = np.abs(band @ X.to_numpy() - b).max()
print(f"pbsv n={n} kd={kd} resid {r:.2e}")
assert r < 1e-3
# the factor stays within the band
assert np.allclose(np.tril(L.to_numpy(), -(kd + 1)), 0)

# general band LU: LAPACK gbtrf pivot convention (fill-in to kl+ku,
# block-local swaps replayed by gbtrs)
kl, ku = 5, 3
g = np.triu(np.tril(rng.standard_normal((n, n)).astype(np.float32),
                    kl), -ku).T + 20 * np.eye(n, dtype=np.float32)
F, Y = st.gbsv(st.BandMatrix(kl, ku, g, mb=nb, device=dev),
               st.TiledMatrix.from_dense(b, nb, device=dev))
r = np.abs(g @ Y.to_numpy() - b).max()
print(f"gbsv n={n} kl={kl} ku={ku} resid {r:.2e} (band path: {F.band})")
assert r < 1e-3 and F.band

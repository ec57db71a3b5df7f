"""Norms (twin of examples/ex04_norm.py)."""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch import Norm  # noqa: E402

a = np.random.default_rng(0).standard_normal((64, 32))
A = st.Matrix(a, mb=16, device=dev)
for nrm, ref in [(Norm.One, np.abs(a).sum(0).max()),
                 (Norm.Inf, np.abs(a).sum(1).max()),
                 (Norm.Fro, np.linalg.norm(a)),
                 (Norm.Max, np.abs(a).max())]:
    v = float(st.norm(nrm, A))
    assert np.isclose(v, ref), (nrm, v, ref)
    print(f"{nrm.name:4s} norm = {v:.4f}")

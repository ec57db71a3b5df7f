"""Distributed solve over a process grid (twin of
examples/ex13_distributed_mesh.py): a p x q grid over every rank of
the torch.distributed world this example runs in, the posv grid route
under Option.Grid.

Alone it is a world of one rank (the one-device grid). Under
testing.multiproc it is a rank of that launch:
    multiproc.launch("examples/torch/ex13_distributed_mesh.py", 4,
                     extra_args=["--device", "cpu"])   # four gloo ranks
"""
import argparse, pathlib, sys; sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))  # noqa
ap = argparse.ArgumentParser(); ap.add_argument("--device", default="cuda")
ap.add_argument("launch", nargs="*",
                help="<rank> <rendezvous> <ranks>, from testing.multiproc")
args = ap.parse_args()
dev = args.device
import numpy as np  # noqa: E402
import slate_tpu_torch as st  # noqa: E402
from slate_tpu_torch.testing import multiproc as mp  # noqa: E402

if args.launch:
    rank, rdzv, nprocs = int(args.launch[0]), args.launch[1], \
        int(args.launch[2])
    mp.init(rank, rdzv, nprocs, device=dev)
grid = st.make_grid(device=dev)      # every rank, near-square
print(f"grid: {grid.p} x {grid.q} over {grid.nprocs} rank(s)")
n, nb = 256, 32
rng = np.random.default_rng(0)
x = rng.standard_normal((n, n)).astype(np.float32)
a = x @ x.T / n + 4 * np.eye(n, dtype=np.float32)
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, device=grid.device)
b = rng.standard_normal((n, 4)).astype(np.float32)
B = st.Matrix(b, mb=nb, device=grid.device)
L, X = st.posv(A, B, {st.Option.Grid: grid})
r = np.linalg.norm(a @ X.to_numpy() - b) / np.linalg.norm(b)
print(f"distributed posv resid {r:.2e}")
assert r < 1e-4
# tile->rank map parity (reference func.hh)
f = grid.tile_rank_func()
print("tile (0,0) -> rank", f((0, 0)), "; tile (1,2) -> rank", f((1, 2)))
if args.launch:
    import torch.distributed as dist
    mp.emit("ex13", p=grid.p, q=grid.q, resid=float(r))
    dist.barrier()
    dist.destroy_process_group()

#!/usr/bin/env python3
"""Why the port's eigensolvers route an f32 Hermitian eigenproblem of
order <= 512 on the card through f64 (``blocked.library_eigh``):
``torch.linalg.eigh`` on a symmetric Gaussian of each order, on the card
and on the host's CPU, its residual ||A V - V diag(w)||_F / ||A||_F and
max |V^T V - I| (PyTorch hands f32 orders 32-512 on the card to
cuSOLVER's Jacobi solver, syevj); then ``spectral_dc.eigh_dc`` (leaf
256) on (G + G^T)/2 at n = 2048, 4096 and 8192 on the card with its
leaves on the plain f32 call and on ``library_eigh``, and at 2048 on
the CPU, each with its eigenvalue error against ``eigvalsh`` in f64
relative to ||H||_2; last, the building blocks of the polar
iteration on the card and on the CPU at 2048 (the Gram product's
largest error, the backward error of the Cholesky factor of
300 U^T U + I, the sign of H - median(diag H) I against the f64 sign).

    python3 chip_eigh_leaves.py [--seed S]

Prints one JSON object a line; exits with another code than 0 without
a card.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def accuracy(h, w, v):
    h64, v64, w64 = h.double(), v.double(), w.double()
    eye = torch.eye(h.shape[-1], dtype=torch.float64, device=h.device)
    return {"residual": float(torch.linalg.norm(h64 @ v64 - v64 * w64)
                              / torch.linalg.norm(h64)),
            "orth_max": float((v64.T @ v64 - eye).abs().max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_eigh_leaves: no CUDA device", file=sys.stderr)
        return 1
    import slate_tpu_torch  # noqa: F401  (TF32 off)
    from slate_tpu_torch.linalg import blocked
    from slate_tpu_torch.linalg import spectral_dc as sdc
    rng = np.random.default_rng(args.seed)
    for n in (64, 256, 512, 1024, 2048):
        x = rng.standard_normal((n, n)).astype(np.float32)
        h = (x + x.T) / 2
        for dev in ("cuda", "cpu"):
            ht = torch.as_tensor(h, device=dev)
            w, v = torch.linalg.eigh(ht)
            print(json.dumps({"eigh": n, "device": dev, "dtype": "float32",
                              **accuracy(ht, w, v)}), flush=True)
    from slate_tpu_torch.linalg import polar
    plain = torch.linalg.eigh
    for n, devs in ((2048, ("cuda", "cpu")), (4096, ("cuda",)),
                    (8192, ("cuda",))):
        x = rng.standard_normal((n, n)).astype(np.float32)
        h = (x + x.T) / 2
        for dev in devs:
            ht = torch.as_tensor(h, device=dev)
            w_ref = torch.linalg.eigvalsh(ht.double())
            for leaves in ("torch.linalg.eigh", "library_eigh"):
                if leaves == "torch.linalg.eigh":
                    sdc.library_eigh = lambda a: plain(a)
                else:
                    sdc.library_eigh = blocked.library_eigh
                t0 = time.perf_counter()
                w, v, ok = sdc.eigh_dc(ht, leaf=256)
                if dev == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                sdc.library_eigh = blocked.library_eigh
                err = float((w.double() - w_ref).abs().max()
                            / w_ref.abs().max())
                print(json.dumps({"eigh_dc": n, "device": dev,
                                  "leaves": leaves, "ok": ok,
                                  "wall_s": wall, "eig_err_rel": err,
                                  **accuracy(ht, w, v)}), flush=True)
    x = rng.standard_normal((2048, 2048)).astype(np.float32)
    h = (x + x.T) / 2
    for dev in ("cuda", "cpu"):
        ht = torch.as_tensor(h, device=dev)
        u = ht / torch.linalg.matrix_norm(ht.double(), 2).float()
        u64 = u.double()
        gram = float(((u.mT @ u).double() - u64.mT @ u64).abs().max())
        xx = 300.0 * (u.mT @ u) + torch.eye(2048, device=dev)
        r, _ = torch.linalg.cholesky_ex(xx)
        chol = float(torch.linalg.norm(r.double() @ r.double().mT
                                       - xx.double())
                     / torch.linalg.norm(xx.double()))
        hs = ht - torch.median(torch.diagonal(ht)) \
            * torch.eye(2048, device=dev)
        s, k, _ = polar.sign_hermitian(hs)
        w, v = torch.linalg.eigh(hs.double())
        sign = float((s.double() - (v * torch.sign(w)) @ v.mT).abs().max())
        print(json.dumps({"polar_blocks": 2048, "device": dev,
                          "gram_err_max": gram, "chol_backward": chol,
                          "sign_err_max": sign, "iterations": k}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

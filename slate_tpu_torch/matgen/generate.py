"""Test-matrix generation (counterpart of ``slate_tpu/matgen/
generate.py``; reference matgen/: slate::generate_matrix, the kinds and
singular-value distributions of generate_matrix_utils.hh:29-72).

Every kind and distribution of the reference, made on `device` (the
CUDA card unless the caller names another). The random ones draw from
``torch.Generator`` streams seeded from `seed` where the reference
takes jax keys: the same seed gives the same matrix, whatever the
tiling, but not the reference's values (another generator). The
deterministic kinds compute what the reference computes, in the same
types (index grids in f32, as the reference's).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.tiles import TiledMatrix
from ..utils.backend import DeviceLike, resolve_device

#: Reference TestMatrixType (generate_matrix_utils.hh:29-56)
KINDS = (
    "zeros ones identity ij jordan jordanT randn rand rands randb randr "
    "diag svd poev heev geev geevx chebspec circul fiedler gfpp kms "
    "orthog riemann ris zielkeNS minij hilb lehmer parter").split()

#: Reference TestMatrixDist (generate_matrix_utils.hh:58-72)
DISTS = "arith geo cluster0 cluster1 rarith rgeo rcluster0 rcluster1 " \
    "logrand randn rands rand specified".split()

#: generator streams of one seed: the main draw, the imaginary parts,
#: and the two factors of the spectral kinds (the reference's key,
#: fold_in(key, 7), split(key))
_MAIN, _IMAG, _U, _V = 0, 7, 1, 2


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _real(dtype: torch.dtype) -> torch.dtype:
    return torch.empty(0, dtype=dtype).real.dtype


def _gen(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """The generator of one stream of `seed` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def _uniform(g, shape, device, lo=0.0, hi=1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _sigma(dist: str, k: int, cond: float, dtype, seed: int,
           device) -> torch.Tensor:
    """Singular-value distribution vector (descending, max 1, for the
    deterministic dists), in dtype's real type."""
    i = torch.arange(k, device=device,
                     dtype=torch.float64 if dtype == torch.float64
                     else torch.float32)
    kk = max(k - 1, 1)
    inv_cond = 1.0 / cond
    one = torch.ones_like(i)
    low = torch.full_like(i, inv_cond)
    if dist in ("arith", "rarith"):
        s = 1.0 - i / kk * (1.0 - inv_cond)
    elif dist in ("geo", "rgeo"):
        s = torch.pow(inv_cond, i / kk)
    elif dist in ("cluster0", "rcluster0"):
        s = torch.where(i == 0, one, low)
    elif dist in ("cluster1", "rcluster1"):
        s = torch.where(i < k - 1, one, low)
    elif dist == "logrand":
        s = torch.exp(math.log(inv_cond)
                      * _uniform(_gen(seed, _MAIN, device), (k,), device))
    elif dist == "randn":
        s = torch.randn((k,), generator=_gen(seed, _MAIN, device),
                        device=device)
    elif dist in ("rand", "rands"):
        s = _uniform(_gen(seed, _MAIN, device), (k,), device,
                     0.0 if dist == "rand" else -1.0, 1.0)
    else:
        raise ValueError(f"unknown dist {dist!r}")
    if dist.startswith("r") and dist not in ("randn", "rand", "rands"):
        s = s.flip(0)
    return s.to(_real(dtype))


def _rand_orthogonal(g: torch.Generator, n: int, dtype,
                     device) -> torch.Tensor:
    """A Haar-distributed orthogonal / unitary (n, n) matrix: the Q of
    a Gaussian matrix, its columns' phases normalised by R's
    diagonal."""
    a = torch.randn((n, n), generator=g, device=device)
    if dtype.is_complex:
        a = a + 1j * torch.randn((n, n), generator=g, device=device)
    q, r = torch.linalg.qr(a.to(dtype))
    d = torch.diagonal(r)
    return q * (d / torch.where(d == 0, torch.ones_like(d), d).abs()
                )[None, :]


def generate_matrix(kind: str, m: int, n: Optional[int] = None,
                    mb: int = 256, nb: Optional[int] = None,
                    dtype=torch.float32, seed: int = 42,
                    cond: float = 1e2, dist: str = "logrand",
                    sigma: Optional[Sequence[float]] = None,
                    device: DeviceLike = None) -> TiledMatrix:
    """Reference slate::generate_matrix (matgen/generate_matrix.cc).

    kind may carry a dist suffix like "svd:geo" (the reference's
    --matrix syntax kind_dist). dtype is a torch or a numpy dtype."""
    if ":" in kind:
        kind, dist = kind.split(":", 1)
    n = m if n is None else n
    dt = _torch_dtype(dtype)
    dev = resolve_device(device)
    f32 = torch.float32
    ii = torch.arange(m, dtype=f32, device=dev)[:, None]
    jj = torch.arange(n, dtype=f32, device=dev)[None, :]
    k = min(m, n)
    cplx = dt.is_complex

    def where(cond_, x, y):
        return torch.where(cond_, torch.tensor(x, device=dev),
                           torch.tensor(y, device=dev))

    def rand(shape, lo=0.0, hi=1.0):
        re = _uniform(_gen(seed, _MAIN, dev), shape, dev, lo, hi)
        if cplx:
            im = _uniform(_gen(seed, _IMAG, dev), shape, dev, lo, hi)
            return (re + 1j * im).to(dt)
        return re.to(dt)

    if kind == "zeros":
        a = torch.zeros((m, n), dtype=dt, device=dev)
    elif kind == "ones":
        a = torch.ones((m, n), dtype=dt, device=dev)
    elif kind == "identity":
        a = _eye(m, n, 0, dev).to(dt)
    elif kind == "ij":
        a = (ii + 0.1 * jj).to(dt)
    elif kind in ("jordan", "jordanT"):
        a = (0.5 * _eye(m, n, 0, dev)
             + _eye(m, n, 1 if kind == "jordan" else -1, dev)).to(dt)
    elif kind == "randn":
        re = torch.randn((m, n), generator=_gen(seed, _MAIN, dev),
                         device=dev)
        if cplx:
            im = torch.randn((m, n), generator=_gen(seed, _IMAG, dev),
                             device=dev)
            a = (re + 1j * im).to(dt)
        else:
            a = re.to(dt)
    elif kind == "rand":
        a = rand((m, n))
    elif kind == "rands":
        a = rand((m, n), -1.0, 1.0)
    elif kind == "randb":
        a = torch.round(rand((m, n)).real).to(dt)
    elif kind == "randr":
        a = (2 * torch.round(rand((m, n)).real) - 1).to(dt)
    elif kind == "diag":
        s = _spectrum(sigma, dist, k, cond, dt, seed, dev)
        a = torch.zeros((m, n), dtype=dt, device=dev)
        a.diagonal()[:k] = s
    elif kind in ("svd", "poev", "heev", "geev", "geevx"):
        s = _spectrum(sigma, dist, k, cond, dt, seed, dev)
        gu, gv = _gen(seed, _U, dev), _gen(seed, _V, dev)
        if kind == "svd":
            u = _rand_orthogonal(gu, m, dt, dev)[:, :k]
            v = _rand_orthogonal(gv, n, dt, dev)[:, :k]
            a = (u * s[None, :]) @ v.mH
        elif kind == "poev":       # SPD: Q |S| Q^H
            q = _rand_orthogonal(gu, m, dt, dev)
            a = (q * s.abs()[None, :]) @ q.mH
        elif kind == "heev":       # Hermitian indefinite: random signs
            q = _rand_orthogonal(gu, m, dt, dev)
            signs = torch.where(_uniform(gv, (k,), dev) < 0.5, -1.0, 1.0)
            a = (q * (s * signs.to(dt))[None, :]) @ q.mH
        else:                       # geev / geevx: X S X^-1
            x = _rand_orthogonal(gu, m, dt, dev)
            a = (x * s[None, :]) @ torch.linalg.inv(x)
    elif kind == "chebspec":
        # Chebyshev spectral differentiation matrix (gallery chebspec)
        nn = m
        r = torch.arange(nn, dtype=torch.float64, device=dev)
        x = torch.cos(math.pi * r / (nn - 1))
        c = torch.where((r == 0) | (r == nn - 1), 2.0, 1.0) \
            * torch.pow(-1.0, r)
        X = x[:, None] - x[None, :]
        C = torch.outer(c, 1 / c)
        D = C / (X + torch.eye(nn, dtype=torch.float64, device=dev))
        D = D - torch.diag(D.sum(dim=1))
        a = D.to(dt)[:m, :n]
    elif kind == "circul":
        a = (torch.remainder(jj - ii, n) + 1).to(dt)
    elif kind == "fiedler":
        a = (ii - jj).abs().to(dt)
    elif kind == "gfpp":
        # growth-factor worst case for partial pivoting
        low = where(ii > jj, -1.0, 0.0)
        a = (low + _eye(m, n, 0, dev) + where(jj == n - 1, 1.0, 0.0)
             ).to(dt)
    elif kind == "kms":
        a = torch.pow(0.5, (ii - jj).abs()).to(dt)
    elif kind == "orthog":
        a = (math.sqrt(2.0 / (n + 1))
             * torch.sin((ii + 1) * (jj + 1) * math.pi / (n + 1))).to(dt)
    elif kind == "riemann":
        a = torch.where(torch.remainder(jj + 2, ii + 2) == 0, ii + 1.0,
                        torch.tensor(-1.0, device=dev)).to(dt)
    elif kind == "ris":
        a = (0.5 / (n - ii - jj - 0.5)).to(dt)
    elif kind == "zielkeNS":
        base = where(ii + jj >= n - 1, 1.0, 0.0)
        a = (base + where((ii == n - 1) & (jj == 0), 1.0, 0.0)).to(dt)
    elif kind == "minij":
        a = (torch.minimum(ii, jj) + 1).to(dt)
    elif kind == "hilb":
        a = (1.0 / (ii + jj + 1)).to(dt)
    elif kind == "lehmer":
        a = (torch.minimum(ii, jj) + 1).to(dt) \
            / (torch.maximum(ii, jj) + 1).to(dt)
    elif kind == "parter":
        a = (1.0 / (ii - jj + 0.5)).to(dt)
    else:
        raise ValueError(f"unknown matrix kind {kind!r}; known: {KINDS}")
    return TiledMatrix.from_dense(a, mb, nb, device=dev)


def _eye(m: int, n: int, offset: int, device) -> torch.Tensor:
    """(m, n) f64 with ones on diagonal `offset` (numpy's eye(m, n, k))."""
    return torch.from_numpy(np.eye(m, n, k=offset)).to(device)


def _spectrum(sigma, dist, k, cond, dt, seed, dev) -> torch.Tensor:
    """The given singular values, or those of `dist`, in dtype dt."""
    if sigma is not None:
        return torch.as_tensor(np.asarray(sigma), device=dev).to(dt)
    return _sigma(dist, k, cond, dt, seed, dev).to(dt)

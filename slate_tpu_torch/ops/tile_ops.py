"""Tile operations (counterpart of ``slate_tpu/ops/tile_ops.py``; the
reference's src/cuda device kernels geadd, gecopy, genorm, gescale,
gescale_row_col, geset, transpose, tzadd, tzcopy, tzscale, tzset and
the structured norms).

Each is one masked dense op over the padded storage, as in the
reference; the batched-over-tiles structure of the CUDA kernels
collapses into one 2D op. All return a new TiledMatrix. Scalars are
rounded to the matrix's type before they are used, as the reference's
``jnp.asarray(value, dtype)`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.enums import Norm, NormScope, Uplo
from ..core.tiles import TiledMatrix
from .masks import bounds_mask, tri_mask


def _replace_data(A: TiledMatrix, data: torch.Tensor) -> TiledMatrix:
    return dataclasses.replace(A, data=data)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-d tensor of `like`'s type and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _pad_logical(r: TiledMatrix, dtype, shape) -> torch.Tensor:
    """r's logical [:m, :n] block in `dtype`, zero-padded to `shape`."""
    mp, np_ = shape
    return torch.nn.functional.pad(r.data[:r.m, :r.n].to(dtype),
                                   (0, np_ - r.n, 0, mp - r.m))


def _kept(r: TiledMatrix) -> torch.Tensor:
    return tri_mask(r.data.shape, r.uplo is Uplo.Lower,
                    device=r.data.device)


# -- elementwise set / copy / scale / add (ge* general, tz* trapezoid) -----

def geset(A: TiledMatrix, offdiag_value, diag_value) -> TiledMatrix:
    """Reference device_geset.cu / slate::set (slate.hh:121)."""
    r = A.resolve()
    shape, dev = r.data.shape, r.data.device
    ii = torch.arange(shape[0], device=dev)[:, None]
    jj = torch.arange(shape[1], device=dev)[None, :]
    vals = torch.where(ii == jj, _scalar(diag_value, r.data),
                       _scalar(offdiag_value, r.data))
    data = torch.where(bounds_mask(shape, r.m, r.n, device=dev), vals,
                       _scalar(0, r.data))
    return _replace_data(r, data)


def tzset(A: TiledMatrix, offdiag_value, diag_value) -> TiledMatrix:
    """Set only the stored triangle (reference device_tzset.cu)."""
    r = A.resolve()
    full = geset(r, offdiag_value, diag_value)
    keep = _kept(r) & bounds_mask(r.data.shape, r.m, r.n,
                                  device=r.data.device)
    return _replace_data(r, torch.where(keep, full.data, r.data))


def geadd(alpha, A: TiledMatrix, beta, B: TiledMatrix) -> TiledMatrix:
    """B := alpha A + beta B (reference device_geadd.cu, slate::add). A
    and B must conform logically; tile sizes may differ."""
    ra, rb = A.resolve(), B.resolve()
    a = _pad_logical(ra, rb.dtype, rb.data.shape)
    data = _scalar(alpha, rb.data) * a + _scalar(beta, rb.data) * rb.data
    return _replace_data(rb, data)


def tzadd(alpha, A: TiledMatrix, beta, B: TiledMatrix) -> TiledMatrix:
    """Trapezoid add on the stored triangle (device_tzadd.cu)."""
    rb = B.resolve()
    full = geadd(alpha, A, beta, rb)
    return _replace_data(rb, torch.where(_kept(rb), full.data, rb.data))


def gecopy(A: TiledMatrix, B: TiledMatrix) -> TiledMatrix:
    """Copy A into B's storage, converting the type (device_gecopy.cu,
    slate::copy slate.hh:62)."""
    ra, rb = A.resolve(), B.resolve()
    return _replace_data(rb, _pad_logical(ra, rb.dtype, rb.data.shape))


def tzcopy(A: TiledMatrix, B: TiledMatrix) -> TiledMatrix:
    rb = B.resolve()
    full = gecopy(A, rb)
    return _replace_data(rb, torch.where(_kept(rb), full.data, rb.data))


def _ratio(numer, denom, like: torch.Tensor) -> torch.Tensor:
    return _scalar(numer, like) / _scalar(denom, like)


def gescale(numer, denom, A: TiledMatrix) -> TiledMatrix:
    """A *= numer / denom (device_gescale.cu, slate::scale slate.hh:71)."""
    r = A.resolve()
    return _replace_data(r, r.data * _ratio(numer, denom, r.data))


def tzscale(numer, denom, A: TiledMatrix) -> TiledMatrix:
    r = A.resolve()
    s = _ratio(numer, denom, r.data)
    return _replace_data(r, torch.where(_kept(r), r.data * s, r.data))


def gescale_row_col(R, C, A: TiledMatrix) -> TiledMatrix:
    """A := diag(R) A diag(C) (device_gescale_row_col.cu,
    slate::scale_row_col slate.hh:111). R: (m,), C: (n,)."""
    r = A.resolve()
    mp, np_ = r.data.shape
    R = torch.nn.functional.pad(torch.as_tensor(R, dtype=r.dtype,
                                                device=r.device),
                                (0, mp - r.m))
    C = torch.nn.functional.pad(torch.as_tensor(C, dtype=r.dtype,
                                                device=r.device),
                                (0, np_ - r.n))
    return _replace_data(r, r.data * R[:, None] * C[None, :])


def transpose_tiles(A: TiledMatrix) -> TiledMatrix:
    """Physical transpose (reference device_transpose.cu)."""
    return A.transpose().resolve()


# -- norms -----------------------------------------------------------------

def _abs2(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x * x


def _max0(x: torch.Tensor, dim=None) -> torch.Tensor:
    """max of the non-negative `x` with 0 for an empty reduction (the
    reference's ``max(initial=0.0)``)."""
    if x.numel() == 0:
        shape = () if dim is None else \
            tuple(s for i, s in enumerate(x.shape) if i != dim)
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return x.amax() if dim is None else x.amax(dim=dim)


def _norm_of_dense(a: torch.Tensor, norm: Norm) -> torch.Tensor:
    ax = a.abs()
    if norm is Norm.Max:
        return _max0(ax)
    if norm is Norm.One:
        return _max0(ax.sum(dim=0))
    if norm is Norm.Inf:
        return _max0(ax.sum(dim=1))
    if norm is Norm.Fro:
        return torch.sqrt(_abs2(a).sum())
    raise ValueError(norm)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def matrix_norm(A: TiledMatrix, norm: Norm,
                scope: NormScope = NormScope.Matrix) -> torch.Tensor:
    """Reference genorm / henorm / synorm / trnorm and slate::norm
    (slate.hh:462-471), on A's device. Structure is honoured through the
    logical matrix (to_dense mirrors and masks it)."""
    a = A.to_dense()
    real = _real_dtype(a.dtype)
    if scope in (NormScope.Columns, NormScope.Rows):
        dim = 0 if scope is NormScope.Columns else 1
        if norm is Norm.Max:
            v = _max0(a.abs(), dim)
        elif norm is Norm.Fro:
            v = torch.sqrt(_abs2(a).sum(dim=dim))
        else:   # One / Inf per-vector norms are both abs-sums
            v = a.abs().sum(dim=dim)
        return v.to(real)
    return _norm_of_dense(a, norm).to(real)


def col_norms(A: TiledMatrix) -> torch.Tensor:
    """Reference slate::colNorms (slate.hh:484): max-abs per column."""
    a = A.to_dense()
    return _max0(a.abs(), 0).to(_real_dtype(a.dtype))

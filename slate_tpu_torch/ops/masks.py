"""Mask helpers (counterpart of ``slate_tpu/ops/masks.py``) for
ragged-edge and structured operations: index-comparison masks over the
padded dense tensor, which stand in for the per-thread bounds checks of
the reference's device kernels (src/cuda/device_util.cuh).

Each takes the device its mask goes to: the card unless the caller
names another (the tile ops pass their tensor's).
"""

from __future__ import annotations

import torch

from ..utils.backend import DeviceLike, resolve_device


def _grid(shape, device: DeviceLike):
    dev = resolve_device(device)
    ii = torch.arange(shape[0], device=dev)[:, None]
    jj = torch.arange(shape[1], device=dev)[None, :]
    return ii, jj


def bounds_mask(shape, m: int, n: int,
                device: DeviceLike = None) -> torch.Tensor:
    """True inside the logical [:m, :n] region of a padded array."""
    ii, jj = _grid(shape, device)
    return (ii < m) & (jj < n)


def tri_mask(shape, lower: bool, strict: bool = False,
             device: DeviceLike = None) -> torch.Tensor:
    """True on the kept triangle (including the diagonal unless
    strict)."""
    ii, jj = _grid(shape, device)
    if lower:
        return ii > jj if strict else ii >= jj
    return ii < jj if strict else ii <= jj


def band_mask(shape, kl: int, ku: int,
              device: DeviceLike = None) -> torch.Tensor:
    """True inside the band: kl sub- and ku super-diagonals."""
    ii, jj = _grid(shape, device)
    return (jj - ii <= ku) & (ii - jj <= kl)

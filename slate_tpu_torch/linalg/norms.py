"""Norm drivers (counterpart of ``slate_tpu/linalg/norms.py``;
reference slate.hh:462-484). Structure dispatch happens inside
ops/tile_ops.matrix_norm through the logical matrix."""

from __future__ import annotations

from ..core.enums import Norm, NormScope
from ..core.options import OptionsLike
from ..core.tiles import TiledMatrix
from ..ops.tile_ops import col_norms, matrix_norm


def norm(norm_type: Norm, A: TiledMatrix, opts: OptionsLike = None,
         scope: NormScope = NormScope.Matrix):
    """Reference slate::norm (slate.hh:462-471): a 0-d tensor (or one
    per column / row) of A's real type, on A's device."""
    return matrix_norm(A, norm_type, scope)


def colNorms(norm_type: Norm, A: TiledMatrix, opts: OptionsLike = None):
    """Reference slate::colNorms (slate.hh:484): the Max norm of each
    column."""
    assert norm_type is Norm.Max
    return col_norms(A)

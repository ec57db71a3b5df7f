"""Matrix printing (counterpart of ``slate_tpu/utils/printing.py``;
reference src/print.cc; Option::Print* keys, enums.hh:79-89).

Implements the reference's five verbosity levels:
  0: nothing
  1: metadata only (dimensions, tiling, type, uplo/op)
  2: first & last `edgeitems` rows & cols of the matrix (4-corner
     with ellipses) — the default
  3: the 4 corner elements of EVERY tile (tile-structure debugging)
  4: the full matrix
Driven either by keyword arguments or an options mapping with
Option.PrintVerbose / PrintEdgeItems / PrintWidth / PrintPrecision
(types.hh advice: width = precision + 6). The values are read back
to the host as numpy (bf16 through f32, which holds every bf16 value
exactly), so the strings are the reference's for the same matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import torch

from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix


def _host(x: torch.Tensor) -> np.ndarray:
    """x on the host as numpy (bf16 as f32: numpy has no bf16)."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "complex128", ...)."""
    return str(dtype).replace("torch.", "")


def _fmt_factory(complex_: bool, width: int, precision: int):
    def fmt(v):
        if complex_:
            return (f"{v.real:{width}.{precision}f}"
                    f"{v.imag:+{width}.{precision}f}i")
        return f"{v:{width}.{precision}f}"
    return fmt


def _meta(label: str, A: TiledMatrix) -> str:
    m, n = A.shape
    return (f"{label} = [  % {m}x{n}, tiles {A.mb}x{A.nb} "
            f"(mt={A.mt}, nt={A.nt}), {A.mtype.name}, "
            f"uplo={A.uplo.name}, op={A.op.name}, "
            f"dtype={_dtype_name(A.dtype)}")


def _rows_full(a, fmt):
    return ["  " + " ".join(fmt(v) for v in row) for row in a]


def _rows_corners(a, fmt, edgeitems):
    m, n = a.shape
    lines = []
    ri = list(range(min(edgeitems, m))) + \
        list(range(max(m - edgeitems, edgeitems), m))
    ci = list(range(min(edgeitems, n))) + \
        list(range(max(n - edgeitems, edgeitems), n))
    ci_lo = [j for j in ci if j < edgeitems]
    ci_hi = [j for j in ci if j >= edgeitems]
    for k, i in enumerate(ri):
        row = " ".join(fmt(a[i, j]) for j in ci_lo)
        if ci_hi:
            row += "  ...  " + " ".join(fmt(a[i, j]) for j in ci_hi)
        lines.append("  " + row)
        if k == len([i for i in ri if i < edgeitems]) - 1 \
                and m > 2 * edgeitems:
            lines.append("  ...")
    return lines


def _rows_tile_corners(A: TiledMatrix, fmt):
    """Verbose 3 (reference print.cc tile-corner mode): the 4 corner
    elements of every tile, one block row of tiles per paragraph."""
    lines = []
    for i in range(A.mt):
        top, bot = [], []
        for j in range(A.nt):
            # crop the stored tile to its logical extent — the padded
            # remainder is not matrix data
            t = _host(A.tile(i, j))[:A.tileMb(i), :A.tileNb(j)]
            tm, tn = t.shape
            if tm <= 0 or tn <= 0:
                continue
            top.append(f"[{fmt(t[0, 0])} .. {fmt(t[0, tn - 1])}]")
            bot.append(f"[{fmt(t[tm - 1, 0])} .. {fmt(t[tm - 1, tn - 1])}]")
        lines.append("  tile row %d:" % i)
        lines.append("    " + " ".join(top))
        lines.append("    " + " ".join(bot))
    return lines


def sprint_matrix(label: str, A: TiledMatrix, edgeitems: int = 4,
                  width: int = 10, precision: int = 4,
                  verbose: Optional[int] = None,
                  opts: OptionsLike = None) -> str:
    """Render like the reference's slate::print (print.cc): verbosity
    levels 0-4 per enums.hh:79-84; defaults to level 2 (edgeitems
    corners), or level 4 (full) when the matrix already fits within
    the edgeitems window."""
    if opts:
        verbose = get_option(opts, Option.PrintVerbose,
                             verbose if verbose is not None else 2)
        edgeitems = get_option(opts, Option.PrintEdgeItems, edgeitems)
        width = get_option(opts, Option.PrintWidth, width)
        precision = get_option(opts, Option.PrintPrecision, precision)
    if verbose is None:
        verbose = 2
    if verbose <= 0:
        return ""
    lines = [_meta(label, A)]
    if verbose >= 2:
        fmt = _fmt_factory(A.is_complex, width, precision)
        if verbose == 3:
            # tile mode reads per-tile — never gathers the full dense
            lines += _rows_tile_corners(A, fmt)
        else:
            a = _host(A.to_dense())
            m, n = a.shape
            small = m <= 2 * edgeitems and n <= 2 * edgeitems
            if verbose >= 4 or small:
                lines += _rows_full(a, fmt)
            else:
                lines += _rows_corners(a, fmt, edgeitems)
    lines.append("]")
    return "\n".join(lines)


def print_matrix(label: str, A: TiledMatrix, **kw) -> None:
    """Reference slate::print entry (print.cc); see sprint_matrix."""
    out = sprint_matrix(label, A, **kw)
    if out:
        print(out)

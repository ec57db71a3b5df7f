"""Grid TSQR (counterpart of ``slate_tpu/dist/tsqr.py``):
communication-avoiding tall-skinny QR whose reduction tree is scheduled
across ranks, the reference's cross-rank ttqrt tree (geqrf.cc:161,220,
internal_ttqrt.cc), where the one-device ``linalg/ca.py`` tree is a
batch.

  * up-sweep: each rank thin-QRs its row chunk (the reference's per-rank
    panel QR), then the (w, w) R factors combine up the dist/tree.py
    butterfly: per round only R-sized blocks travel;
  * ``tsqr_qt`` carries B through the SAME exchanges (R and the running
    Q^H B ride one payload), so the implicit tree apply costs no extra
    rounds (the ttmqt role), never forming the (m, w) factor;
  * ``tsqr`` rebuilds the explicit thin Q with a down-sweep that is
    purely local: the butterfly leaves every rank its own (g w, w)
    block Q factor per level, so Q_local = Q0_local @ prod(level
    blocks) needs no communication.

Rows pad with zeros to a multiple of the rank count (exact for QR).
Each rank's chunk must be at least w rows tall for the thin leaf QR:
``eligible`` gates the callers (qr.gels_tsqr, the grid geqrf's
tall-skinny route). The QRs are the library's (``torch.linalg.qr``).
``tsqr``'s Q comes back as this rank's row block of the padded rows
(``tree.row_block``); R and Q^H B are the same on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.tiles import round_up
from ..parallel.mesh import WHOLE, ProcessGrid
from . import tree


def _fanin(grid: ProcessGrid, opts, n: Optional[int], dtype) -> int:
    """Tree fan-in (tunable 'tsqr'/'tree_fanin', frozen default 2, the
    reference's binary ttqrt): grid rank 0's, which shapes the tree on
    every rank."""
    from ..parallel.collectives import agree
    from ..tune.select import resolve
    return agree(grid, int(resolve("tsqr", "tree_fanin", opts=opts, n=n,
                                   dtype=dtype)))[0]


def eligible(grid: ProcessGrid, shape: Tuple[int, int],
             axis=WHOLE) -> bool:
    """True when the grid tree applies: every rank's row chunk is at
    least as tall as the panel is wide."""
    m, w = shape
    size = tree.axis_size(grid, axis)
    return w >= 1 and round_up(max(m, 1), size) // size >= w


def _qr(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.linalg.qr(x, mode="reduced")


def _up_sweep(grid: ProcessGrid, r: torch.Tensor,
              y: Optional[torch.Tensor], axis, size: int, fanin: int):
    """Combine R factors up the butterfly, carrying the Q^H B panel `y`
    through the same exchanges when given. Returns (R_root, y_root,
    level_qs): this rank's per-round (g w, w) Q blocks with its group
    position (for the local down-sweep)."""
    w = r.shape[1]
    idx = grid.axis_index(axis)
    level_qs = []
    for span, g in tree.round_schedule(size, fanin):
        payload = r if y is None else torch.cat([r, y], dim=1)
        vals = tree.group_values(grid, payload, axis, size, span, g)
        qk, r = _qr(torch.cat([v[:, :w] for v in vals], dim=0))
        if y is not None:
            y = qk.mH @ torch.cat([v[:, w:] for v in vals], dim=0)
        level_qs.append((qk, (idx // span) % g))
    return r, y, level_qs


def tsqr_qt(grid: ProcessGrid, a: torch.Tensor, b: torch.Tensor,
            opts=None, axis=WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """R (w, w) and Q^H B (w, nrhs) of tall-skinny a = Q R over the grid
    tree, the same on every rank: the gels_tsqr kernel (implicit Q,
    tree-scheduled communication). `a` and `b` are the global
    operands."""
    m, w = a.shape
    size = tree.axis_size(grid, axis)
    fanin = _fanin(grid, opts, w, a.dtype)
    tree.record_schedule("tsqr_qt", size, fanin)
    mp = round_up(max(m, 1), size)
    rows = tree.row_block(grid, mp, axis)
    al = tree.pad_rows(a, mp)[rows]
    bl = tree.pad_rows(b.to(a.dtype), mp)[rows]
    q0, r = _qr(al)
    r, y, _ = _up_sweep(grid, r, q0.mH @ bl, axis, size, fanin)
    return r, y


def tsqr(grid: ProcessGrid, a: torch.Tensor, opts=None, axis=WHOLE
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit grid TSQR of the global (m, w) `a`: (this rank's row
    block of the orthonormal Q over the padded rows, R (w, w) the same
    on every rank). The down-sweep that rebuilds Q is communication-free
    (module doc)."""
    m, w = a.shape
    size = tree.axis_size(grid, axis)
    fanin = _fanin(grid, opts, w, a.dtype)
    tree.record_schedule("tsqr", size, fanin)
    mp = round_up(max(m, 1), size)
    q0, r = _qr(tree.pad_rows(a, mp)[tree.row_block(grid, mp, axis)])
    r, _, level_qs = _up_sweep(grid, r, None, axis, size, fanin)
    qcur = torch.eye(w, dtype=a.dtype, device=a.device)
    for qk, pos in reversed(level_qs):
        qcur = qk[pos * w:(pos + 1) * w] @ qcur
    return q0 @ qcur, r

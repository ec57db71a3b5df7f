"""Communication-avoiding tree QR (counterpart of the TSQR part of
``slate_tpu/linalg/ca.py``): ``tsqr_factors``, ``tsqr_qt_apply`` and
``tsqr``, on batched ``torch.linalg.qr`` (the reference's batched XLA
QR). Tall-skinny QR by chunked local QRs followed by a binary tree of
pairwise [R1; R2] QR combines; Q stays implicit unless ``tsqr`` is
asked for it. The CALU tournament (``tournament_pivot_rows``) waits for
its slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.tiles import ceil_div, next_pow2


def tsqr_factors(a: torch.Tensor, chunk: int = 512
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Implicit TSQR tree of A (m, w): per-level batched Q factors
    (level 0: (c2, chunk, w); level k > 0: (c_k, 2w, w)) plus the root
    R. The (m, w) orthogonal factor is never formed."""
    m, w = a.shape
    chunk = max(chunk, w)
    c2 = next_pow2(max(ceil_div(m, chunk), 1))
    ap = torch.zeros((c2 * chunk, w), dtype=a.dtype, device=a.device)
    ap[:m] = a
    q0, r = torch.linalg.qr(ap.reshape(c2, chunk, w), mode="reduced")
    qs = [q0]
    while r.shape[0] > 1:
        qk, r = torch.linalg.qr(r.reshape(r.shape[0] // 2, 2 * w, w),
                                mode="reduced")
        qs.append(qk)
    return qs, r[0]


def tsqr_qt_apply(qs: List[torch.Tensor], b: torch.Tensor, m: int
                  ) -> torch.Tensor:
    """(Q^H B)[:w] through the implicit tree: one batched (chunk, w)^H
    product at level 0, then log2(c) batched (2w, w)^H combines."""
    c2, chunk, w = qs[0].shape
    nrhs = b.shape[1]
    bp = torch.zeros((c2 * chunk, nrhs), dtype=b.dtype, device=b.device)
    bp[:m] = b
    cur = qs[0].mH @ bp.reshape(c2, chunk, nrhs)
    for qk in qs[1:]:
        cur = qk.mH @ cur.reshape(qk.shape[0], 2 * w, nrhs)
    return cur[0]


def tsqr(a: torch.Tensor, chunk: int = 512
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR: A (m, w) -> (Q (m, w), R (w, w)), Q rebuilt down
    the tree with batched products."""
    m, w = a.shape
    qs, rfin = tsqr_factors(a, chunk)
    c2, chunk_, _ = qs[0].shape
    qcur = torch.eye(w, dtype=a.dtype, device=a.device)[None]
    for qk in reversed(qs[1:]):
        qcur = (qk @ qcur).reshape(qk.shape[0] * 2, w, w)
    qfull = qs[0] @ qcur
    return qfull.reshape(c2 * chunk_, w)[:m], rfin

"""Communication-avoiding kernels (counterpart of
``slate_tpu/linalg/ca.py``):

- ``tsqr_factors``, ``tsqr_qt_apply`` and ``tsqr``, on batched
  ``torch.linalg.qr`` (the reference's batched XLA QR): tall-skinny QR
  by chunked local QRs followed by a binary tree of pairwise [R1; R2]
  QR combines; Q stays implicit unless ``tsqr`` is asked for it.
- ``tournament_pivot_rows``: CALU pivot selection (reference
  getrf_tntpiv.cc:169-222). Each chunk plays a local partial-pivot LU
  and nominates its w pivot rows; the winners meet in a binary
  tournament (a batched LU a round). ``calu_factor_sorted`` factors the
  panel once the selected rows are on top, without further pivoting,
  and ``fix_degenerate_selection`` repairs a selection that points at
  dead rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
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


# -- CALU tournament ---------------------------------------------------------

def _local_pivot_rows(blocks: torch.Tensor) -> torch.Tensor:
    """Partial-pivot LU over (c, h, w) chunks at once (the column loop,
    lu.lu_panel_fori, over the stack); returns the ORIGINAL local row
    indices (c, w) each chunk nominates, in selection order: the first
    w entries of each chunk's composed swap permutation."""
    from ..ops import kernels as pk
    from .lu import lu_panel_fori
    h, w = blocks.shape[1:]
    _, piv = lu_panel_fori(blocks)
    return pk.lu_pivots_to_permutation(piv, h)[:, :w]


def _chunk_pivot_rows(blocks: torch.Tensor) -> torch.Tensor:
    """Per-chunk pivot nomination: the ORIGINAL local row indices (c, w)
    each chunk's partial-pivot LU selects, in selection order. The
    batched library LU (``torch.linalg.lu_factor_ex``) where the panel
    route (core/methods.MethodLUPanel, tune key ``method_lu_panel``)
    resolves Native; any other route, including the hand kernels (one
    panel a launch), demotes to the batched column loop, as in the
    reference."""
    from ..core.methods import MethodLUPanel
    from ..ops import kernels as pk
    c, h, w = blocks.shape
    if MethodLUPanel.resolve(h, w, blocks.dtype, blocks.device) \
            is MethodLUPanel.Native:
        _, piv, _ = torch.linalg.lu_factor_ex(blocks)
        return pk.lu_pivots_to_permutation((piv - 1).to(torch.int32),
                                           h)[:, :w]
    return _local_pivot_rows(blocks)


def tournament_pivot_rows(a: torch.Tensor, chunk=None) -> torch.Tensor:
    """Select w pivot rows of an (m, w) panel by binary tournament
    (reference getrf_tntpiv): chunked local LUs nominate candidates,
    winners meet pairwise until one set remains. Returns global row
    indices (w,) int64, ordered as the final LU selected them.

    An explicit `chunk` is honoured (at least w). The default differs
    from the reference's, whose chunk is the tallest panel XLA's LU
    compiles on a TPU (NATIVE_LU_MAX_M, a compile limit): for the
    types the library LU takes, the port's default chunk is the whole
    panel, since cuSOLVER and LAPACK have no height limit. The
    tournament then is one exact partial-pivot LU of the panel (as the
    reference's is up to its limit, 8192 f32 rows), the strongest
    selection, at the cost of one library panel and no combine rounds.
    Other types take chunks of 256 rows (the reference's default)."""
    from ..core.methods import MethodFactor
    m, w = a.shape
    if chunk is None and MethodFactor.native_lu_dtype_ok(a.dtype):
        chunk = m
    chunk = max(chunk if chunk is not None else 256, w)
    c2 = next_pow2(max(ceil_div(m, chunk), 1))
    ap = torch.zeros((c2 * chunk, w), dtype=a.dtype, device=a.device)
    ap[:m] = a
    base = torch.arange(c2, device=a.device)[:, None] * chunk
    cand = _chunk_pivot_rows(ap.reshape(c2, chunk, w)) + base
    while cand.shape[0] > 1:
        pairs = cand.reshape(cand.shape[0] // 2, 2 * w)
        vals = ap[pairs.reshape(-1)].reshape(pairs.shape[0], 2 * w, w)
        cand = torch.take_along_dim(pairs, _chunk_pivot_rows(vals), dim=1)
    return cand[0]


def calu_factor_sorted(x: torch.Tensor, inner_nb: int = 128
                       ) -> torch.Tensor:
    """No-pivot packed LU of an (m, w) panel whose pivot rows are
    ALREADY on top (the state after a tournament swap): the blocked
    no-pivot LU of the (w, w) top block, then the rows below solve
    against U at matmul rate (L_below U = A_below, one right-side
    triangular solve). Rows of exact zero below stay exact zero."""
    from .blocked import solve_triangular
    from .lu import _getrf_dense
    m, w = x.shape
    top, _ = _getrf_dense(x[:w], min(inner_nb, w), pivot=False)
    if m == w:
        return top
    below = solve_triangular(torch.triu(top), x[w:], upper=True,
                             left=False)
    return torch.cat([top, below], dim=0)


def fix_degenerate_selection(sel, live: int, wf: int) -> np.ndarray:
    """Deterministic host-side repair of a tournament selection over a
    live-prefix panel (dead / padding rows masked to exact zero): a
    selected index at a dead or pad row (>= `live`) means the column
    was zero among the remaining live rows, every candidate tied at |0|
    and the argmax fell on an arbitrary row. LAPACK partial pivoting
    keeps the diagonal row there; the equivalent here is the SMALLEST
    not-yet-selected live index. Returns int64 (wf,) indices, all
    < live, all distinct."""
    if isinstance(sel, torch.Tensor):
        sel = sel.cpu().numpy()
    sel = np.asarray(sel)[:wf].astype(np.int64).copy()
    if live >= wf and len(set(sel.tolist())) == wf \
            and bool((sel < live).all()):
        return sel                      # the common, healthy case
    used = set()
    free = iter(i for i in range(live))
    for j in range(wf):
        s = int(sel[j])
        if s >= live or s in used:
            s = next(i for i in free if i not in used)
        used.add(s)
        sel[j] = s
    return sel

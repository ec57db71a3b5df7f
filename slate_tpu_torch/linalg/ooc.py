"""Out-of-core streaming drivers (counterpart of
``slate_tpu/linalg/ooc.py``): matrices larger than device memory live in
HOST memory (numpy arrays) and stream through the card one column panel
at a time; the factor accumulates on the host, and device memory holds
O(n * panel_cols) instead of O(n^2). The reference's analogue is SLATE
streaming remote tiles through per-device workspace
(BaseMatrix.hh:462-479, potrf.cc:179-192).

* potrf_ooc: left-looking Cholesky. For each column panel k,
  S = A[k0:, k0:k1]; every earlier panel j visits it,
  S -= L_j[k0:] L_j[k0:k1]^H; then the panel factors in-core (the
  diagonal Cholesky + one triangular solve).
* getrf_ooc (partial pivoting, the FROZEN ``ooc/lu_pivot``): panel k is
  read through the current row permutation, visited by every earlier
  panel (U12 strip by one unit-lower solve + the trailing rank-w
  update), and factored in-core with pivoting confined to the resident
  panel (lu._getrf_dense: the tune cache's ``pallas_rec`` route sends
  its panels to the recursive hand kernel). Its row swaps are applied
  host-side to the written L panels, which retires their cached copies.
* getrf_tntpiv_ooc: tournament (CALU) pivoting selects each panel's
  pivots before its column is written; factor panels are stored in
  ORIGINAL row order and the permutation is applied at visit time by a
  device gather, so written panels never change: no fixups, no cache
  invalidations, checkpointable.
* geqrf_ooc: each earlier panel's compact-WY block visits panel k (V
  and T rebuilt from the packed factor and taus), then the panel
  factors in-core.
* Solves stream the same way (potrs_ooc, getrs_ooc, unmqr_ooc, the R
  sweep of gels_ooc) against a device-resident right-hand side;
  posv_ooc / gesv_ooc / gels_ooc bundle factor and solve. gemm_ooc
  streams A's row panels against a device-resident B.

Every driver streams through linalg/stream.py's engine (the residency
cache, the asynchronous H2D prefetch and D2H writer); a budget of 0
(the FROZEN default) is the uncached schedule bitwise. The streams keep
the reference's hooks: ``instrument_driver``, the flight recorder's
step frames, the ``step`` fault site a panel, the watchdog's heartbeat
a panel plus the completion beat, and the checkpointer
(``ckpt_path`` / ``ckpt_every``). The options arbitrate as in the
reference: ``precision`` (MethodPrecision: the bf16 residency, solves
finished by refine.host_ir), ``scheduler`` (MethodScheduler: the
walks or the sched/ task graphs, bitwise the same), ``visit_fuse``
(MethodVisitFuse), ``pivot`` (MethodLUPivot). Drivers take and return
numpy arrays and run on the card unless ``device`` names another.

With a ``grid`` (a parallel.ProcessGrid; anything else raises TypeError
before any transfer) the factor drivers arbitrate through MethodOOC
(``method=``, FROZEN "stream") and may take the sharded stream of
dist/shard_ooc.py; the composite drivers route their factor phase.
Left out on purpose (ROADMAP): the traced-k0 roll-and-mask of
the reference's panel factors and the ``dynamic_slice`` offsets of its
visits (the port factors the live rows S[k0:] at their true size and
slices its visits; the dead rows were exact zeros that never win a
pivot and never enter a reflector norm), and the fused sweep's
power-of-two count padding with its compile counter (the port fuses at
the true count; the padding was exact-zero columns and identity scan
steps).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from ..core.tiles import ceil_div
from ..obs import events as obs_events
from ..obs import health as _health
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from ..obs.events import instrument_driver
from ..ops.kernels import _torch_dtype
from ..resil import checkpoint as _rckpt
from ..resil import faults as _rfaults
from ..resil import guard as _rguard
from ..sched import policies as _sched_policies
from ..sched.runtime import execute as _sched_execute
from ..utils.backend import resolve_device
from . import stream
from .blocked import (SOLVE_TEMP_CAP, chol_diag_factor,
                      invert_triangular, solve_triangular)
from .blocked import solve_temps_bytes as _solve_temps_bytes
from .stream import _h2d


def _panel_cols(panel_cols: Optional[int], n: int, dtype=None) -> int:
    """Streaming panel width: explicit argument > measured tune-cache
    entry for op "ooc" > FROZEN (tune/cache.py, 8192)."""
    if panel_cols:
        return int(panel_cols)
    from ..tune.select import resolve
    return int(resolve("ooc", "panel_cols", n=n, dtype=dtype))


def _resolve_precision(precision, n: int, dtype):
    """explicit ``precision`` > measured ``ooc/precision`` > FROZEN
    "f32". Returns the LO torch dtype of the mixed path
    (refine.lo_dtype: bf16 for f32, f32 for f64), or None for the full
    path, also when the dtype has no lower pair."""
    from ..core.methods import MethodPrecision, str2method
    m = precision if precision is not None else MethodPrecision.Auto
    if isinstance(m, str):
        m = str2method("precision", m)
    if m is MethodPrecision.Auto:
        m = MethodPrecision.resolve(n, dtype)
    if m is not MethodPrecision.Mixed:
        return None
    from .refine import lo_dtype
    hi = _torch_dtype(dtype)
    lo = lo_dtype(hi)
    return None if lo == hi else lo


def _resolve_scheduler(scheduler, n: int, dtype) -> bool:
    """explicit ``scheduler`` > measured ``ooc/scheduler`` > FROZEN
    "walk". True for the graph route (sched/)."""
    from ..core.methods import MethodScheduler, str2method
    m = scheduler if scheduler is not None else MethodScheduler.Auto
    if isinstance(m, str):
        m = str2method("scheduler", m)
    if m is MethodScheduler.Auto:
        m = MethodScheduler.resolve(n, dtype)
    return m is MethodScheduler.Graph


def _resolve_visit_fuse(visit_fuse, n: int, dtype) -> bool:
    """explicit ``visit_fuse`` > measured ``ooc/visit_fuse`` > FROZEN
    "per_panel". True for the fused route, which always runs through the
    task-graph runtime (its sweep IS a node grouping)."""
    from ..core.methods import MethodVisitFuse, str2method
    m = visit_fuse if visit_fuse is not None else MethodVisitFuse.Auto
    if isinstance(m, str):
        m = str2method("visit_fuse", m)
    if m is MethodVisitFuse.Auto:
        m = MethodVisitFuse.resolve(n, dtype)
    return m is MethodVisitFuse.Fused


def _fuse_count_visits(count: int) -> None:
    """`count` member visits landed in one update: ``ooc.visits_fused``
    and ``ooc.visit_dispatches_saved`` (count - 1)."""
    if obs_events.enabled():
        obs_metrics.inc("ooc.visits_fused", count)
        obs_metrics.inc("ooc.visit_dispatches_saved", count - 1)


def _herm_operand(a: np.ndarray) -> np.ndarray:
    """The Hermitian operator of posv_ooc's refinement: potrf_ooc reads
    only the LOWER triangle, so a caller may store anything above the
    diagonal, but host_ir's residual must not. Symmetric storage is
    returned as is; triangle-only storage is mirrored once. The check
    runs in row chunks, so the symmetric case allocates no matrix-sized
    temporary."""
    n = a.shape[0]
    t = stream._host_tensor(a)
    step = max(1, (1 << 24) // max(n, 1))
    herm = True
    for i0 in range(0, n, step):
        i1 = min(i0 + step, n)
        other = t[:, i0:i1].T
        if t.is_complex():
            other = other.conj().resolve_conj()
        if not torch.equal(t[i0:i1], other):
            herm = False
            break
    if herm:
        return a
    L = np.tril(a)
    return L + np.conj(np.tril(a, -1).T)


def _precision_meta(lo) -> str:
    """The precision mode recorded in checkpoint meta (part of the
    identity guard: a resume under another mode starts fresh)."""
    if lo is None:
        return "full"
    from ..tune.cache import dtype_name
    return dtype_name(lo)


def _grid_or_none(grid, what: str):
    """`grid` as a ProcessGrid this rank belongs to, or None; anything
    else raises TypeError naming the driver, before any transfer."""
    if grid is None:
        return None
    from ..core.options import Option
    from ..parallel.mesh import option_grid
    return option_grid({Option.Grid: grid}, what)


def _shard_escalate(primary, fallback, op: str, grid):
    """The ``shard_to_stream`` rung, on a grid of one rank only: there
    a transient failure of the sharded stream steps down to the
    single-engine stream (guard.record_escalation). On more ranks the
    failure propagates: one rank rerouting alone would desert the
    collective its peers wait in."""
    if grid.nprocs > 1:
        return primary()
    return _rguard.escalate(primary, fallback, "shard_to_stream", op=op)


def _route_shard(n: int, nt: int, grid, method, dtype,
                 what: str = "ooc") -> bool:
    """Grid arbitration: True when the call takes the sharded stream
    (dist/shard_ooc.py). No grid is the stream path; a grid that is not
    a ProcessGrid raises TypeError before any transfer. Explicit
    ``method`` (MethodOOC or its string) wins; Auto resolves through the
    tune cache (MethodOOC.resolve: FROZEN "stream", so a cold cache keeps
    the single-engine stream bitwise with a grid). The route is grid
    rank 0's (collectives.agree): every rank takes the same one."""
    grid = _grid_or_none(grid, what)
    if grid is None:
        return False
    from ..core.methods import MethodOOC, str2method
    from ..parallel.collectives import agree
    m = method if method is not None else MethodOOC.Auto
    if isinstance(m, str):
        m = str2method("ooc", m)
    if m is MethodOOC.Auto:
        m = MethodOOC.resolve(n, nt, grid.nprocs, dtype)
    return bool(agree(grid, m is MethodOOC.Sharded)[0])


def _host(x: torch.Tensor) -> np.ndarray:
    """A device result as a numpy array."""
    return x.resolve_conj().cpu().numpy()


def _host_take_rows(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """arr[idx] on the host, through torch's threaded gather (a numpy
    fancy index is one thread)."""
    return stream._host_tensor(arr)[
        torch.from_numpy(np.asarray(idx, np.int64))].numpy()


def _to_dev(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """An upload outside the panel accounting (index vectors, the R
    sweep's right-hand side): not through _h2d, as in the reference,
    so ``ooc.h2d_bytes`` stays the panels' and operands' bytes."""
    return torch.tensor(np.asarray(x), device=dev)


#: Above this estimate of a direct triangular solve's temporaries
#: (bytes), the streamed solves invert the diagonal block and multiply
#: instead (the reference's valve, one value with blocked.py's; a
#: module name of its own so tests can move the OOC gates alone)
OOC_SOLVE_TEMP_CAP = SOLVE_TEMP_CAP

#: cap on the tournament stream's device-resident permutation vectors
#: (one a factor panel): past it a visit uploads its vector again
_GDEV_MAX = 256


def _over_cap(other: int, tri: int, itemsize: int) -> bool:
    return _solve_temps_bytes(other, tri, itemsize) > OOC_SOLVE_TEMP_CAP


def _up(x: torch.Tensor, hi: torch.dtype) -> torch.Tensor:
    """A lo operand upcast for an f32 (f64) product: bf16 x bf16
    products are exact in f32, and the sums accumulate in f32, as the
    reference's lo x lo -> full contraction. A full-precision operand
    is returned as it is."""
    return x.to(hi)


def _lo(x: torch.Tensor, lo: Optional[torch.dtype], hi: torch.dtype
        ) -> torch.Tensor:
    """A full-precision operand rounded to lo for a mixed product; `lo`
    None (the full path) returns it as it is."""
    return x if lo is None else x.to(lo).to(hi)


# -- visit and factor kernels ----------------------------------------------
# Each visit has one body for both precisions: `lo` None is the full
# path; under ooc/precision the visitor panels arrive in the lo dtype,
# are upcast for the products, and the full-precision operand of each
# tall product is rounded to lo (the reference's _mx twins).

def _panel_apply(S: torch.Tensor, Lj: torch.Tensor, w: int
                 ) -> torch.Tensor:
    """S -= L_j L_j_top^H, one left-looking Cholesky visit: Lj holds
    rows k0: of an earlier factor panel (or several, side by side),
    whose top w rows align with S's columns; a lo Lj is upcast."""
    L = _up(Lj, S.dtype)
    return S - L @ L[:w].mH


def _panel_factor(S: torch.Tensor, w: int) -> torch.Tensor:
    """Factor one (m, w) column panel in-core: the diagonal Cholesky,
    then the block below by one right-side triangular solve, or, past
    OOC_SOLVE_TEMP_CAP, by invert-then-multiply on the diagonal
    block."""
    m = S.shape[0]
    lkk = chol_diag_factor(S[:w])
    if m <= w:
        return lkk
    if _over_cap(m - w, w, S.element_size()):
        pan = S[w:] @ invert_triangular(lkk, lower=True).mH
    else:
        pan = solve_triangular(lkk.mH, S[w:], upper=True, left=False)
    return torch.cat([lkk, pan], dim=0)


def _strip_solve(Ljj: torch.Tensor, Sj: torch.Tensor, unit: bool
                 ) -> torch.Tensor:
    """U = L_jj^{-1} S_j (lower, unit or not) behind the temps valve."""
    if _over_cap(Sj.shape[1], Ljj.shape[0], Sj.element_size()):
        return invert_triangular(Ljj, lower=True,
                                 unit_diagonal=unit) @ Sj
    return solve_triangular(Ljj, Sj, upper=False, unitriangular=unit)


def _lu_visit(S: torch.Tensor, Lj: torch.Tensor, j0: int,
              unit: bool = True, lo=None) -> torch.Tensor:
    """One left-looking LU visit of panel S (m, w) by an earlier factor
    panel Lj (m, wj) whose diagonal block sits at row j0: the U12 strip
    U = L_jj^{-1} S[j0:j1] (in full precision, against the promoted
    diagonal block when mixed), the trailing product L_j[j1:] U
    subtracted below it, the strip written in place. ``unit=False``
    makes it the non-unit forward step of the Cholesky solve."""
    hi = S.dtype
    wj = Lj.shape[1]
    j1 = j0 + wj
    U = _strip_solve(_up(Lj[j0:j1], hi), S[j0:j1], unit)
    S = S.clone()
    S[j1:] -= _up(Lj[j1:], hi) @ _lo(U, lo, hi)
    S[j0:j1] = U
    return S


def _lu_visit_orig(S: torch.Tensor, Lj: torch.Tensor, g: torch.Tensor,
                   j0: int, lo=None) -> torch.Tensor:
    """The tournament stream's visit in ORIGINAL row order: `g` is the
    position -> original-row permutation as of panel j's factor step.
    Gather both operands into that order, visit, scatter back (the
    gathers are exact)."""
    out = torch.empty_like(S)
    out[g] = _lu_visit(S[g], Lj[g], j0, lo=lo)
    return out


def _fused_strips(Sp, Lp, count, w, lo):
    """The U strips of a fused LU sweep over `count` stacked visitors
    (gathered, row j0 = i w holds visitor i's diagonal block), then the
    one wide trailing product below them."""
    hi = Sp.dtype
    L = _up(Lp, hi)
    cw = count * w
    U = torch.empty((cw, Sp.shape[1]), dtype=hi, device=Sp.device)
    for i in range(count):
        j0 = i * w
        rhs = Sp[j0:j0 + w]
        if i:
            rhs = rhs - L[j0:j0 + w, :j0] @ _lo(U[:j0], lo, hi)
        U[j0:j0 + w] = _strip_solve(L[j0:j0 + w, j0:j0 + w], rhs, True)
    out = Sp.clone()
    out[:cw] = U
    out[cw:] -= L[cw:] @ _lo(U, lo, hi)
    return out


def _lu_visit_fused(S: torch.Tensor, Lcat: torch.Tensor,
                    g: torch.Tensor, count: int, w: int, lo=None
                    ) -> torch.Tensor:
    """Panel S's whole LU visit sweep as one update: Lcat holds the
    full-width visitors j = 0 .. count-1 side by side (original row
    order). One gather `g` = perms[last visitor] serves every member
    (positions < j1 never move after step j, and the strips and
    per-row products do not depend on the order of the rows still
    live). The strips are solved in order, then ONE wide product
    updates the rows below them: the per-panel route's subtractions
    reassociated (close, not bitwise)."""
    out = torch.empty_like(S)
    out[g] = _fused_strips(S[g], Lcat[g], count, w, lo)
    return out


def _chol_back_visit(S: torch.Tensor, Pk: torch.Tensor, k0: int, lo=None
                     ) -> torch.Tensor:
    """Backward L^H step of the streamed Cholesky solve: with
    Pk = L[:, k0:k1], subtract the solved rows below,
    (L^H)[k0:k1, k1:] x[k1:], then solve L_kk^H x_k."""
    hi = S.dtype
    wk = Pk.shape[1]
    k1 = k0 + wk
    rhs = S[k0:k1] - _up(Pk[k1:], hi).mH @ _lo(S[k1:], lo, hi)
    return _back_solve_lower_h(S, _up(Pk[k0:k1], hi), rhs, k0)


def _back_solve_lower_h(S, Lkk, rhs, k0):
    if _over_cap(rhs.shape[1], Lkk.shape[0], S.element_size()):
        X = invert_triangular(Lkk, lower=True).mH @ rhs
    else:
        X = solve_triangular(Lkk.mH, rhs, upper=True)
    S = S.clone()
    S[k0:k0 + Lkk.shape[0]] = X
    return S


def _lu_back_visit(S: torch.Tensor, Pk: torch.Tensor, k0: int, lo=None
                   ) -> torch.Tensor:
    """Backward U step: x_k = U_kk^{-1} S[k0:k1], then U[:k0, k0:k1] x_k
    eliminated from the rows above (the streamed upper solve)."""
    hi = S.dtype
    wk = Pk.shape[1]
    k1 = k0 + wk
    Ukk = _up(Pk[k0:k1], hi)
    if _over_cap(S.shape[1], wk, S.element_size()):
        X = invert_triangular(Ukk, lower=False) @ S[k0:k1]
    else:
        X = solve_triangular(Ukk, S[k0:k1], upper=True)
    S = S.clone()
    S[:k0] -= _up(Pk[:k0], hi) @ _lo(X, lo, hi)
    S[k0:k1] = X
    return S


def _swaps_to_perm(piv: np.ndarray, mlen: int) -> np.ndarray:
    """Replay LAPACK sequential swap targets (j <-> piv[j], in order) on
    arange(mlen): the host twin of lu._compose_swaps."""
    perm = np.arange(mlen)
    for j, t in enumerate(np.asarray(piv)):
        perm[j], perm[t] = perm[t], perm[j]
    return perm


def _lu_panel_factor(S: torch.Tensor, k0: int, nb: int):
    """In-core partial-pivot LU of the resident panel's live rows
    [k0:] through lu._getrf_dense (its panels take the tune cache's
    route: ``pallas_rec`` is the recursive hand kernel). Returns (packed
    (m - k0, w), pivots relative to k0)."""
    from .lu import _getrf_dense
    return _getrf_dense(S[k0:], nb, pivot=True)


def _tnt_select(S: torch.Tensor, live_rows: torch.Tensor, wf: int,
                chunk=None) -> torch.Tensor:
    """Tournament pivot selection over the LIVE rows of the resident
    panel (`live_rows`: the not-yet-pivoted rows, in the current
    permutation's order). Returns live-relative indices (wf,) in
    selection order; a degenerate selection is repaired host-side by
    ca.fix_degenerate_selection."""
    from .ca import tournament_pivot_rows
    return tournament_pivot_rows(S[live_rows, :wf], chunk=chunk)


def _tnt_factor(S: torch.Tensor, new_live: torch.Tensor, wf: int,
                nb: int):
    """Factor the panel with its pivots selected: the live rows in
    sorted order (pivot rows on top) through the CALU no-pivot factor,
    scattered back to their original rows; the other rows keep the U
    values of the visits. Returns (col (m, wf) original order, packed
    (live, wf) sorted order: the top block the m < n tail needs)."""
    from .ca import calu_factor_sorted
    packed = calu_factor_sorted(S[new_live, :wf], inner_nb=nb)
    col = S[:, :wf].clone()
    col[new_live] = packed
    return col, packed


def _unit_lower_solve_capped(Lblk: torch.Tensor, rhs: torch.Tensor
                             ) -> torch.Tensor:
    """One unit-lower solve behind the temps valve (both LU streams'
    U12 tail branches)."""
    return _strip_solve(Lblk, rhs, True)


def _tnt_tail_cols(S: torch.Tensor, packed: torch.Tensor,
                   new_live: torch.Tensor, wf: int) -> torch.Tensor:
    """U12 tail columns of the boundary panel (kmax inside the panel,
    m < n): every live row is a pivot row (live == wf), so the tail is
    one unit-lower solve of the selected rows, written back at their
    original positions."""
    out = S[:, wf:].clone()
    out[new_live] = _unit_lower_solve_capped(packed[:wf, :wf],
                                             S[new_live, wf:])
    return out


def _finalize_lapack_order(stored: np.ndarray, perm: np.ndarray,
                           w: int, out: Optional[np.ndarray] = None
                           ) -> np.ndarray:
    """The original-row-order store as the LAPACK packed layout (row
    position i holds perm[i]'s factor row): one row gather a panel.
    With `out` None in place panel by panel (the checkpoint memmap
    passes an `out`, keeping the original-order layout a resume
    expects)."""
    n = stored.shape[1]
    dst = stored if out is None else out
    idx = torch.from_numpy(np.asarray(perm, np.int64))
    src = torch.from_numpy(stored)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        dst[:, j0:j1] = src[idx, j0:j1].numpy()
    return dst


def _qr_visit(S: torch.Tensor, Pj: torch.Tensor, tauj: torch.Tensor,
              j0: int, trans: bool = True, lo=None) -> torch.Tensor:
    """Apply an earlier panel's compact-WY block to S: V from the packed
    factor's rows j0: (rows above are zero; a lo panel promoted), T
    rebuilt by larft in full precision, and
    S[j0:] -= V (T' (V^H S[j0:])) with T' = T^H for Q^H (trans, the
    left-looking visit) or T for Q (the reverse apply); mixed, the two
    tall products take lo operands."""
    from .qr import _larft, _panel_V
    hi = S.dtype
    V = _up(_panel_V(Pj[j0:], 0), hi)
    T = _larft(V, tauj)
    W = (T.mH if trans else T) @ (V.mH @ _lo(S[j0:], lo, hi))
    S = S.clone()
    S[j0:] -= V @ _lo(W, lo, hi)
    return S


def _qr_visit_fused(S: torch.Tensor, Pcat: torch.Tensor,
                    taus, j0s, w: int, lo=None) -> torch.Tensor:
    """Panel S's compact-WY visit sweep as one update: the members'
    applies in ascending order (Householder applies do not commute, so
    QR fuses the update, not the arithmetic), bitwise the per-panel
    applies."""
    for i, j0 in enumerate(j0s):
        S = _qr_visit(S, Pcat[:, i * w:(i + 1) * w].contiguous(),
                      taus[i], j0, lo=lo)
    return S


def _qr_panel_factor(S: torch.Tensor, k0: int, ib: int):
    """Factor the live rows [k0:] of the resident panel (qr.
    _qr_panel_blocked). Returns (packed (m - k0, wf), taus)."""
    from .qr import _qr_panel_blocked
    return _qr_panel_blocked(S[k0:], ib=ib)


def _qr_apply_fresh(S_rest: torch.Tensor, packed: torch.Tensor,
                    ptau: torch.Tensor) -> torch.Tensor:
    """Apply the just-factored panel's reflectors to the rest of the
    SAME resident panel (kmax inside a panel, m < n)."""
    from .qr import _larft, _panel_V
    V = _panel_V(packed, 0)
    T = _larft(V, ptau)
    return S_rest - V @ (T.mH @ (V.mH @ S_rest))


def _gemm_block(Ab: torch.Tensor, B: torch.Tensor, beta,
                Cb: torch.Tensor) -> torch.Tensor:
    return beta * Cb + Ab @ B


def _gemm_block_overwrite(Ab: torch.Tensor, B: torch.Tensor
                          ) -> torch.Tensor:
    return Ab @ B


# -- Cholesky ----------------------------------------------------------------

@instrument_driver("potrf_ooc")
def potrf_ooc(a: np.ndarray, panel_cols: Optional[int] = None,
              cache_budget_bytes=None, grid=None,
              method=None, ckpt_path: Optional[str] = None,
              ckpt_every: Optional[int] = None,
              precision=None, scheduler=None,
              visit_fuse=None, device=None) -> np.ndarray:
    """Lower Cholesky of a host-resident Hermitian matrix (lower
    triangle read), one column panel at a time through the card.
    Returns the host lower factor.

    Factored panels enter the residency cache at factor time, the next
    input panel is prefetched while the current one factors, and each
    panel's writeback overlaps the next panel's visits;
    ``cache_budget_bytes`` 0 (FROZEN) is the uncached schedule bitwise.
    ``ckpt_path`` / ``ckpt_every``: the factor lives in a memory-mapped
    file and the committed epoch advances every ``ckpt_every`` panels,
    so a crashed stream resumes to a BITWISE equal factor. Under
    ``precision="bf16"`` the factor stays f32 but the visits stage,
    cache and multiply the earlier panels in bf16 (posv_ooc's
    refinement is the accuracy contract). ``visit_fuse="fused"`` turns
    panel k's visits into one wide product over the side-by-side factor
    panels (close to per_panel, not bitwise), on the graph route."""
    a = np.asarray(a)
    n = a.shape[0]
    panel_cols = _panel_cols(panel_cols, n, a.dtype)
    nt = ceil_div(n, panel_cols)
    if _route_shard(n, nt, grid, method, a.dtype, "potrf_ooc"):
        from ..dist.shard_ooc import shard_potrf_ooc
        return _shard_escalate(
            lambda: shard_potrf_ooc(
                a, grid, panel_cols=panel_cols,
                cache_budget_bytes=cache_budget_bytes,
                ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                precision=precision, scheduler=scheduler,
                visit_fuse=visit_fuse),
            lambda: potrf_ooc(a, panel_cols, cache_budget_bytes,
                              ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                              precision=precision, scheduler=scheduler,
                              visit_fuse=visit_fuse, device=grid.device),
            "potrf_ooc", grid)
    dev = resolve_device(device)
    lo = _resolve_precision(precision, n, a.dtype)
    ck = _rckpt.maybe_checkpointer(
        ckpt_path, "potrf_ooc", a, panel_cols, nt, every=ckpt_every,
        extra_meta={"precision": _precision_meta(lo)})
    out = ck.factor if ck is not None else np.zeros_like(a)
    eng = stream.engine_for(n, panel_cols, a.dtype,
                            budget_bytes=cache_budget_bytes,
                            resident_dtype=lo, device=dev)
    ld = stream.host_demoter(lo)
    epoch0 = ck.epoch if ck is not None else 0
    use_fuse = _resolve_visit_fuse(visit_fuse, n, a.dtype)
    use_graph = _resolve_scheduler(scheduler, n, a.dtype) or use_fuse
    led = _ledger.recorder("potrf_ooc", nt=nt, spill_dir=ckpt_path)
    # the loop body as closures: the walk below and the left_looking
    # graph drive the SAME code
    S_live, F, fuse_meta = {}, {}, {}

    def _stage(k):
        _rfaults.check("step", op="potrf_ooc", step=k)
        k0 = k * panel_cols
        k1 = min(k0 + panel_cols, n)
        with _ledger.frame("stage"):
            S_live[k] = eng.fetch("A", k, lambda: a[k0:, k0:k1],
                                  cache=False)

    def _rows(k0, j):
        j0, j1 = j * panel_cols, min((j + 1) * panel_cols, n)
        if eng.caching:
            # cached entries are full-height columns (zeros above the
            # diagonal block), served as rows k0:
            return lambda: ld(out[:, j0:j1])
        return lambda: ld(out[k0:, j0:j1])

    def _update(k, j):
        k0 = k * panel_cols
        w = min(k0 + panel_cols, n) - k0
        view = (k0, n - k0) if eng.caching else None
        with _ledger.frame("stage"):
            Lj = eng.fetch("L", j, _rows(k0, j), view=view)
        if j + 1 < k:
            eng.prefetch("L", j + 1, _rows(k0, j + 1))
        with _ledger.frame("update"):
            S_live[k] = _panel_apply(S_live[k], Lj, w)

    def _fused_update(k, js):
        # panel k's whole sweep as ONE product: the top w rows of the
        # side-by-side operand are the stacked visitor tops, so the
        # per-panel kernel applies unchanged
        k0 = k * panel_cols
        w = min(k0 + panel_cols, n) - k0
        js = list(js)
        view = (k0, n - k0) if eng.caching else None
        with _ledger.frame("stage"):
            Lcat = eng.gather_stacked("L", js, [_rows(k0, j) for j in js],
                                      view=view)
        with _ledger.frame("update"):
            S_live[k] = _panel_apply(S_live[k], Lcat, w)
        _fuse_count_visits(len(js))
        fuse_meta[k] = {"fused_members": js,
                        "fused_width": len(js) * panel_cols}

    def _factor(k):
        w = min(k * panel_cols + panel_cols, n) - k * panel_cols
        if k + 1 < nt:
            n0, n1 = (k + 1) * panel_cols, min((k + 2) * panel_cols, n)
            eng.prefetch("A", k + 1, lambda: a[n0:, n0:n1], cache=False)
        S = S_live[k]
        with _ledger.frame("factor"):
            Lk = _panel_factor(S, w)
        _rguard.check_panel("potrf_ooc", k, Lk, ref=S)
        F[k] = Lk

    def _writeback(k):
        k0 = k * panel_cols
        k1 = min(k0 + panel_cols, n)
        Lk = F.pop(k)
        S_live.pop(k, None)
        if eng.caching:
            Pk = Lk if lo is None else stream.demote_dev(Lk, lo)
            eng.put("L", k, stream._embed_rows(Pk, k0, n))
        eng.write("L", k, Lk, out[k0:, k0:k1])

    def _begin(k):
        if led is not None:
            led.begin(k, epoch=epoch0)

    def _end(k):
        if ck is not None and ck.due(k):
            eng.wait_writes()           # every panel <= k is durable
            ck.commit(k + 1)
        if led is not None:
            led.commit(**fuse_meta.pop(k, {}))

    try:
        if use_graph:
            g = _sched_policies.left_looking(
                "potrf_ooc", panels=range(epoch0, nt),
                updates=lambda k: range(k), stage=_stage,
                update=_update, factor=_factor, writeback=_writeback,
                fused_update=_fused_update if use_fuse else None)
            _sched_execute(g, op="potrf_ooc", nt=nt,
                           begin_step=_begin, end_step=_end)
        else:
            for k in range(epoch0, nt):
                _begin(k)
                _health.heartbeat("potrf_ooc", k, nt)
                _stage(k)
                for j in range(k):
                    _update(k, j)
                _factor(k)
                _writeback(k)
                _end(k)
        _health.heartbeat("potrf_ooc", nt, nt)   # completion beat
        if led is not None:
            led.begin(nt, epoch=epoch0, drain=True)
        eng.wait_writes()
    finally:
        eng.finish()
        if led is not None:
            led.close()
    return out


def _solve_sweep(eng, buf, mat, w, n, X, order, kernel, prep=None):
    """One streamed triangular-solve sweep: for each panel start in
    `order`, fetch the factor column ``mat[:, k0:k0 + w]`` (prefetching
    the next) and advance the device-resident right-hand side with
    ``kernel(X, Pk, k0)``. `prep` transforms the host slice before
    staging (the mixed path's demote_host)."""
    if prep is None:
        prep = lambda sl: sl                              # noqa: E731
    for i, k0 in enumerate(order):
        Pk = eng.fetch(buf, k0 // w,
                       lambda k0=k0: prep(mat[:, k0:min(k0 + w, n)]))
        if i + 1 < len(order):
            p0 = order[i + 1]
            eng.prefetch(buf, p0 // w,
                         lambda p0=p0: prep(mat[:, p0:min(p0 + w, n)]))
        X = kernel(X, Pk, k0)
    return X


@instrument_driver("potrs_ooc")
def potrs_ooc(l: np.ndarray, b: np.ndarray,
              panel_cols: Optional[int] = None,
              cache_budget_bytes=None, precision=None,
              device=None) -> np.ndarray:
    """Solve A X = B from potrf_ooc's host lower factor: each factor
    panel streams twice (the non-unit forward sweep, then the
    conjugate-transposed backward sweep) against B on the card. With a
    budget the backward sweep re-serves what the forward sweep left
    resident. ``precision="bf16"`` stages bf16 panels (the lo solve of
    posv_ooc's refinement)."""
    l = np.asarray(l)
    n = l.shape[0]
    dev = resolve_device(device)
    lo = _resolve_precision(precision, n, l.dtype)
    w = min(_panel_cols(panel_cols, n, l.dtype), n)
    panels = list(range(0, n, w))
    eng = stream.engine_for(n, w, l.dtype,
                            budget_bytes=cache_budget_bytes,
                            resident_dtype=lo, device=dev)
    prep = stream.host_demoter(lo)
    fwd = partial(_lu_visit, unit=False, lo=lo)
    bwd = partial(_chol_back_visit, lo=lo)
    try:
        X = _h2d(np.asarray(b), dev)
        X = _solve_sweep(eng, "L", l, w, n, X, panels, fwd, prep=prep)
        X = _solve_sweep(eng, "L", l, w, n, X, panels[::-1], bwd,
                         prep=prep)
        return _host(X)
    finally:
        eng.finish()


@instrument_driver("posv_ooc")
def posv_ooc(a: np.ndarray, b: np.ndarray,
             panel_cols: Optional[int] = None,
             cache_budget_bytes=None, grid=None, method=None,
             precision=None, opts=None, device=None):
    """Factor + solve (the OOC twin of posv): returns (L, X), both on
    the host. Under ``precision="bf16"`` the factor streams with bf16
    updates and bf16-staged solve sweeps, then the solution finishes
    with refine.host_ir (full-precision host residuals, lo solves); on
    non-convergence the ``mixed_to_full`` rung is recorded and the
    answer is a full-precision factor + solve (that factor returned)."""
    a = np.asarray(a)
    lo = _resolve_precision(precision, a.shape[0], a.dtype)
    L = potrf_ooc(a, panel_cols, cache_budget_bytes, grid=grid,
                  method=method, precision=precision, device=device)
    X = potrs_ooc(L, b, panel_cols, cache_budget_bytes,
                  precision=precision, device=device)
    if lo is None:
        return L, X
    from .refine import host_ir
    full: dict = {}

    def solve_lo(r):
        return potrs_ooc(L, r, panel_cols, cache_budget_bytes,
                         precision=precision, device=device)

    def full_solve():
        # both phases pinned to "f32": a tuned bf16 entry must not
        # resolve again inside the fallback
        full["L"] = potrf_ooc(a, panel_cols, cache_budget_bytes,
                              precision="f32", device=device)
        return potrs_ooc(full["L"], np.asarray(b), panel_cols,
                         cache_budget_bytes, precision="f32",
                         device=device)

    X, _iters = host_ir("posv_ooc", _herm_operand(a), np.asarray(b),
                        X, solve_lo, full_solve, opts=opts)
    return full.get("L", L), X


# -- LU (partial pivoting) ---------------------------------------------------

@instrument_driver("getrf_ooc")
def getrf_ooc(a: np.ndarray, panel_cols: Optional[int] = None,
              incore_nb: int = 1024, cache_budget_bytes=None,
              pivot=None, grid=None, method=None,
              chunk: Optional[int] = None,
              ckpt_path: Optional[str] = None,
              ckpt_every: Optional[int] = None,
              precision=None, scheduler=None, visit_fuse=None,
              device=None):
    """LU of a host-resident (m, n) matrix, one column panel at a time
    (left-looking; reference src/getrf.cc:327). Returns (LU_packed,
    ipiv): the packed host factor and LAPACK global sequential swap
    targets (0-based, int64) of length min(m, n).

    ``pivot`` (MethodLUPivot; explicit > ``ooc/lu_pivot`` > FROZEN
    "partial"):

      * "partial" (this body): pivoting confined to the resident panel,
        which searches rows k0: (the rows in-core getrf would search),
        so the pivots match the in-core factorization. The row swaps
        are applied host-side to the written L panels and folded into
        the permutation future reads go through; the fixup retires
        every cached L panel (``ooc.lu_invalidations``). No checkpoint
        (the fixups rewrite committed panels);
      * "tournament": getrf_tntpiv_ooc. bf16 precision and the fused
        sweep imply it.

    Each panel factors in-core through lu._getrf_dense at width
    ``incore_nb``: with the tune cache's ``pallas_rec`` route its
    panels are the recursive hand kernel, whose gate takes w <= 512 (at
    the default 1024 the panels take the library LU)."""
    from ..core.exceptions import slate_assert
    from ..core.methods import MethodLUPivot, str2method
    a = np.asarray(a)
    m, n = a.shape
    kmax = min(m, n)
    w = min(_panel_cols(panel_cols, n, a.dtype), n)
    sharded = _route_shard(n, ceil_div(n, w), grid, method, a.dtype,
                           "getrf_ooc")
    mode = pivot
    if isinstance(mode, str):
        mode = str2method("lu_pivot", mode)
    asked = mode if mode is not MethodLUPivot.Auto else None
    if mode is None or mode is MethodLUPivot.Auto:
        mode = MethodLUPivot.resolve(n, a.dtype)
    lo = _resolve_precision(precision, n, a.dtype)
    if lo is not None:
        # the mixed path needs the immutable tournament store: a
        # partial-pivot fixup rewrites panels the cache holds demoted
        slate_assert(
            asked is not MethodLUPivot.Partial,
            "the mixed-precision OOC LU is tournament-only (the "
            "partial-pivot fixup rewrites panels the cache holds "
            "demoted); drop pivot='partial' or precision='bf16'")
        mode = MethodLUPivot.Tournament
    if _resolve_visit_fuse(visit_fuse, n, a.dtype):
        slate_assert(
            asked is not MethodLUPivot.Partial,
            "the fused OOC LU visit sweep is tournament-only (the "
            "partial-pivot walk has no graph route); drop "
            "pivot='partial' or visit_fuse='fused'")
        mode = MethodLUPivot.Tournament
    if sharded:
        slate_assert(
            asked is None or asked is MethodLUPivot.Tournament,
            "the sharded OOC LU is tournament-only (a partial-pivot "
            "fixup rewrites panels every rank holds); drop "
            "pivot='partial' or route method='stream'")
        from ..dist.shard_ooc import shard_getrf_ooc
        return _shard_escalate(
            lambda: shard_getrf_ooc(
                a, grid, panel_cols=w, incore_nb=incore_nb,
                cache_budget_bytes=cache_budget_bytes, chunk=chunk,
                ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                precision=precision, scheduler=scheduler,
                visit_fuse=visit_fuse),
            lambda: getrf_tntpiv_ooc(
                a, w, incore_nb, cache_budget_bytes, chunk=chunk,
                ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                precision=precision, scheduler=scheduler,
                visit_fuse=visit_fuse, device=grid.device),
            "getrf_ooc", grid)
    if mode is MethodLUPivot.Tournament:
        return getrf_tntpiv_ooc(a, w, incore_nb, cache_budget_bytes,
                                chunk=chunk, ckpt_path=ckpt_path,
                                ckpt_every=ckpt_every,
                                precision=precision,
                                scheduler=scheduler,
                                visit_fuse=visit_fuse, device=device)
    slate_assert(
        ckpt_path is None,
        "partial-pivot OOC LU cannot checkpoint (row-swap fixups "
        "rewrite committed panels); use pivot='tournament'")
    dev = resolve_device(device)
    perm = np.arange(m)
    out = np.empty_like(a)
    ipiv = np.empty((kmax,), np.int64)
    nt = ceil_div(n, w)
    eng = stream.engine_for(max(m, n), w, a.dtype,
                            budget_bytes=cache_budget_bytes, device=dev)
    led = _ledger.recorder("getrf_ooc", nt=nt)
    try:
        for k0 in range(0, n, w):
            k1 = min(k0 + w, n)
            k = k0 // w
            if led is not None:
                led.begin(k)
            _health.heartbeat("getrf_ooc", k, nt)
            with _ledger.frame("stage"):
                S = _h2d(_host_take_rows(a[:, k0:k1], perm), dev)
            for j0 in range(0, min(k0, kmax), w):
                j1 = min(j0 + w, kmax)
                with _ledger.frame("stage"):
                    Lj = eng.fetch("LU", j0 // w,
                                   lambda j0=j0, j1=j1: out[:, j0:j1])
                if j0 + w < min(k0, kmax):
                    p0, p1 = j0 + w, min(j0 + 2 * w, kmax)
                    eng.prefetch("LU", p0 // w,
                                 lambda p0=p0, p1=p1: out[:, p0:p1])
                with _ledger.frame("update"):
                    S = _lu_visit(S, Lj, j0)
            if k0 < kmax:
                wf = min(k1, kmax) - k0
                with _ledger.frame("factor"):
                    packed, piv = _lu_panel_factor(
                        S[:, :wf], k0, min(incore_nb, max(wf, 1)))
                piv_h = _host(piv).astype(np.int64)
                lperm = _swaps_to_perm(piv_h, m - k0)
                # host fixups: swap the rows of the L panels already
                # written (after their writebacks land) and of the
                # permutation of future reads; retire their cached
                # copies (the wrong-answer guard)
                if k0 > 0 and not np.array_equal(
                        lperm, np.arange(m - k0)):
                    eng.wait_writes()
                    out[k0:, :k0] = _host_take_rows(out[k0:, :k0], lperm)
                    eng.invalidate("LU", cause="lu")
                perm[k0:] = perm[k0:][lperm]
                ipiv[k0:k0 + wf] = k0 + piv_h
                if k0 > 0:
                    eng.write("LU", k, S[:k0],    # U rows from visits
                              out[:k0, k0:k1])
                eng.write("LU", k, packed, out[k0:, k0:k0 + wf])
                if wf < k1 - k0:
                    # kmax inside this panel (m < n): the columns right
                    # of the last diagonal block are pure U12 rows
                    rest = S[k0:, wf:][_to_dev(lperm, dev)]
                    U = _unit_lower_solve_capped(packed[:wf, :wf],
                                                 rest[:wf])
                    out[k0:k0 + wf, k0 + wf:k1] = _host(U)
            else:
                eng.write("LU", k, S, out[:, k0:k1])
            if led is not None:
                led.commit()
        _health.heartbeat("getrf_ooc", nt, nt)   # completion beat
        if led is not None:
            led.begin(nt, drain=True)
        eng.wait_writes()
    finally:
        eng.finish()
        if led is not None:
            led.close()
    return out, ipiv


# -- LU (tournament pivoting) ------------------------------------------------

@instrument_driver("getrf_tntpiv_ooc")
def getrf_tntpiv_ooc(a: np.ndarray, panel_cols: Optional[int] = None,
                     incore_nb: int = 1024, cache_budget_bytes=None,
                     chunk: Optional[int] = None,
                     ckpt_path: Optional[str] = None,
                     ckpt_every: Optional[int] = None,
                     precision=None, scheduler=None,
                     visit_fuse=None, device=None):
    """Tournament-pivot (CALU) LU of a host-resident (m, n) matrix, one
    column panel at a time (reference src/getrf_tntpiv.cc:169-222).
    Returns (LU_packed, ipiv) in getrf_ooc's contract; getrs_ooc
    consumes it unchanged.

    Each panel's pivots are final before its column is written; the
    factor is stored in original row order and the permutation applied
    at visit time by a device gather (_lu_visit_orig), so written panels
    never change: no fixups, ZERO cache invalidations, every revisit a
    cache hit under a budget. Permutation vectors do not go through
    _h2d (the h2d counters stay panel bytes). ``chunk`` overrides the
    tournament's chunk height. ``ckpt_path`` / ``ckpt_every``: the
    store, ipiv and the per-panel permutation snapshots are durable and
    the meta records ``lu_pivot="tournament"`` and the precision, so a
    mismatched resume starts fresh. ``precision="bf16"`` stages, caches
    and multiplies the visiting columns in bf16 (select / factor stay
    in the input dtype). ``visit_fuse="fused"``: one strip loop and one
    wide trailing product a panel (_lu_visit_fused), pivots equal to
    per_panel; a ragged last member stays per panel."""
    from .ca import fix_degenerate_selection
    from .lu import tnt_swaps_host
    a = np.asarray(a)
    m, n = a.shape
    kmax = min(m, n)
    w = min(_panel_cols(panel_cols, n, a.dtype), n)
    nt = ceil_div(n, w)
    nf = ceil_div(kmax, w)          # factor panels (k0 < kmax)
    dev = resolve_device(device)
    lo = _resolve_precision(precision, n, a.dtype)
    ck = _rckpt.maybe_checkpointer(
        ckpt_path, "getrf_tntpiv_ooc", a, w, nt, every=ckpt_every,
        extra_arrays={"ipiv": ((kmax,), np.int64),
                      "perms": ((nf, m), np.int64)},
        extra_meta={"lu_pivot": "tournament",
                    "precision": _precision_meta(lo)})
    if ck is not None:
        stored, ipiv = ck.factor, ck.array("ipiv")
        perms, epoch = ck.array("perms"), ck.epoch
    else:
        stored = np.empty_like(a)
        ipiv = np.empty((kmax,), np.int64)
        perms = np.empty((nf, m), np.int64)
        epoch = 0
    # the position -> original-row map, rebuilt from the last committed
    # snapshot on resume
    perm = perms[min(epoch, nf) - 1].copy() if min(epoch, nf) > 0 \
        else np.arange(m)
    eng = stream.engine_for(max(m, n), w, a.dtype,
                            budget_bytes=cache_budget_bytes,
                            resident_dtype=lo, device=dev)
    ld = stream.host_demoter(lo)
    gdev: dict = {}

    def _g(j: int) -> torch.Tensor:
        """Device copy of the post-step-j permutation (the visit
        gather), uploaded once a panel and reused, up to _GDEV_MAX
        vectors."""
        g = gdev.get(j)
        if g is None:
            g = _to_dev(perms[j], dev)
            if len(gdev) < _GDEV_MAX:
                gdev[j] = g
        return g

    use_fuse = _resolve_visit_fuse(visit_fuse, n, a.dtype)
    use_graph = _resolve_scheduler(scheduler, n, a.dtype) or use_fuse
    led = _ledger.recorder("getrf_tntpiv_ooc", nt=nt,
                           spill_dir=ckpt_path)
    S_live, F, fuse_meta = {}, {}, {}

    def _stage(k):
        _rfaults.check("step", op="getrf_tntpiv_ooc", step=k)
        k0, k1 = k * w, min(k * w + w, n)
        with _ledger.frame("stage"):
            S_live[k] = eng.fetch("Ain", k, lambda: a[:, k0:k1],
                                  cache=False)
        if k + 1 < nt:
            n0, n1 = k1, min(k1 + w, n)
            eng.prefetch("Ain", k + 1, lambda: a[:, n0:n1], cache=False)

    def _update(k, j):
        k0 = k * w
        j0 = j * w
        j1 = min(j0 + w, kmax)
        with _ledger.frame("stage"):
            Lj = eng.fetch("LU", j, lambda: ld(stored[:, j0:j1]))
        if j0 + w < min(k0, kmax):
            p0, p1 = j0 + w, min(j0 + 2 * w, kmax)
            eng.prefetch("LU", p0 // w, lambda: ld(stored[:, p0:p1]))
        with _ledger.frame("update"):
            S_live[k] = _lu_visit_orig(S_live[k], Lj, _g(j), j0, lo)

    def _fused_update(k, js):
        # the full-width members (a prefix of js) as one update; a
        # ragged member (kmax inside the last factor panel) stays per
        # panel AFTER it: it is the max j, so the visit order holds
        js = list(js)
        full = [j for j in js if (j + 1) * w <= kmax]
        if len(full) > 1:
            loaders = [(lambda j0=j * w: ld(stored[:, j0:j0 + w]))
                       for j in full]
            with _ledger.frame("stage"):
                Lcat = eng.gather_stacked("LU", full, loaders)
            with _ledger.frame("update"):
                S_live[k] = _lu_visit_fused(S_live[k], Lcat,
                                            _g(full[-1]), len(full), w, lo)
            _fuse_count_visits(len(full))
            fuse_meta[k] = {"fused_members": full,
                            "fused_width": len(full) * w}
        else:
            for j in full:
                _update(k, j)
        for j in js:
            if j not in full:
                _update(k, j)

    def _factor(k):
        k0, k1 = k * w, min(k * w + w, n)
        wf = min(k1, kmax) - k0
        live = m - k0
        S = S_live[k]
        with _ledger.frame("factor"):
            sel = _tnt_select(S, _to_dev(perm[k0:], dev),
                              wf, chunk=chunk)
            sel = fix_degenerate_selection(sel, live, wf)
        piv_rel, lperm = tnt_swaps_host(sel, live)
        new_live = perm[k0:][lperm]
        with _ledger.frame("factor"):
            col, packed = _tnt_factor(
                S, _to_dev(new_live, dev), wf,
                min(int(incore_nb), max(wf, 1)))
        perm[k0:] = new_live
        ipiv[k0:k0 + wf] = k0 + piv_rel
        perms[k] = perm
        _rguard.check_panel("getrf_tntpiv_ooc", k, col, ref=S)
        F[k] = (col, packed, new_live, wf)

    def _writeback(k):
        k0, k1 = k * w, min(k * w + w, n)
        wk = k1 - k0
        S = S_live.pop(k)
        if k0 < kmax:
            col, packed, new_live, wf = F.pop(k)
            if eng.caching:
                # the immutable form: zero revisit uploads (demoted
                # under the mixed mode: the bytes a miss would stage)
                eng.put("LU", k, col if lo is None
                        else stream.demote_dev(col, lo))
            eng.write("LU", k, col, stored[:, k0:k0 + wf])
            if wf < wk:
                # kmax inside this panel (m < n)
                tail = _tnt_tail_cols(
                    S, packed, _to_dev(new_live, dev), wf)
                eng.write("LU", k, tail, stored[:, k0 + wf:k1])
        else:
            eng.write("LU", k, S, stored[:, k0:k1])

    def _begin(k):
        if led is not None:
            led.begin(k, epoch=epoch)

    def _end(k):
        if ck is not None and ck.due(k):
            eng.wait_writes()           # every panel <= k is durable
            ck.commit(k + 1)
        if led is not None:
            led.commit(**fuse_meta.pop(k, {}))

    def _visitors(k):
        return range(ceil_div(min(k * w, kmax), w))

    try:
        if use_graph:
            g = _sched_policies.left_looking(
                "getrf_tntpiv_ooc", panels=range(epoch, nt),
                updates=_visitors, stage=_stage, update=_update,
                factor=_factor, writeback=_writeback,
                has_factor=lambda k: k * w < kmax,
                fused_update=_fused_update if use_fuse else None)
            _sched_execute(g, op="getrf_tntpiv_ooc", nt=nt,
                           begin_step=_begin, end_step=_end)
        else:
            for k in range(epoch, nt):
                _begin(k)
                _health.heartbeat("getrf_tntpiv_ooc", k, nt)
                _stage(k)
                for j in _visitors(k):
                    _update(k, j)
                if k * w < kmax:
                    _factor(k)
                _writeback(k)
                _end(k)
        _health.heartbeat("getrf_tntpiv_ooc", nt, nt)   # completion
        if led is not None:
            led.begin(nt, epoch=epoch, drain=True)
        eng.wait_writes()
    finally:
        eng.finish()
        if led is not None:
            led.close()
    if ck is not None:
        out = _finalize_lapack_order(stored, perm, w,
                                     out=np.empty_like(stored))
        return out, np.array(ipiv)
    return _finalize_lapack_order(stored, perm, w), ipiv


@instrument_driver("getrs_ooc")
def getrs_ooc(lu: np.ndarray, ipiv: np.ndarray, b: np.ndarray,
              panel_cols: Optional[int] = None,
              cache_budget_bytes=None, precision=None,
              device=None) -> np.ndarray:
    """Solve A X = B from getrf_ooc's host factor: the pivots replayed
    on B, then each factor panel streams twice (the unit-lower forward
    sweep, the same kernel as the left-looking visit, and the upper
    backward sweep) against B on the card. ``precision="bf16"`` stages
    bf16 panels (gesv_ooc's lo solve)."""
    lu = np.asarray(lu)
    n = lu.shape[0]
    dev = resolve_device(device)
    lo = _resolve_precision(precision, n, lu.dtype)
    w = min(_panel_cols(panel_cols, n, lu.dtype), n)
    panels = list(range(0, n, w))
    perm = _swaps_to_perm(ipiv, n)
    eng = stream.engine_for(n, w, lu.dtype,
                            budget_bytes=cache_budget_bytes,
                            resident_dtype=lo, device=dev)
    prep = stream.host_demoter(lo)
    fwd = partial(_lu_visit, lo=lo)
    bwd = partial(_lu_back_visit, lo=lo)
    try:
        X = _h2d(np.take(np.asarray(b), perm, axis=0), dev)
        X = _solve_sweep(eng, "LU", lu, w, n, X, panels, fwd, prep=prep)
        X = _solve_sweep(eng, "LU", lu, w, n, X, panels[::-1], bwd,
                         prep=prep)
        return _host(X)
    finally:
        eng.finish()


@instrument_driver("gesv_ooc")
def gesv_ooc(a: np.ndarray, b: np.ndarray,
             panel_cols: Optional[int] = None,
             cache_budget_bytes=None, pivot=None, grid=None,
             method=None, precision=None, opts=None,
             incore_nb: int = 1024, device=None):
    """Factor + solve (the OOC twin of gesv): ((LU, ipiv), X). `pivot`
    routes the factor (MethodLUPivot); both modes return the same
    packed contract, so the solve is mode-blind. `incore_nb` is the
    in-core panel width of the factor (getrf_ooc). Under
    ``precision="bf16"``: the tournament factor with bf16 updates,
    bf16-staged solve sweeps, then refine.host_ir, whose sentinel
    records ``mixed_to_full`` and falls back to the full-precision
    factor + solve (that factor returned)."""
    a = np.asarray(a)
    lo = _resolve_precision(precision, a.shape[1], a.dtype)
    lu, ipiv = getrf_ooc(a, panel_cols, incore_nb=incore_nb,
                         cache_budget_bytes=cache_budget_bytes,
                         pivot=pivot, grid=grid, method=method,
                         precision=precision, device=device)
    X = getrs_ooc(lu, ipiv, b, panel_cols, cache_budget_bytes,
                  precision=precision, device=device)
    if lo is None:
        return (lu, ipiv), X
    from .refine import host_ir
    full: dict = {}

    def solve_lo(r):
        return getrs_ooc(lu, ipiv, r, panel_cols, cache_budget_bytes,
                         precision=precision, device=device)

    def full_solve():
        # both phases pinned to "f32" (posv_ooc)
        full["f"] = getrf_ooc(a, panel_cols, incore_nb=incore_nb,
                              cache_budget_bytes=cache_budget_bytes,
                              pivot=pivot, precision="f32",
                              device=device)
        flu, fpiv = full["f"]
        return getrs_ooc(flu, fpiv, np.asarray(b), panel_cols,
                         cache_budget_bytes, precision="f32",
                         device=device)

    X, _iters = host_ir("gesv_ooc", a, np.asarray(b), X, solve_lo,
                        full_solve, opts=opts)
    return full.get("f", (lu, ipiv)), X


# -- QR ----------------------------------------------------------------------

@instrument_driver("geqrf_ooc")
def geqrf_ooc(a: np.ndarray, panel_cols: Optional[int] = None,
              incore_ib: int = 128, cache_budget_bytes=None,
              engine: Optional["stream.StreamEngine"] = None,
              grid=None, method=None,
              ckpt_path: Optional[str] = None,
              ckpt_every: Optional[int] = None,
              precision=None, scheduler=None, visit_fuse=None,
              device=None):
    """Householder QR of a host-resident (m, n) matrix, one column panel
    at a time (left-looking; reference src/geqrf.cc:26). Returns
    (QR_packed, taus) in geqrf's packed contract (V below the diagonal,
    R on and above, taus of length min(m, n)). Reflector panels never
    change once written, so with a budget each is uploaded at most once
    (no invalidation). `engine` lets a composed driver (gels_ooc) share
    its cache with the apply that follows (on the engine's device; such
    runs never checkpoint and never mix precisions).
    ``precision="bf16"`` stages and multiplies the reflector panels in
    bf16 (T in f32): no refinement exists for a bare factorization.
    ``visit_fuse="fused"``: a panel's ordered applies as one update,
    bitwise the per-panel applies."""
    from ..core.exceptions import slate_assert
    a = np.asarray(a)
    m, n = a.shape
    kmax = min(m, n)
    w = min(_panel_cols(panel_cols, n, a.dtype), n)
    if engine is None:
        if _route_shard(n, ceil_div(n, w), grid, method, a.dtype,
                        "geqrf_ooc"):
            from ..dist.shard_ooc import shard_geqrf_ooc
            return _shard_escalate(
                lambda: shard_geqrf_ooc(
                    a, grid, panel_cols=w, incore_ib=incore_ib,
                    cache_budget_bytes=cache_budget_bytes,
                    ckpt_path=ckpt_path, ckpt_every=ckpt_every,
                    precision=precision, scheduler=scheduler,
                    visit_fuse=visit_fuse),
                lambda: geqrf_ooc(a, w, incore_ib, cache_budget_bytes,
                                  ckpt_path=ckpt_path,
                                  ckpt_every=ckpt_every,
                                  precision=precision,
                                  scheduler=scheduler,
                                  visit_fuse=visit_fuse,
                                  device=grid.device),
                "geqrf_ooc", grid)
        lo = _resolve_precision(precision, n, a.dtype)
    else:
        # a shared engine holds one dtype's residents: an explicit
        # mixed request is an error, the tuned route keeps full
        lo = _resolve_precision(precision, n, a.dtype) \
            if precision is not None else None
        slate_assert(
            lo is None,
            "geqrf_ooc: a shared engine cannot carry mixed-"
            "precision residents (one cache, one dtype); drop "
            "precision= or the engine=")
    nt = ceil_div(n, w)
    # checkpoint / resume: factor and taus are durable memmaps; a
    # resumed run starts at the committed epoch and its visits read the
    # durable factor, the same bytes the uninterrupted run wrote
    ck = _rckpt.maybe_checkpointer(
        ckpt_path, "geqrf_ooc", a, w, nt, every=ckpt_every,
        extra_arrays={"taus": ((kmax,), a.dtype)},
        extra_meta={"precision": _precision_meta(lo)}) \
        if engine is None else None
    if ck is not None:
        out, taus = ck.factor, ck.array("taus")
    else:
        out = np.empty_like(a)
        taus = np.zeros((kmax,), a.dtype)
    own = engine is None
    eng = stream.engine_for(max(m, n), w, a.dtype,
                            budget_bytes=cache_budget_bytes,
                            resident_dtype=lo, device=device) \
        if own else engine
    dev = eng.device
    ld = stream.host_demoter(lo)
    epoch0 = ck.epoch if ck is not None else 0
    use_fuse = _resolve_visit_fuse(visit_fuse, n, a.dtype)
    use_graph = _resolve_scheduler(scheduler, n, a.dtype) or use_fuse
    led = _ledger.recorder("geqrf_ooc", nt=nt,
                           spill_dir=ckpt_path if own else None)
    S_live, F, fuse_meta = {}, {}, {}

    def _stage(k):
        _rfaults.check("step", op="geqrf_ooc", step=k)
        k0, k1 = k * w, min(k * w + w, n)
        with _ledger.frame("stage"):
            S_live[k] = eng.fetch("Ain", k, lambda: a[:, k0:k1],
                                  cache=False)

    def _update(k, j):
        k0 = k * w
        j0 = j * w
        j1 = min(j0 + w, kmax)
        with _ledger.frame("stage"):
            Pj = eng.fetch("QR", j, lambda: ld(out[:, j0:j1]))
        if j0 + w < min(k0, kmax):
            p0, p1 = j0 + w, min(j0 + 2 * w, kmax)
            eng.prefetch("QR", p0 // w, lambda: ld(out[:, p0:p1]))
        with _ledger.frame("update"):
            S_live[k] = _qr_visit(S_live[k], Pj, _h2d(taus[j0:j1], dev),
                                  j0, lo=lo)

    def _fused_update(k, js):
        # the full-width members (a prefix of js) as one update, in
        # ascending order; a ragged member stays per panel AFTER it
        js = list(js)
        full = [j for j in js if (j + 1) * w <= kmax]
        if len(full) > 1:
            loaders = [(lambda j0=j * w: ld(out[:, j0:j0 + w]))
                       for j in full]
            with _ledger.frame("stage"):
                Pcat = eng.gather_stacked("QR", full, loaders)
            tstk = _h2d(np.stack([taus[j * w:(j + 1) * w]
                                  for j in full]), dev)
            with _ledger.frame("update"):
                S_live[k] = _qr_visit_fused(
                    S_live[k], Pcat, tstk, [j * w for j in full], w, lo)
            _fuse_count_visits(len(full))
            fuse_meta[k] = {"fused_members": full,
                            "fused_width": len(full) * w}
        else:
            for j in full:
                _update(k, j)
        for j in js:
            if j not in full:
                _update(k, j)

    def _pref_next(k):
        k0 = k * w
        if k0 + w < n:
            n0, n1 = k0 + w, min(k0 + 2 * w, n)
            eng.prefetch("Ain", k + 1, lambda: a[:, n0:n1], cache=False)

    def _factor(k):
        _pref_next(k)
        k0, k1 = k * w, min(k * w + w, n)
        wf = min(k1, kmax) - k0
        S = S_live[k]
        with _ledger.frame("factor"):
            packed, ptau = _qr_panel_factor(S[:, :wf], k0, incore_ib)
        _rguard.check_panel("geqrf_ooc", k, packed, ref=S)
        F[k] = (packed, ptau, wf)

    def _writeback(k):
        k0, k1 = k * w, min(k * w + w, n)
        S = S_live.pop(k)
        if k0 < kmax:
            packed, ptau, wf = F.pop(k)
            if k0 > 0:
                eng.write("QR", k, S[:k0], out[:k0, k0:k1])
            eng.write("QR", k, packed, out[k0:, k0:k0 + wf])
            taus[k0:k0 + wf] = _host(ptau[:wf])
            if wf < k1 - k0:
                rest = _qr_apply_fresh(S[k0:, wf:], packed, ptau)
                eng.write("QR", k, rest, out[k0:, k0 + wf:k1])
        else:
            _pref_next(k)       # pure-U panels prefetch here instead
            eng.write("QR", k, S, out[:, k0:k1])

    def _begin(k):
        if led is not None:
            led.begin(k, epoch=epoch0)

    def _end(k):
        if ck is not None and ck.due(k):
            eng.wait_writes()           # every panel <= k is durable
            ck.commit(k + 1)
        if led is not None:
            led.commit(**fuse_meta.pop(k, {}))

    def _visitors(k):
        return range(ceil_div(min(k * w, kmax), w))

    try:
        if use_graph:
            g = _sched_policies.left_looking(
                "geqrf_ooc", panels=range(epoch0, nt),
                updates=_visitors, stage=_stage, update=_update,
                factor=_factor, writeback=_writeback,
                has_factor=lambda k: k * w < kmax,
                fused_update=_fused_update if use_fuse else None)
            _sched_execute(g, op="geqrf_ooc", nt=nt,
                           begin_step=_begin, end_step=_end)
        else:
            for k in range(epoch0, nt):
                _begin(k)
                _health.heartbeat("geqrf_ooc", k, nt)
                _stage(k)
                for j in _visitors(k):
                    _update(k, j)
                if k * w < kmax:
                    _factor(k)
                _writeback(k)
                _end(k)
        _health.heartbeat("geqrf_ooc", nt, nt)   # completion beat
        if led is not None:
            led.begin(nt, epoch=epoch0, drain=True)
        eng.wait_writes()
    finally:
        if own:
            eng.finish()
        else:
            eng.wait_writes()
        if led is not None:
            led.close()
    return out, taus


@instrument_driver("unmqr_ooc")
def unmqr_ooc(qr: np.ndarray, taus: np.ndarray, c: np.ndarray,
              trans: bool = True,
              panel_cols: Optional[int] = None,
              cache_budget_bytes=None,
              engine: Optional["stream.StreamEngine"] = None,
              device=None) -> np.ndarray:
    """Apply Q (trans=False) or Q^H (True) from geqrf_ooc's host factor
    to C on the card, streaming the reflector panels (Q^H forward, Q in
    reverse). A shared `engine` (gels_ooc) serves the panels geqrf_ooc
    just cached."""
    qr = np.asarray(qr)
    kmax = min(qr.shape)
    w = min(_panel_cols(panel_cols, kmax, qr.dtype), kmax)
    starts = list(range(0, kmax, w))
    if not trans:
        starts.reverse()
    own = engine is None
    eng = stream.engine_for(max(qr.shape), w, qr.dtype,
                            budget_bytes=cache_budget_bytes,
                            device=device) if own else engine
    dev = eng.device
    try:
        X = _h2d(np.asarray(c), dev)
        for i, j0 in enumerate(starts):
            _health.heartbeat("unmqr_ooc", i, len(starts))
            j1 = min(j0 + w, kmax)
            Pj = eng.fetch("QR", j0 // w,
                           lambda j0=j0, j1=j1: qr[:, j0:j1])
            if i + 1 < len(starts):
                p0 = starts[i + 1]
                eng.prefetch("QR", p0 // w,
                             lambda p0=p0: qr[:, p0:min(p0 + w, kmax)])
            X = _qr_visit(X, Pj, _h2d(taus[j0:j1], dev), j0, trans=trans)
        _health.heartbeat("unmqr_ooc", len(starts), len(starts))
        return _host(X)
    finally:
        if own:
            eng.finish()


@instrument_driver("gels_ooc")
def gels_ooc(a: np.ndarray, b: np.ndarray,
             panel_cols: Optional[int] = None,
             cache_budget_bytes=None, grid=None, method=None,
             device=None):
    """Least squares min ||A X - B|| for a host-resident TALL A
    (m >= n) by the streamed QR: Q^H B by reflector-panel visits, then
    the upper back-substitution sweep on R (getrs_ooc's backward
    kernel). Returns ((QR_packed, taus), X). One engine spans the three
    phases, so the apply and the R sweep are served from the panels the
    factorization cached."""
    from ..core.exceptions import slate_assert
    a = np.asarray(a)
    m, n = a.shape
    slate_assert(m >= n, "gels_ooc requires tall A (m >= n): the R "
                 "back-substitution sweep indexes n factor rows")
    panel_cols = _panel_cols(panel_cols, n, a.dtype)
    w = min(panel_cols, n)
    sharded = _route_shard(n, ceil_div(n, w), grid, method, a.dtype,
                           "gels_ooc")
    eng = stream.engine_for(m, w, a.dtype,
                            budget_bytes=cache_budget_bytes,
                            device=device)
    try:
        if sharded:
            # the factor on the grid; the apply and the R sweep on this
            # rank's engine
            from ..dist.shard_ooc import shard_geqrf_ooc
            qr_p, taus = _shard_escalate(
                lambda: shard_geqrf_ooc(
                    a, grid, panel_cols=w,
                    cache_budget_bytes=cache_budget_bytes),
                lambda: geqrf_ooc(a, panel_cols, engine=eng),
                "gels_ooc", grid)
        else:
            qr_p, taus = geqrf_ooc(a, panel_cols, engine=eng)
        y = unmqr_ooc(qr_p, taus, np.asarray(b), trans=True,
                      panel_cols=panel_cols, engine=eng)
        X = _to_dev(y[:n], eng.device)
        nsweep = ceil_div(n, w)
        for k0 in reversed(range(0, n, w)):
            _health.heartbeat("gels_ooc", nsweep - 1 - k0 // w, nsweep)
            if eng.caching:
                # the top n rows of the cached full-height panels
                Pk = eng.fetch("QR", k0 // w,
                               lambda k0=k0:
                               qr_p[:, k0:min(k0 + w, n)],
                               view=(0, n))
            else:
                Pk = eng.fetch("QR", k0 // w,
                               lambda k0=k0:
                               qr_p[:n, k0:min(k0 + w, n)],
                               cache=False)
            X = _lu_back_visit(X, Pk, k0)
        _health.heartbeat("gels_ooc", nsweep, nsweep)
        return (qr_p, taus), _host(X)
    finally:
        eng.finish()


# -- gemm --------------------------------------------------------------------

@instrument_driver("gemm_ooc")
def gemm_ooc(alpha, a: np.ndarray, b: np.ndarray, beta,
             c: np.ndarray,
             row_panel: Optional[int] = None,
             cache_budget_bytes=None, device=None) -> np.ndarray:
    """C = alpha A B + beta C with A and C streamed through the card in
    row panels and B resident there (the tall-A case). Host in, host
    out; C is neither read nor transferred when beta == 0. Each row
    panel is visited once, so the engine contributes the pipeline (A /
    C prefetch, C writeback) and the transfer accounting only."""
    a = np.asarray(a)
    m = a.shape[0]
    row_panel = _panel_cols(row_panel, m, a.dtype)
    eng = stream.engine_for(m, row_panel, a.dtype,
                            budget_bytes=cache_budget_bytes,
                            device=device)
    if beta != 0 and eng.prefetch_depth:
        # one step of lookahead is TWO panels here (A row + C row)
        eng.prefetch_depth *= 2
    out = np.empty_like(c)
    try:
        Bd = _h2d(np.asarray(b), eng.device) * alpha
        starts = list(range(0, m, row_panel))
        for i, r0 in enumerate(starts):
            _health.heartbeat("gemm_ooc", i, len(starts))
            r1 = min(r0 + row_panel, m)
            Ab = eng.fetch("Arow", i, lambda r0=r0, r1=r1: a[r0:r1],
                           cache=False)
            if beta == 0:
                blk = _gemm_block_overwrite(Ab, Bd)
            else:
                Cb = eng.fetch("Crow", i, lambda r0=r0, r1=r1: c[r0:r1],
                               cache=False)
                blk = _gemm_block(Ab, Bd, beta, Cb)
            if i + 1 < len(starts):
                p0 = starts[i + 1]
                p1 = min(p0 + row_panel, m)
                eng.prefetch("Arow", i + 1,
                             lambda p0=p0, p1=p1: a[p0:p1], cache=False)
                if beta != 0:
                    eng.prefetch("Crow", i + 1,
                                 lambda p0=p0, p1=p1: c[p0:p1],
                                 cache=False)
            eng.write("Cout", i, blk, out[r0:r1])
        _health.heartbeat("gemm_ooc", len(starts), len(starts))
        eng.wait_writes()
    finally:
        eng.finish()
    return out

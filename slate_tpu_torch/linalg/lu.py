"""LU family (counterpart of ``slate_tpu/linalg/lu.py``) on one device:
getrf / getrs / gesv with partial pivoting, the tournament-pivot
(CALU) getrf_tntpiv, the no-pivot getrf_nopiv / gesv_nopiv, the
inverse getri / getriOOP, the random butterfly solve gesv_rbt, the
band LU gbtrf / gbtrs / gbsv (the windowed algorithms of ``band.py``
on a narrow square band, getrf / getrs otherwise), and the
mixed-precision solves gesv_mixed / gesv_mixed_gmres.

Pivots are a flat int32 tensor of global row swap targets (LAPACK
ipiv convention, 0-based), as in the reference. ``getrf`` with Auto
takes the Tiled blocked form. On one device that is, for the dtypes
the library LU takes, the carry-the-trailing-matrix loop
(``_getrf_carry``), and for the others (bf16, the lo precision of
gesv_mixed) the pipelined lookahead-1 loop (``_getrf_pipelined``);
MethodLU.NoPiv and MethodLU.CALU run the unrolled loop with the no-pivot
panel and the tournament (linalg/ca.py). Panels go through
``_lu_panel``'s route arbitration: cold, the library LU
(``torch.linalg.lu_factor``) where the dtype allows, the rank-1 hand
kernel for bf16 panels on the card, else the fori loop; the recursive
hand kernel when the tune cache routes ``pallas_rec`` (tune.autotune
writes such entries where the kernel wins on the card).

Above LU_SCAN_THRESHOLD block steps on a square, the reference runs
a fixed-shape scan at a dividing width (an XLA program-size device);
the port runs the same loops at that width.

Under ``Option.Grid`` (a ``parallel.ProcessGrid``) every MethodLU route
runs the owner-computes grid loop ``_getrf_grid`` at the storage tile
size (the reference's ``_lu_nb`` on a grid), with the reference's grid
numerics: U12 by the diagonal block's inverse times the row block
(``_lu_u12``'s grid branch), the same products as its pipelined form.
getrs and gesv pass the grid on to the grid trsm.
gesv_rbt keeps the reference's resil sentinel: with
``resil.guard.enable_checks()`` a non-finite solution steps down to
partial-pivot gesv (rung ``rbt_to_getrf``); off by default.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.enums import Diag, MatrixType, Op, Side, Uplo
from ..core.exceptions import slate_assert
from ..core.methods import MethodFactor, MethodLU, MethodLUPanel
from ..core.options import Option, OptionsLike, get_option
from ..core.tiles import TiledMatrix, ceil_div, pad_diag_identity
from ..obs import events as _obs
from ..obs.events import instrument_driver
from ..ops import kernels as pk
from ..parallel.mesh import option_grid
from ..resil import guard as _rguard
from .blas3 import _store, trsm
from .blocked import assemble_packed, solve_triangular
from .info import lu_info


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        "%s is not ported to slate_tpu_torch yet (ROADMAP.md, queue 1)"
        % what)


class LUFactors(NamedTuple):
    """Packed L\\U factor (unit-lower L below the diagonal, U on and
    above) plus pivots and the LAPACK getrf info code."""
    LU: TiledMatrix
    pivots: torch.Tensor       # (min(m,n)_pad,) int32 global swap targets
    info: Optional[torch.Tensor] = None   # () int32
    #: True when produced by the windowed band gbtrf, whose L blocks
    #: are not permuted across blocks: solves go through gbtrs
    band: bool = False


# -- pivot machinery ------------------------------------------------------

def _compose_swaps(piv: torch.Tensor, m: int) -> torch.Tensor:
    """Turn a sequence of row swaps (j <-> piv[j]) into one permutation
    of range(m) (LAPACK laswp semantics; the port of XLA's
    lu_pivots_to_permutation)."""
    return pk.lu_pivots_to_permutation(piv, m)


def _permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Row gather. (The reference's bf16 detour works around a TPU
    compiler limit and has no counterpart here.)"""
    return x[perm]


def apply_pivots(pivots: torch.Tensor, B: TiledMatrix,
                 forward: bool = True) -> TiledMatrix:
    """Apply row swaps to B (reference internal::permuteRows): row j
    is swapped with row pivots[j], in order (reversed if not
    forward)."""
    r = B.resolve()
    mp = r.data.shape[0]
    if pivots.shape[0] > mp:
        # entries past B's rows are identity swaps: truncation is exact
        pivots = pivots[:mp]
    perm = _compose_swaps(pivots, mp)
    if not forward:
        perm = torch.argsort(perm)
    return dataclasses.replace(r, data=_permute_rows(r.data, perm))


# -- panel ----------------------------------------------------------------

#: (m, w, dtype) panels whose fori fallback was already surfaced: the
#: obs instant fires once per shape
_FORI_FALLBACK_SEEN: set = set()


def _surface_fori_fallback(m: int, w: int, dtype, device) -> None:
    """The first fori panel of each (m, w, dtype) publishes an obs
    instant carrying WHY the rank-1 kernel rejected it, so a trace of
    a slow getrf shows the panel route and its reason. With obs off the
    one-shot is not consumed."""
    key = (m, w, str(dtype))
    if key in _FORI_FALLBACK_SEEN:
        return
    from ..obs import events as obs
    if not obs.enabled():
        return
    _FORI_FALLBACK_SEEN.add(key)
    obs.instant("getrf.panel_fori_fallback", cat="kernel", m=m, w=w,
                dtype=str(dtype),
                reason=pk.lu_panel_reject_reason(m, w, dtype, device))


def _lu_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of a (m, w) panel: (packed LU, local pivot
    swap targets (w,) int32).

    Route arbitration (MethodLUPanel): a MEASURED tune-cache entry
    wins, validated against the hard gates; a cold cache resolves to
    the frozen chain: the library LU (torch.linalg.lu_factor) where
    the dtype allows, the rank-1 hand kernel (ops/kernels.lu_panel)
    where its gate takes the panel (bf16 on the card), else the fori
    loop. The pallas_rec route runs the hand-written recursive panel
    kernel (ops/kernels.lu_panel_rec).

    A cached kernel route whose gate rejects the panel (a bucket's
    entry speaks for panels of the probe's width; the driver's may be
    wider) takes the cold route of the panel, for ``pallas`` as for
    ``pallas_rec``. The reference demotes a rejected ``pallas`` to its
    fori loop; the cold route is the same partial pivoting, and for
    the library-LU types far faster (ROADMAP queue 3). The chain ends
    at the fori loop: a cold ``pallas`` that its gate rejects is not
    retried.

    With obs on, the panel is one ``lu::panel`` layer span, whatever
    its route."""
    sp = _obs.on and _obs.span_begin("lu::panel", "layer", a.device)
    m, w = a.shape
    method = MethodLUPanel.resolve(m, w, a.dtype, a.device)
    out = None
    if method is MethodLUPanel.PallasRec:
        out = pk.lu_panel_rec(a)
        if out is None:
            method = MethodLUPanel.cold_default(m, w, a.dtype, a.device)
    if out is None and method is MethodLUPanel.Pallas:
        out = pk.lu_panel(a)
        if out is None:
            method = MethodLUPanel.cold_default(m, w, a.dtype, a.device)
            if method is MethodLUPanel.Pallas:
                method = MethodLUPanel.Fori
    if out is None and method is MethodLUPanel.Native:
        out = _native_lu(a)
    elif out is None:
        _surface_fori_fallback(m, w, a.dtype, a.device)
        out = lu_panel_fori(a)
    if sp:
        _obs.span_end(sp)
    return out


def _native_lu(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.linalg.lu_factor_ex (no singularity check: info reports
    it) with its 1-based pivots turned into the 0-based swap targets
    the reference's native LU returns."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return lu, (piv - 1).to(torch.int32)


def lu_panel_fori(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-loop panel of an (m, w) panel or a (B, m, w) stack of
    them: per column, argmax pivot search (lowest row wins ties),
    two-row swap by gathers, safe divide, rank-1 update of the columns
    to the right — the pivot-sequence oracle of the recursive kernel
    and the batched getrf's panel. Nothing is read back to the host.
    Returns (packed, int32 swap targets (w,) or (B, w))."""
    batched = a.dim() == 3
    a = (a if batched else a[None]).clone()
    B, m, w = a.shape
    piv = torch.zeros((B, w), dtype=torch.int32, device=a.device)
    bi = torch.arange(B, device=a.device)
    for j in range(min(m, w)):
        p = j + torch.argmax(a[:, j:, j].abs(), dim=1)
        piv[:, j] = p.to(torch.int32)
        rowj = a[:, j].clone()
        a[:, j] = a[bi, p]
        a[bi, p] = rowj
        pivval = a[:, j, j]
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        mults = a[:, j + 1:, j] / safe[:, None]
        a[:, j + 1:, j] = mults
        a[:, j + 1:, j + 1:] -= mults[:, :, None] * a[:, j, None, j + 1:]
    return (a, piv) if batched else (a[0], piv[0])


def _nopiv_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU panel without pivoting (reference getrf_nopiv): the column
    loop of lu_panel_fori without the search and the swap. Returns
    (packed, zero swap targets (w,) int32)."""
    a = a.clone()
    m, w = a.shape
    for j in range(min(m, w)):
        pivval = a[j, j]
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        mults = a[j + 1:, j] / safe
        a[j + 1:, j] = mults
        a[j + 1:, j + 1:] -= mults[:, None] * a[j, None, j + 1:]
    return a, torch.zeros((w,), dtype=torch.int32, device=a.device)


def tnt_swaps_host(sel, mlen: int):
    """Convert an ordered pivot-row selection `sel` (indices relative to
    the live block, in selection order) into (piv, lperm): the LAPACK
    sequential swap targets relative to the live block, and the
    replay's final position -> pre-swap-row map (lperm[:len(sel)]
    recovers `sel`'s rows on top, in order). numpy, on the host, as the
    reference's twin of its device loop."""
    import numpy as np
    sel = np.asarray(sel, np.int64)
    w = sel.shape[0]
    cur_of_orig = np.arange(mlen)      # pre-swap row -> current pos
    orig_at_pos = np.arange(mlen)      # current pos -> pre-swap row
    piv = np.empty((w,), np.int64)
    for j, r in enumerate(sel):
        t = int(cur_of_orig[r])
        piv[j] = t
        oj, ot = orig_at_pos[j], orig_at_pos[t]
        orig_at_pos[j], orig_at_pos[t] = ot, oj
        cur_of_orig[ot], cur_of_orig[oj] = j, t
    return piv, orig_at_pos


def _tnt_swap_sequence(rows: torch.Tensor, m: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ordered pivot-row selection (w,) as the equivalent LAPACK
    swap targets (w,) int32 and the composed permutation (m,) int64 on
    rows' device (the reference's device loop, whose bookkeeping is the
    permutation). The w swaps are a sequential walk: it runs on the host
    (tnt_swaps_host) after one read of the selection a panel."""
    piv, perm = tnt_swaps_host(rows.cpu().numpy(), m)
    return (torch.as_tensor(piv, dtype=torch.int32, device=rows.device),
            torch.as_tensor(perm, dtype=torch.int64, device=rows.device))


# -- factorizations -------------------------------------------------------

def _getrf_carry(a: torch.Tensor, nb: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device blocked LU that carries the SHRINKING trailing
    matrix instead of updating the full matrix in place. Each step's
    panel is emitted in that step's row order; the suffix permutations
    of later steps are composed into one final gather per panel (the
    deferred laswp of the reference's getrf.cc). With obs on, each
    step's swaps and update and the final reorder are layer spans
    (``lu::swaps``, ``lu::update``, ``lu::reorder``)."""
    M, N = a.shape
    kmax = min(M, N)
    nt = ceil_div(kmax, nb)
    trail = a
    panels, urows, perms, pivs = [], [], [], []
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0
        lu, piv = _lu_panel(trail[:, :w])
        sp = _obs.on and _obs.span_begin("lu::swaps", "layer", a.device)
        perm = _compose_swaps(piv, trail.shape[0])
        pivs.append(k0 + piv)
        perms.append(perm)
        panels.append(lu)
        if k1 < N:
            rest = _permute_rows(trail[:, w:], perm)
        if sp:
            _obs.span_end(sp)
        if k1 < N:
            sp = _obs.on and _obs.span_begin("lu::update", "layer",
                                             a.device)
            u12 = _lu_u12(lu[:w, :w], rest[:w])
            urows.append(u12)
            trail = rest[w:] - lu[w:, :w] @ u12 if k1 < M else rest[w:]
            if sp:
                _obs.span_end(sp)
    # final row order per panel: panel k's rows get permuted by the
    # suffix action of perms[k+1:]
    sp = _obs.on and _obs.span_begin("lu::reorder", "layer", a.device)
    reordered = []
    for k in range(nt):
        q = torch.arange(panels[k].shape[0], device=a.device)
        for j in range(k + 1, nt):
            off = (j - k) * nb
            q = torch.cat([q[:off], q[off:][perms[j]]])
        reordered.append(_permute_rows(panels[k], q))
    out = assemble_packed(reordered, urows, nb, kmax, M, N, a.dtype)
    ipiv = torch.cat(pivs)
    if sp:
        _obs.span_end(sp)
    return out, ipiv


def _lu_u12(l11: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """U12 = L11^{-1} rhs with L11 the packed panel's diagonal block
    (strict lower + implicit unit diagonal): one direct solve (bf16
    solves in f32 and rounds, blocked.solve_triangular)."""
    return solve_triangular(l11, rhs, upper=False, unitriangular=True)


def _getrf_pipelined(a: torch.Tensor, nb: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Software-pipelined (lookahead-1) partial-pivot blocked LU
    (reference getrf.cc's lookahead split of the trailing gemm). Panel
    k+1 factors right after a NARROW update of its own column block;
    the WIDE remainder of step k's trailing update does not depend on
    that panel. Step-(k+1) row swaps of the non-panel columns are
    deferred to the next iteration's head, which is exactly when the
    plain loop would apply them, so the two orders compute identical
    results. Updates a copy of `a` in place (the reference's functional
    slice updates, same values). With obs on, step (1) is an
    ``lu::swaps`` layer span and each of (2) and (4) an ``lu::update``
    one."""
    M, N = a.shape
    kmax = min(M, N)
    nt = ceil_div(kmax, nb)
    a = a.clone()
    ipiv = torch.arange(kmax, dtype=torch.int32, device=a.device)
    # prologue: factor panel 0 (swaps to other columns deferred)
    k1 = min(nb, kmax)
    panel, piv = _lu_panel(a[:, :k1])
    a[:, :k1] = panel
    ipiv[:k1] = piv
    pend_piv, pend_k0 = piv, 0      # swaps not yet applied elsewhere
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        k2 = min(k1 + nb, kmax)
        # (1) apply the pending panel swaps to the non-panel columns
        sp = _obs.on and _obs.span_begin("lu::swaps", "layer", a.device)
        perm = _compose_swaps(pend_piv, M - pend_k0)
        if pend_k0 > 0:
            a[pend_k0:, :pend_k0] = _permute_rows(a[pend_k0:, :pend_k0],
                                                  perm)
        if k1 < N:
            a[pend_k0:, k1:] = _permute_rows(a[pend_k0:, k1:], perm)
        if sp:
            _obs.span_end(sp)
        if k1 >= N:
            break
        lkk = a[k0:k1, k0:k1]
        lcol = a[k1:, k0:k1]
        # (2) narrow: update the next panel's column block only
        if k2 > k1:
            sp = _obs.on and _obs.span_begin("lu::update", "layer",
                                             a.device)
            u12n = _lu_u12(lkk, a[k0:k1, k1:k2])
            a[k0:k1, k1:k2] = u12n
            a[k1:, k1:k2] -= lcol @ u12n
            if sp:
                _obs.span_end(sp)
            # (3) factor panel k+1 from it (critical path)
            panel, piv = _lu_panel(a[k1:, k1:k2])
            a[k1:, k1:k2] = panel
            ipiv[k1:k2] = k1 + piv
            pend_piv, pend_k0 = piv, k1
        # (4) wide trailing update, independent of the panel above
        if k2 < N:
            sp = _obs.on and _obs.span_begin("lu::update", "layer",
                                             a.device)
            u12w = _lu_u12(lkk, a[k0:k1, k2:])
            a[k0:k1, k2:] = u12w
            a[k1:, k2:] -= lcol @ u12w
            if sp:
                _obs.span_end(sp)
    return a, ipiv


def _getrf_grid(a: torch.Tensor, nb: int, grid, tiles: Tuple[int, int],
                pivot: bool = True, tournament: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked LU on a grid, owner-computes (parallel/owner.py), with the
    values of the reference's grid loops (_getrf_pipelined for partial
    pivoting, the unrolled loop for CALU and no pivoting). Per step k:

      1. the current panel column is gathered (a masked all_reduce);
      2. the owner of the diagonal element factors it (_lu_panel, the
         tournament and calu_factor_sorted, or the no-pivot loop),
         inverts its unit-lower diagonal block and broadcasts the panel,
         its swaps and the inverse;
      3. the <= 2 nb rows the swaps touch are gathered in the columns
         right of the panel, then every rank applies the swaps to them
         and to the finished L columns on its left (a row gather, the
         same on every rank);
      4. the owner computes U12 = L11^{-1} A12 (the reference's grid
         invert-then-matmul) and broadcasts it;
      5. each rank updates its own tiles of the trailing matrix.

    Every L column and U row reaches every rank in steps 2 and 4, so
    the packed result is the same on every rank. `tiles` is the
    storage (mb, nb), the unit of ownership; `nb` the blocking."""
    from ..parallel import owner as own
    from .blocked import invert_triangular
    M, N = a.shape
    kmax = min(M, N)
    nt = ceil_div(kmax, nb)
    a = a.clone()
    dev = a.device
    o = own.Owner(grid, (M, N), tiles[0], tiles[1], dev)
    ipiv = torch.arange(kmax, dtype=torch.int32, device=dev)
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        w = k1 - k0

        def factor(col):
            if pivot and tournament:
                from .ca import calu_factor_sorted, tournament_pivot_rows
                piv, perm = _tnt_swap_sequence(
                    tournament_pivot_rows(col), M - k0)
                panel = calu_factor_sorted(_permute_rows(col, perm))
            elif pivot:
                panel, piv = _lu_panel(col)
            else:
                panel, piv = _nopiv_panel(col)
            return panel, invert_triangular(panel[:w], lower=True,
                                            unit_diagonal=True), \
                piv.to(torch.int32)

        src = o.rank_of(k0, k0)
        panel, linv, piv = own.step(
            o, a, slice(k0, M), slice(k0, k1), factor,
            [((M - k0, w), a.dtype), ((w, w), a.dtype),
             ((w,), torch.int32)], src=src)
        a[k0:, k0:k1] = panel
        if pivot:
            ipiv[k0:k1] = k0 + piv
            perm = _compose_swaps(piv, M - k0)
            rows = k0 + torch.cat([torch.arange(w, device=dev),
                                   piv.long()])
        else:
            rows = torch.arange(k0, k1, device=dev)
        if k1 < N:
            a[rows, k1:] = own.gather_rows(o, a, rows, slice(k1, N))
        if pivot:
            srcs = k0 + perm[rows - k0]
            if k0 > 0:
                a[rows, :k0] = a[srcs, :k0]
            if k1 < N:
                a[rows, k1:] = a[srcs, k1:]
        if k1 >= N:
            continue
        (u12,) = own.publish(o, src, lambda: (linv @ a[k0:k1, k1:],),
                             [((w, N - k1), a.dtype)])
        a[k0:k1, k1:] = u12
        if k1 < M:
            own.update(o, a, k1, M, k1, N, panel[w:], u12)
    return a, ipiv


def _getrf_dense(a: torch.Tensor, nb: int, lookahead: int = 1,
                 tile_nb: Optional[int] = None, *, pivot: bool = True,
                 tournament: bool = False, grid=None,
                 tiles: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU on padded (M, N) dense; returns packed
    LU and global pivot swaps (length min(M, N); the identity without
    `pivot`). The branches of the reference on one device, in its
    order: the width cap to the rank-1 kernel for dtypes that take it,
    the scan form's width resolution (more than LU_SCAN_THRESHOLD steps
    on a square), the carry form (partial pivoting, library-LU dtypes),
    the pipelined form (partial pivoting, others, lookahead >= 1), and
    the unrolled loop, whose panel is the tournament's (`tournament`:
    CALU), the no-pivot column loop (no `pivot`) or _lu_panel. Under a
    grid, after the width resolution, the owner-computes _getrf_grid
    (`tiles`: the storage tiling)."""
    M, N = a.shape
    kmax = min(M, N)
    # the rank-1 kernel's width cap, resolved ONCE through the tune
    # arbitration (("lu_panel", "max_w")), so this planner and the
    # kernel's gate agree
    lu_max_w = pk._lu_max_w()
    pallas_capped = (pivot
                     and not MethodFactor.native_lu_dtype_ok(a.dtype)
                     and pk.lu_panel_eligible(min(M, 128),
                                              min(nb, lu_max_w), a.dtype,
                                              a.device)
                     # the reference's step-count limit (a TPU compile
                     # budget), kept so both packages block alike
                     and ceil_div(kmax, lu_max_w) <= 16)
    if pallas_capped:
        # cap the panel width at the rank-1 kernel's limit so each
        # panel is one dispatch. The gate is probed at a nominal SHORT
        # height: the kernel's height cap is per panel, so a tall first
        # panel must not stop the cap (tall panels fall to the fori
        # loop, where the narrow width bounds the sequential cost too)
        nb = min(nb, lu_max_w)
    nt = ceil_div(kmax, nb)
    if M == N and nt > LU_SCAN_THRESHOLD:
        # where the reference runs its fixed-shape scan form at a
        # dividing width, the loops below run at that width (the same
        # values in exact arithmetic; the scan only bounds XLA's program
        # size, which eager PyTorch does not need): nb itself when it
        # divides N, else the widest dividing blocking, the storage
        # tile where it divides N (and, for the rank-1 kernel's types,
        # fits its width cap at a multiple of 8). A width that would
        # leave the scan regime falls through with the caller's nb, as
        # the reference does.
        if N % nb == 0:
            w = nb
        else:
            w = _scan_nb(N, nb, 8)
            if tile_nb and N % tile_nb == 0 and \
                    (not pallas_capped or (tile_nb <= lu_max_w
                                           and tile_nb % 8 == 0)):
                w = max(w, tile_nb)
            if w < 8 or ceil_div(kmax, w) <= LU_SCAN_THRESHOLD:
                w = nb
        nb, nt = w, ceil_div(kmax, w)
    if grid is not None:
        # the width cap and the scan width came from this rank's tune
        # cache: grid rank 0's blocking runs on every rank
        from ..parallel.collectives import agree
        (nb,) = agree(grid, nb)
        return _getrf_grid(a, nb, grid, tiles or (nb, nb), pivot,
                           tournament)
    if pivot and not tournament and nt > 1 \
            and MethodFactor.native_lu_dtype_ok(a.dtype):
        # single-device fast path: carry-the-trailing-matrix form (the
        # reference caps nb at 256 above its TPU native-LU height
        # limit; native_lu_ok has no height limit here)
        return _getrf_carry(a, nb)
    if pivot and not tournament and lookahead >= 1 and nt > 1:
        return _getrf_pipelined(a, nb)
    ipiv = torch.arange(kmax, dtype=torch.int32, device=a.device)
    a = a.clone()
    for k in range(nt):
        k0, k1 = k * nb, min((k + 1) * nb, kmax)
        if pivot and tournament:
            # CALU: the tournament selects the pivot rows up front, then
            # the panel factors without further pivoting (reference
            # getrf_tntpiv.cc:169-222)
            from .ca import calu_factor_sorted, tournament_pivot_rows
            rows = tournament_pivot_rows(a[k0:, k0:k1])
            piv, perm = _tnt_swap_sequence(rows, M - k0)
            a[k0:] = _permute_rows(a[k0:], perm)
            a[k0:, k0:k1] = calu_factor_sorted(a[k0:, k0:k1])
            ipiv[k0:k1] = k0 + piv
        elif pivot:
            panel, piv = _lu_panel(a[k0:, k0:k1])
            a[k0:, k0:k1] = panel
            sp = _obs.on and _obs.span_begin("lu::swaps", "layer",
                                             a.device)
            perm = _compose_swaps(piv, M - k0)
            if k0 > 0:
                a[k0:, :k0] = _permute_rows(a[k0:, :k0], perm)
            if k1 < N:
                a[k0:, k1:] = _permute_rows(a[k0:, k1:], perm)
            ipiv[k0:k1] = k0 + piv
            if sp:
                _obs.span_end(sp)
        else:
            a[k0:, k0:k1] = _nopiv_panel(a[k0:, k0:k1])[0]
        if k1 < N:
            sp = _obs.on and _obs.span_begin("lu::update", "layer",
                                             a.device)
            u12 = _lu_u12(a[k0:k1, k0:k1], a[k0:k1, k1:])
            a[k0:k1, k1:] = u12
            if k1 < M:
                a[k1:, k1:] -= a[k1:, k0:k1] @ u12
            if sp:
                _obs.span_end(sp)
    return a, ipiv


#: block-step count above which the reference switches to its
#: fixed-shape scan form, run here as the loops at its width
LU_SCAN_THRESHOLD = 64


def _scan_nb(N: int, nb: int, mult: int = 1) -> int:
    """Largest divisor of N that is <= nb, preferring multiples of
    `mult` when one exists (the reference's scan blocking when no
    storage tile size serves). NOT a gcd: _scan_nb(96, 20) = 16."""
    fallback = 0
    for w in range(min(nb, N), 0, -1):
        if N % w == 0:
            if w % mult == 0:
                return w
            fallback = fallback or w
    return fallback or 1


def _prep(A: TiledMatrix) -> Tuple[TiledMatrix, torch.Tensor]:
    r = A.uniform().resolve()    # non-uniform tiles re-tile at entry
    if r.mtype is MatrixType.General:
        a = r.data
    else:
        d = A.to_dense()
        a = torch.nn.functional.pad(d, (0, r.data.shape[1] - r.n,
                                        0, r.data.shape[0] - r.m))
    return r, pad_diag_identity(a, r.m, r.n)


def _lu_nb(opts: OptionsLike, shape, grid=None, tile_nb: int = 0,
           dtype=None) -> int:
    """Algorithmic LU blocking. On a grid ALWAYS the storage tile size,
    the unit the 2D block-cyclic map distributes (reference _lu_nb,
    lu.py:667-680). On one device an explicit Option.BlockSize wins,
    then a measured tune-cache entry, then the reference's frozen
    n-scaled formula (a v5e measurement, kept so cold routing agrees
    with the reference)."""
    if grid is not None:
        return tile_nb
    n = min(shape)
    from ..tune.select import tuned_int
    nb_frozen = min(1024, max(512, n // 8))
    return tuned_int("getrf", "nb", nb_frozen, opts=opts,
                     option=Option.BlockSize, n=n,
                     dtype=dtype) or nb_frozen


@instrument_driver("getrf")
def getrf(A: TiledMatrix, opts: OptionsLike = None) -> LUFactors:
    """Partial-pivoting LU: P A = L U (reference src/getrf.cc:327;
    MethodLU routes PartialPiv, CALU and NoPiv)."""
    method = get_option(opts, Option.MethodLU, MethodLU.PartialPiv)
    if method is MethodLU.NoPiv:
        return getrf_nopiv(A, opts)
    if method is MethodLU.CALU:
        return getrf_tntpiv(A, opts)
    r, a = _prep(A)
    grid = option_grid(opts, "getrf")
    fmethod = get_option(opts, Option.MethodFactor, MethodFactor.Auto)
    if grid is not None:
        # the grid loop whatever the method: the reference's Fused is
        # one replicated XLA program, which a process grid does not have
        fmethod = MethodFactor.Tiled
    if fmethod is MethodFactor.Auto:
        from ..tune.select import tuned_method
        cached = tuned_method("getrf", "factor", opts=opts,
                              option=Option.MethodFactor,
                              n=min(a.shape), dtype=a.dtype)
        fmethod = cached if cached is not None \
            and cached is not MethodFactor.Auto else MethodFactor.Tiled
    if fmethod is MethodFactor.Fused \
            and not MethodFactor.native_lu_dtype_ok(a.dtype):
        import warnings
        warnings.warn(f"getrf: the library LU does not implement "
                      f"{a.dtype}; falling back to the Tiled blocked path",
                      stacklevel=2)
        fmethod = MethodFactor.Tiled
    if fmethod is MethodFactor.Fused:
        lu, ipiv = _native_lu(a)
    else:
        lu, ipiv = _getrf_dense(a, _lu_nb(opts, a.shape, grid,
                                          tile_nb=r.nb, dtype=a.dtype),
                                get_option(opts, Option.Lookahead),
                                tile_nb=r.nb, grid=grid,
                                tiles=(r.mb, r.nb))
    return LUFactors(dataclasses.replace(r, data=lu,
                                         mtype=MatrixType.General),
                     ipiv, lu_info(lu, r.m, r.n))


def _factors(r: TiledMatrix, lu: torch.Tensor, ipiv: torch.Tensor
             ) -> LUFactors:
    return LUFactors(dataclasses.replace(r, data=lu,
                                         mtype=MatrixType.General),
                     ipiv, lu_info(lu, r.m, r.n))


def getrf_nopiv(A: TiledMatrix, opts: OptionsLike = None) -> LUFactors:
    """LU without pivoting (reference src/getrf_nopiv.cc, slate.hh:608),
    blocked at A's tile size; the pivots are the identity."""
    r, a = _prep(A)
    lu, _ = _getrf_dense(a, r.nb, tile_nb=r.nb, pivot=False,
                         grid=option_grid(opts, "getrf_nopiv"),
                         tiles=(r.mb, r.nb))
    ipiv = torch.arange(min(a.shape), dtype=torch.int32, device=a.device)
    return _factors(r, lu, ipiv)


@instrument_driver("getrf_tntpiv")
def getrf_tntpiv(A: TiledMatrix, opts: OptionsLike = None) -> LUFactors:
    """Communication-avoiding tournament-pivot LU (reference
    src/getrf_tntpiv.cc:169-222), blocked at A's tile size: per panel,
    chunked local LUs nominate candidate pivot rows, a binary tournament
    (batched LU per round, linalg/ca.py) picks the winners, the winners
    are swapped to the top and the panel factors without further
    pivoting. Pivot growth is CALU's (bounded, weaker than partial
    pivoting: the documented trade)."""
    r, a = _prep(A)
    lu, ipiv = _getrf_dense(a, r.nb, tile_nb=r.nb, tournament=True,
                            grid=option_grid(opts, "getrf_tntpiv"),
                            tiles=(r.mb, r.nb))
    return _factors(r, lu, ipiv)


# -- solves ---------------------------------------------------------------

def getrs(F: LUFactors, B: TiledMatrix, opts: OptionsLike = None,
          trans=Op.NoTrans) -> TiledMatrix:
    """Solve using getrf factors (reference src/getrs.cc:88-111:
    permuteRows, trsm(L), trsm(U)). trans accepts an Op or a bool
    (True == ConjTrans). With obs on, a ``getrs`` layer span (the band
    factors' gbtrs aside)."""
    if not isinstance(trans, Op):
        slate_assert(trans in (True, False),
                     f"trans must be an Op or bool, got {trans!r}")
        trans = Op.ConjTrans if trans else Op.NoTrans
    if F.band:
        # band-convention factors (block-local swaps) need gbtrs's
        # interleaved sweeps
        return gbtrs(F, B, opts, trans=trans)
    sp = _obs.on and _obs.span_begin("getrs", "layer", F.LU.device)
    LU = F.LU
    L = dataclasses.replace(LU, mtype=MatrixType.Triangular,
                            uplo=Uplo.Lower, diag=Diag.Unit)
    U = dataclasses.replace(LU, mtype=MatrixType.Triangular,
                            uplo=Uplo.Upper, diag=Diag.NonUnit)
    if trans is Op.NoTrans:
        X = apply_pivots(F.pivots, B)
        X = trsm(Side.Left, 1.0, L, X, opts)
        X = trsm(Side.Left, 1.0, U, X, opts)
    else:
        flip = (lambda M: M.conj_transpose()) if trans is Op.ConjTrans \
            else (lambda M: M.transpose())
        X = trsm(Side.Left, 1.0, flip(U), B, opts)
        X = trsm(Side.Left, 1.0, flip(L), X, opts)
        X = apply_pivots(F.pivots, X, forward=False)
    if sp:
        _obs.span_end(sp)
    return X


@instrument_driver("gesv")
def gesv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None
         ) -> Tuple[LUFactors, TiledMatrix]:
    """Reference src/gesv.cc (slate.hh:507)."""
    from ..utils.trace import phases
    ph = phases(opts)
    with ph("gesv::getrf"):
        F = getrf(A, opts)
    with ph("gesv::getrs"):
        X = getrs(F, B, opts)
    return F, X


def gesv_nopiv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Reference slate.hh:516."""
    F = getrf_nopiv(A, opts)
    return F, getrs(F, B, opts)


def getri(F: LUFactors, opts: OptionsLike = None) -> TiledMatrix:
    """Matrix inverse from getrf factors (reference src/getri.cc,
    slate.hh:648): the solve against the identity, on the factors'
    device."""
    n = F.LU.m
    eye = TiledMatrix.from_dense(
        torch.eye(n, dtype=F.LU.dtype, device=F.LU.device), F.LU.mb,
        F.LU.nb, device=F.LU.device)
    return getrs(F, eye, opts)


def getriOOP(F: LUFactors, opts: OptionsLike = None) -> TiledMatrix:
    """Out-of-place inverse (reference getriOOP, slate.hh:654). The
    functional design is always out of place; kept for API parity."""
    return getri(F, opts)


# -- band LU --------------------------------------------------------------

def _use_band_path(A: TiledMatrix) -> bool:
    from .band import band_is_narrow, band_width_of
    r = A.resolve()
    # the windowed gbtrf takes a square matrix (identity-padded
    # windows); rectangular band inputs take the dense fallback
    return A.mtype is MatrixType.GeneralBand and r.kl >= 0 \
        and r.m == r.n and band_is_narrow(r.n, r.nb, band_width_of(r))


def gbtrf(A: TiledMatrix, opts: OptionsLike = None) -> LUFactors:
    """Band LU with partial pivoting (reference src/gbtrf.cc,
    slate.hh:594). A narrow square band runs the windowed
    O(n kl (kl + ku)) algorithm (``band.gbtrf_band``); pivoting grows
    the upper bandwidth to kl + ku (LAPACK gbtrf fill-in), and the
    factor's band tags are widened so. Its L blocks are not permuted
    across blocks (the gbtrf convention): solves go through gbtrs,
    which replays the blocked swap interleaving. Other inputs take
    getrf (a band input's factor keeps the widened tags)."""
    if _use_band_path(A):
        from .band import gbtrf_band
        r, a = _prep(A)
        lu, ipiv = gbtrf_band(a, r.n, r.nb, r.kl, r.ku)
        out = dataclasses.replace(r, data=lu, mtype=MatrixType.GeneralBand,
                                  kl=r.kl, ku=r.kl + r.ku)
        return LUFactors(out, ipiv, lu_info(lu, r.m, r.n), band=True)
    F = getrf(A, opts)
    if A.mtype is MatrixType.GeneralBand:
        lu = dataclasses.replace(F.LU, mtype=MatrixType.GeneralBand,
                                 kl=A.kl, ku=A.kl + A.ku)
        return LUFactors(lu, F.pivots, F.info)
    return F


def gbtrs(F: LUFactors, B: TiledMatrix, opts: OptionsLike = None,
          trans=Op.NoTrans) -> TiledMatrix:
    """Solve with gbtrf factors (reference slate.hh:622); trans as in
    getrs (an Op or a bool). Band factors take the interleaved blocked
    sweeps (LAPACK gbtrs): the forward swaps and L solve, then the U
    band backward solve, or for op(A) = A^T / A^H the U^op band solve,
    then the L^op sweep with its swaps undone; dense factors take
    getrs."""
    if not isinstance(trans, Op):
        slate_assert(trans in (True, False),
                     f"trans must be an Op or bool, got {trans!r}")
        trans = Op.ConjTrans if trans else Op.NoTrans
    if not F.band:
        return getrs(F, B, opts, trans=trans)
    from .band import (band_trsm_lower, band_trsm_upper,
                       gb_backward_solve_trans, gb_forward_solve)
    r = F.LU.resolve()
    lu_d = r.data
    b = B.to_dense()
    kband = r.ku          # widened to kl + ku by gbtrf
    if trans is Op.NoTrans:
        y = gb_forward_solve(lu_d, F.pivots, b, r.n, r.nb, r.kl)
        x = band_trsm_upper(lu_d, y, r.n, r.nb, kband)
    else:
        conj = trans is Op.ConjTrans
        y = band_trsm_lower(lu_d.mH if conj else lu_d.mT, b, r.n, r.nb,
                            kband)
        x = gb_backward_solve_trans(lu_d, F.pivots, y, r.n, r.nb, r.kl,
                                    conj)
    return _store(B, x)


def gbsv(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Band solve (reference slate.hh:499): gbtrf, then gbtrs. Returns
    (factors, X)."""
    F = gbtrf(A, opts)
    return F, gbtrs(F, B, opts)


# -- mixed precision ------------------------------------------------------

@instrument_driver("gesv_mixed")
def gesv_mixed(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None):
    """Mixed-precision LU with iterative refinement (reference
    src/gesv_mixed.cc:24-40): a lo-precision factor (f32 -> bf16,
    f64 -> f32), hi-precision residuals, and a full-precision solve as
    the fallback on non-convergence.

    Returns (factors_lo, X, iters); iters < 0 means the fallback
    full-precision solve produced X (reference info semantics)."""
    from .refine import iterative_refinement, lo_dtype, lo_rhs_solver
    r = A.resolve()
    lo = lo_dtype(r.dtype)
    A_lo = dataclasses.replace(r, data=r.data.to(lo))
    F = getrf(A_lo, opts)
    solve_lo = lo_rhs_solver(B, lo, lambda rhs: getrs(F, rhs, opts))

    def full_solve():
        return getrs(getrf(A, opts), B, opts).to_dense()

    x, iters = iterative_refinement(A, B, solve_lo, full_solve, opts)
    return F, _store(B, x), iters


@instrument_driver("gesv_mixed_gmres")
def gesv_mixed_gmres(A: TiledMatrix, B: TiledMatrix,
                     opts: OptionsLike = None):
    """Mixed-precision FGMRES-IR (reference src/gesv_mixed_gmres.cc:
    restarted FGMRES, restart = min(30, itermax, mb - 1),
    right-preconditioned by the lo-precision LU solve). One right-hand
    side, like the reference."""
    from .refine import fgmres_ir, lo_dtype, lo_rhs_solver
    r = A.resolve()
    slate_assert(B.shape[1] == 1,
                 "gesv_mixed_gmres supports one right-hand side "
                 "(reference gesv_mixed_gmres.cc nrhs==1 limitation)")
    lo = lo_dtype(r.dtype)
    A_lo = dataclasses.replace(r, data=r.data.to(lo))
    F = getrf(A_lo, opts)
    solve_lo = lo_rhs_solver(B, lo, lambda rhs: getrs(F, rhs, opts))

    def full_solve():
        return getrs(getrf(A, opts), B, opts).to_dense()

    x, iters = fgmres_ir(A, B, solve_lo, full_solve,
                         restart_cap=max(r.mb - 1, 1), opts=opts)
    return F, _store(B, x), iters


# -- random butterfly transform ------------------------------------------

def _butterfly_diag(generator: torch.Generator, n: int, depth: int,
                    dtype) -> list:
    """Random diagonals of a depth-d recursive butterfly (reference
    src/rbt_generate, internal_gerbt.cc): entries exp(r / 10),
    r ~ U(-0.5, 0.5), drawn from `generator` on its device."""
    dev = generator.device
    return [torch.exp(torch.rand((n,), generator=generator, device=dev,
                                 dtype=torch.float32) * 0.1 - 0.05
                      ).to(dtype)
            for _ in range(depth)]


def _apply_butterfly(diags, x: torch.Tensor, transpose: bool = False
                     ) -> torch.Tensor:
    """y = W x (or W^T x), W the depth-d recursive butterfly of
    `diags`. One level on a block [t; b] with half-diagonals
    R0 = diag(r_top), R1 = diag(r_bot), s = 1 / sqrt(2):
        W  [t; b] = s [R0 t + R1 b ; R0 t - R1 b]
        W^T[t; b] = s [R0 (t + b) ; R1 (t - b)]
    Levels compose W = W_1 W_2 ... W_d (level lvl acts on 2^lvl
    blocks); the transpose applies them in reverse order."""
    squeeze = x.dim() == 1
    y = x[:, None] if squeeze else x
    n = y.shape[0]
    s = torch.as_tensor(1.0 / 2.0 ** 0.5, dtype=y.dtype, device=y.device)
    levels = list(range(len(diags)))
    for lvl in (reversed(levels) if transpose else levels):
        r = torch.as_tensor(diags[lvl], dtype=y.dtype, device=y.device)
        nblk = 2 ** lvl
        blk = n // nblk
        half = blk // 2
        yb = y.reshape(nblk, blk, -1)
        rb = r.reshape(nblk, blk, 1)
        t, b = yb[:, :half], yb[:, half:]
        r0, r1 = rb[:, :half], rb[:, half:]
        if not transpose:
            top = r0 * t + r1 * b
            bot = r0 * t - r1 * b
        else:
            top = r0 * (t + b)
            bot = r1 * (t - b)
        y = (s * torch.cat([top, bot], dim=1)).reshape(n, -1)
    return y[:, 0] if squeeze else y


@instrument_driver("gesv_rbt")
def gesv_rbt(A: TiledMatrix, B: TiledMatrix, opts: OptionsLike = None,
             seed: int = 0, generator: Optional[torch.Generator] = None):
    """Random Butterfly Transform solver (reference src/gesv_rbt.cc,
    src/gerbt.cc): A' = W_u A W_v with random butterflies (depth
    Option.Depth, 2 unless given), LU *without pivoting* of A', then
    x = W_v y, and one step of iterative refinement, as the reference.
    The diagonals come from `generator` (a torch.Generator on A's
    device seeded with `seed` unless given), W_u's first."""
    depth = get_option(opts, Option.Depth, 2)
    r = A.resolve()
    n = r.m
    dev = r.device
    npad = ceil_div(n, 2 ** depth) * 2 ** depth
    a = torch.nn.functional.pad(A.to_dense(), (0, npad - n, 0, npad - n))
    a = a + torch.diag((torch.arange(npad, device=dev) >= n).to(a.dtype))
    rb = B.resolve()
    b = torch.nn.functional.pad(B.to_dense(), (0, 0, 0, npad - rb.m))
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    du = _butterfly_diag(generator, npad, depth, a.dtype)
    dv = _butterfly_diag(generator, npad, depth, a.dtype)
    # A' = W_u A W_v; then A x = b  <=>  A' y = W_u b with x = W_v y
    au = _apply_butterfly(du, a)
    av = _apply_butterfly(dv, au.T, transpose=True).T
    F = getrf_nopiv(TiledMatrix.from_dense(av, r.mb, r.nb, device=dev),
                    opts)

    def solve_rbt(rhs):
        bu = _apply_butterfly(du, rhs)
        Y = getrs(F, TiledMatrix.from_dense(bu, B.mb, B.nb, device=dev),
                  opts)
        return _apply_butterfly(dv, Y.to_dense())

    x = solve_rbt(b)
    x = x + solve_rbt(b - a @ x)        # one refinement step
    if _rguard.checks_enabled():
        # the resil ladder's sentinel rung: the no-pivot factor of A'
        # breaks down with small probability and shows as non-finite
        # entries in x; step down to partial-pivot gesv instead of
        # returning them (a host read, hence gated on enable_checks)
        try:
            _rguard.check_panel("gesv_rbt", 0, x)
        except _rguard.PanelHealthError as e:
            _rguard.record_escalation("rbt_to_getrf", op="gesv_rbt",
                                      reason=e.reason)
            return gesv(A, B, opts)
    return F, _store(B, x[:rb.m])

"""Hand-written Hopper kernels (counterpart of
``slate_tpu/ops/pallas_kernels.py``), with the ported entries only:
the block-recursive LU panel ``lu_panel_rec``, the trailing update
``_rank_update`` of its tall-panel split, the rank-1 LU panel
``lu_panel``, the swap composition ``lu_pivots_to_permutation`` (the
port of XLA's builtin of that name, which the reference calls between
panels, and over a batch between the ragged LU and its solves), the
Householder panel ``qr_panel``, the Cholesky block ``chol_panel``, the
lower-triangular inverse ``trtri_lower``, the batch layer's ragged
kernels ``ragged_potrf``, ``ragged_getrf`` and ``ragged_trsm`` (each
element of a (B, N, N) stack bounded by its own order from a device
``sizes`` vector), the Givens chain apply
``givens_chain_apply`` (the QR iterations' transform accumulation,
Z @ G streamed along each row), and the QR passes ``steqr_sweep`` /
``bdsqr_sweep`` (the port of the XLA scans the reference runs once a
pass in eig.steqr2_qr and svd.bdsqr_qr), with ``steqr_sweeps`` /
``bdsqr_sweeps``, up to a given number of passes in one launch of the
same kernel (the reference runs its passes in a while_loop on the
device).

Every kernel here has three parts side by side:

  * the CUDA C++ kernel, in ``csrc/`` (built by ``_build.py``);
  * a launch wrapper (``_lu_panel_rec_launch``, ``_rank_update``,
    ``_lu_panel_launch``, ``lu_pivots_to_permutation``,
    ``_qr_panel_launch``, ``_chol_panel_launch``,
    ``_trtri_lower_launch``, ``_ragged_potrf_launch``,
    ``_ragged_getrf_launch``, ``_ragged_trsm_launch``,
    ``_givens_chain_launch``, ``steqr_sweep`` / ``steqr_sweeps``,
    ``bdsqr_sweep`` / ``bdsqr_sweeps``) that launches the kernel for a
    CUDA tensor and adds one to its ``launches`` count there, and
    nowhere else (both entries of a sweep count on the one-pass
    entry's, their kernel); it raises
    on what the kernel does not
    take. There is no fall back: for a tensor on the CPU, and only
    then, it computes the kernel's plain version instead;
  * the plain PyTorch version (``panel_rec_plain``,
    ``rank_update_plain``, ``lu_panel_plain``, ``compose_swaps_plain``,
    ``qr_panel_plain``, ``chol_panel_plain``, ``trtri_lower_plain``,
    ``ragged_potrf_plain``, ``ragged_getrf_plain``,
    ``ragged_trsm_plain``, ``givens_chain_apply_plain``,
    ``steqr_sweep_plain`` / ``steqr_sweeps_plain``,
    ``bdsqr_sweep_plain`` / ``bdsqr_sweeps_plain``; the sweeps' plain
    versions walk the recurrence on the host in numpy scalars of the
    tensor's type, as ``compose_swaps_plain`` walks its swaps;
    ``compose_swaps_sorted_plain`` is the kernel's own composition on
    the host, for the tests),
    the same function with the same recursion, pivot tie-break and
    rounding, which the CPU tests hold against the JAX package and
    ``chip_smoke.py`` holds against the kernel on the card
    (``lu_panel_rec_plain`` is the whole public entry on plain parts).

The panel kernels take f32 and bf16 panels. Arithmetic is f32 and each
result is rounded to the panel type where the reference rounds it:
multipliers ``bf16(f32(col) / f32(safe))``, rank-1 updates
``bf16(x - bf16(mu * u))``, products accumulated in f32 and rounded
before the subtract. torch's bf16 elementwise ops already round after
each op, so the plain versions spell out only the f32 division and the
f32 products.

The ragged kernels take f32 and bf16 stacks on the card; on the CPU
their entries run the plain versions for any real float type, as the
reference's interpreter does (f64 computes in f64). The chain apply
and the sweeps take f32 on the card; their plain versions any real
float type (the sweeps f32 and f64).

ARBITRATION CONTRACT, as in the reference: each public panel entry has
an eligibility gate (``*_reject_reason`` / ``*_eligible``) and returns
``None`` when it rejects, so the caller keeps its fallback; it has a
tune op with a FROZEN row (``KERNEL_REGISTRY``). The gates use the
reference's numbers (LU_REC_*, LU_PANEL_*), so both packages route and
split panels at the same points.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _build

#: public kernel entry point -> (eligibility gate, tune-cache op)
KERNEL_REGISTRY = {
    "qr_panel": ("qr_panel_eligible", "qr_panel"),
    "lu_panel": ("lu_panel_eligible", "lu_panel"),
    "lu_panel_rec": ("lu_panel_rec_eligible", "lu_panel"),
    "trtri_lower": ("trtri_eligible", "trtri"),
    "chol_panel": ("chol_panel_eligible", "chol_panel"),
    "ragged_potrf": ("ragged_potrf_eligible", "ragged"),
    "ragged_getrf": ("ragged_getrf_eligible", "ragged"),
    "ragged_trsm": ("ragged_trsm_eligible", "ragged"),
    "givens_chain_apply": ("givens_chain_eligible", "steqr2"),
}

#: widest recursive panel (one dispatch OR the tall split)
LU_REC_MAX_W = 512
#: innermost base-case width (tune key ("lu_panel", "ib"))
LU_REC_IB = 32
#: single-dispatch budget in f32-equivalent panel ELEMENTS (m * w)
LU_REC_MAX_ELEMS = 8192 * 256

#: widest rank-1 panel (tune key ("lu_panel", "max_w"))
LU_PANEL_MAX_W = 256
#: tallest f32 rank-1 panel; bf16 halves it (methods.vmem_height_cap)
LU_PANEL_MAX_M = 8192

#: panel types the kernels take
PANEL_DTYPES = (torch.float32, torch.bfloat16)

#: reject reason of a tensor the kernels cannot take (the reference's
#: "platform")
NOT_CUDA = "tensor not on CUDA"


def _reject(kernel: str, reason: str, **args) -> None:
    """One obs instant for a rejected kernel dispatch (no-op with obs
    off)."""
    from ..obs import events as obs
    if obs.enabled():
        obs.instant("kernel.%s.reject" % kernel, cat="kernel",
                    reason=reason, **args)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


# -- permutations ----------------------------------------------------------

def _check_swaps(piv: torch.Tensor, m: int) -> None:
    """XLA's lu_pivots_to_permutation raises for more swaps than rows;
    so does the port, on every route."""
    if piv.shape[-1] > m:
        raise ValueError("%d swaps over %d rows: the permutation size has "
                         "to be at least the number of swaps"
                         % (piv.shape[-1], m))


def _walk_swaps(q: np.ndarray, row) -> None:
    """The swaps of one sequence applied to q in order, as XLA's loop
    applies them: a negative target counts from the end; a target still
    outside the rows reads the nearest row and is not written."""
    m = q.shape[0]
    for j, t in enumerate(row):
        t = t + m if t < 0 else t
        x = q[j]
        q[j] = q[min(max(t, 0), m - 1)]
        if 0 <= t < m:
            q[t] = x


def compose_swaps_plain(piv: torch.Tensor, m: int) -> torch.Tensor:
    """Plain version: the swaps composed on the host (numpy loop), per
    row of a (B, w) stack, with XLA's semantics for any target
    (``_walk_swaps``); int64 on piv's device, (m,) or (B, m)."""
    _check_swaps(piv, m)
    p = piv.detach().cpu().numpy().reshape(
        int(np.prod(piv.shape[:-1])), piv.shape[-1])
    perm = np.tile(np.arange(m), (p.shape[0], 1))
    for b, row in enumerate(p.tolist()):
        _walk_swaps(perm[b], row)
    return torch.as_tensor(perm.reshape(*piv.shape[:-1], m),
                           device=piv.device)


def compose_swaps_sorted_plain(piv: torch.Tensor, m: int) -> torch.Tensor:
    """The kernel's composition on the host, to test its algorithm
    against XLA's: for an LU sequence (piv[j] in [j, m)) the (target,
    step) pairs sorted, each step linked to the last earlier swap with
    its target and to the last earlier swap that targeted its own row,
    the links resolved by pointer jumping; any other sequence walked in
    order (``_walk_swaps``). The same result as compose_swaps_plain."""
    _check_swaps(piv, m)
    w = piv.shape[-1]
    rows = piv.detach().cpu().numpy().reshape(
        int(np.prod(piv.shape[:-1])), w).astype(np.int64)
    perm = np.tile(np.arange(m), (rows.shape[0], 1))
    steps = np.arange(w)
    for b, t in enumerate(rows if w else ()):
        if not (np.all(t >= steps) and np.all(t < m)):
            _walk_swaps(perm[b], t.tolist())
            continue
        order = np.lexsort((steps, t))
        ts, js = t[order], steps[order]
        same = np.r_[False, ts[1:] == ts[:-1]]
        last = np.r_[ts[1:] != ts[:-1], True]
        prev = np.where(same, np.r_[-1, js[:-1]], -1)
        # r[x]: the last swap before step x that targeted row x
        r = np.full(w, -1)
        own = js == ts
        r[ts[own]] = prev[own]
        lst = (ts < w) & ~own & last
        r[ts[lst]] = js[lst]
        r = np.where(r < 0, steps, r)
        while not np.array_equal(r[r], r):
            r = r[r]
        perm[b, js] = np.where(same, r[prev], ts)
        fin = (ts >= w) & last
        perm[b, ts[fin]] = r[js[fin]]
    return torch.as_tensor(perm.reshape(*piv.shape[:-1], m),
                           device=piv.device)


def lu_pivots_to_permutation(piv: torch.Tensor, m: int) -> torch.Tensor:
    """Compose the swap sequence (j <-> piv[j], in order) into one
    permutation of range(m), int64 on piv's device: the port of XLA's
    ``lu_pivots_to_permutation`` (which raises for more swaps than
    rows, as this does). ``piv`` is (w,) or a (B, w) stack, each row
    composed on its own ((B, m) out). A CUDA tensor goes through the
    ``compose_swaps`` kernel (one launch for the whole stack, no host
    synchronisation, counted); a CPU tensor through the plain
    version."""
    if piv.device.type != "cuda":
        return compose_swaps_plain(piv, m)
    _check_swaps(piv, m)
    if piv.dim() not in (1, 2):
        raise ValueError("compose_swaps kernel takes a (w,) or (B, w) "
                         "pivot stack, got %s" % (tuple(piv.shape),))
    lib = _build.load("compose_swaps")
    _build.set_device(lib, "compose_swaps", piv.get_device())
    piv = piv.to(torch.int32).contiguous()
    batch = piv.shape[0] if piv.dim() == 2 else 1
    perm = torch.empty(*piv.shape[:-1], m, dtype=torch.int64,
                       device=piv.device)
    if batch > 0 and m > 0:
        _build.check(lib.compose_swaps(piv.data_ptr(), batch,
                                       piv.shape[-1], m, perm.data_ptr(),
                                       _stream(piv)), "compose_swaps")
        lu_pivots_to_permutation.launches += 1
    return perm


lu_pivots_to_permutation.launches = 0


# -- eligibility -----------------------------------------------------------

def _rec_ib(w: int, ib: Optional[int]) -> int:
    """Base-case width: the caller's override or the tuned/frozen
    default, clamped to a power-of-two divisor of w (w = ib * 2^k)."""
    if ib is None:
        from ..tune.select import tuned_int
        ib = tuned_int("lu_panel", "ib", LU_REC_IB, n=w)
    ib = max(8, min(ib, w))
    while w % ib or (w // ib) & (w // ib - 1):
        ib //= 2
        if ib < 8:
            return 8
    return ib


def _rec_max_elems(dtype, max_elems: Optional[int]) -> int:
    from ..core.methods import vmem_height_cap
    return max_elems if max_elems is not None \
        else vmem_height_cap(LU_REC_MAX_ELEMS, dtype)


def _rec_shape_reason(m: int, w: int, dtype,
                      max_elems: Optional[int] = None,
                      ib: Optional[int] = None) -> Optional[str]:
    if w > LU_REC_MAX_W or w % 8 != 0:
        return "width"
    if m < w:
        return "aspect"
    if m % 128 != 0:
        return "align"
    if m * _rec_ib(w, ib) > _rec_max_elems(dtype, max_elems):
        return "height"
    return None


def lu_panel_rec_reject_reason(m: int, w: int, dtype, device=None,
                               max_elems: Optional[int] = None,
                               ib: Optional[int] = None) -> Optional[str]:
    """Why (m, w) will not factor through the recursive panel kernel
    (None == eligible): NOT_CUDA (the data is not on a CUDA device),
    'dtype' (not f32/bf16), then the reference's shape reasons
    'width', 'aspect', 'align', 'height'."""
    if not _on_cuda(device):
        return NOT_CUDA
    if dtype not in PANEL_DTYPES:
        return "dtype"
    return _rec_shape_reason(m, w, dtype, max_elems, ib)


def lu_panel_rec_eligible(m: int, w: int, dtype, device=None) -> bool:
    """ROUTING gate for the block-recursive panel."""
    return lu_panel_rec_reject_reason(m, w, dtype, device) is None


def _lu_max_w() -> int:
    """The rank-1 kernel's width cap (tune key ("lu_panel", "max_w"),
    FROZEN default LU_PANEL_MAX_W), resolved like every other knob."""
    from ..tune.select import tuned_int
    return tuned_int("lu_panel", "max_w", LU_PANEL_MAX_W)


def _lu_shape_ok(m: int, w: int, dtype) -> bool:
    from ..core.methods import vmem_height_cap
    return w <= _lu_max_w() and m <= vmem_height_cap(LU_PANEL_MAX_M, dtype) \
        and m % 128 == 0 and w % 8 == 0


def lu_panel_reject_reason(m: int, w: int, dtype, device=None
                           ) -> Optional[str]:
    """Why an (m, w) panel will NOT run as one rank-1 kernel (None ==
    eligible), in the reference's order: NOT_CUDA (its 'platform'),
    'dtype' (not f32/bf16), 'width' (> the tuned max_w), 'height'
    (above the itemsize-scaled cap: 8192 rows f32, 4096 bf16, the
    reference's numbers, so both packages route the same panels),
    'align' (m % 128 / w % 8)."""
    from ..core.methods import vmem_height_cap
    if not _on_cuda(device):
        return NOT_CUDA
    if dtype not in PANEL_DTYPES:
        return "dtype"
    if w > _lu_max_w():
        return "width"
    if m > vmem_height_cap(LU_PANEL_MAX_M, dtype):
        return "height"
    if m % 128 != 0 or w % 8 != 0:
        return "align"
    return None


def lu_panel_eligible(m: int, w: int, dtype, device=None) -> bool:
    """ROUTING gate for the rank-1 panel, shared by lu._lu_panel and
    the driver's panel-width cap."""
    return lu_panel_reject_reason(m, w, dtype, device) is None


# -- plain versions of the panel recurrences --------------------------------

def _ct(dtype) -> torch.dtype:
    """The kernels' arithmetic type: f32 for f32 and bf16 (the
    reference's promote(dtype, f32)); f64 stays f64 in the plain
    versions, as in the reference's interpreter."""
    return torch.promote_types(dtype, torch.float32)


def swap_gather(piv, c0: int, ncols: int) -> Tuple[list, list]:
    """The row swaps c0+jj <-> piv[c0+jj], jj < ncols, in order, as one
    gather: (dst, src) with row dst[i] taking the values row src[i]
    held before the swaps, for every row the swaps move (the segment's
    rows first, then the rows below it in the order of their first
    swap): the composition the base case kernel does after its last
    column for the columns outside the segment
    (csrc/lu_base_grid.cuh)."""
    content = {}

    def get(r):
        return content.get(r, r)

    below = []
    for jj in range(ncols):
        j, p = c0 + jj, int(piv[c0 + jj])
        if p == j:
            continue
        if p >= c0 + ncols and p not in content:
            below.append(p)
        content[j], content[p] = get(p), get(j)
    dst = [r for r in range(c0, c0 + ncols) if get(r) != r] \
        + [r for r in below if get(r) != r]
    return dst, [get(r) for r in dst]


def _segment_plain(out: torch.Tensor, piv: list, c0: int, e: int) -> None:
    """Columns [c0, e) of `out`, in place: per column the argmax pivot
    (``torch.argmax`` returns the first maximum, so the lowest row wins
    ties), the row swap within the segment, the f32 safe divide rounded
    to the panel type, and the rank-1 update confined to the segment;
    then the swaps of the columns outside the segment as one gather
    (swap_gather), as the kernel does (row swaps are exact, so when
    they happen changes no value)."""
    ct = _ct(out.dtype)
    ncols = max(0, min(e, out.shape[0]) - c0)
    for j in range(c0, c0 + ncols):
        p = j + int(torch.argmax(out[j:, j].to(ct).abs()))
        piv[j] = p
        if p != j:
            out[[j, p], c0:e] = out[[p, j], c0:e]
        pivval = out[j, j].to(ct)
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        mults = (out[j + 1:, j].to(ct) / safe).to(out.dtype)
        out[j + 1:, j] = mults
        out[j + 1:, j + 1:e] -= torch.outer(mults, out[j, j + 1:e])
    dst, src = swap_gather(piv, c0, ncols)
    if dst:
        off = [c for c in range(out.shape[1]) if c < c0 or c >= e]
        d, s_ = torch.tensor(dst), torch.tensor(src)
        out[d[:, None], off] = out[s_[:, None], off]


def _product(l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """L @ U accumulated in f32 (f64 for f64), rounded to the operands'
    type."""
    ct = _ct(l.dtype)
    return (l.to(ct) @ u.to(ct)).to(l.dtype)


# -- the recursion both versions share -------------------------------------

def _rec_drive(m: int, w: int, ib: int, base: Callable,
               leaf: Callable, mm: Callable) -> None:
    """The width recursion of the reference's kernel body: the left
    half factors recursively, the right half gets one triangular solve
    (itself halved down to an ib-row substitution) and one rank-w/2
    product update; only the ib-wide base case runs the per-column
    recurrence. base(c0, wseg), leaf(c0, ws, c1, c2) and
    mm(r0, r1, k0, k1, c0, c1) do the work."""
    def solve(c0, ws, c1, c2):
        if ws <= ib:
            leaf(c0, ws, c1, c2)
            return
        h = ws // 2
        solve(c0, h, c1, c2)
        mm(c0 + h, c0 + ws, c0, c0 + h, c1, c2)
        solve(c0 + h, ws - h, c1, c2)

    def rec(c0, wseg):
        if wseg <= ib:
            base(c0, wseg)
            return
        w1 = wseg // 2
        rec(c0, w1)
        solve(c0, w1, c0 + w1, c0 + wseg)
        mm(c0 + w1, m, c0, c0 + w1, c0 + w1, c0 + wseg)
        rec(c0 + w1, wseg - w1)

    rec(0, w)


def panel_rec_plain(a: torch.Tensor, ib: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ONE recursive panel dispatch, on any
    device: (packed LU, int32 swap targets), with the kernel's rounding
    (module doc)."""
    m, w = a.shape
    out = a.clone()
    piv = [0] * w

    def base(c0, wseg):
        _segment_plain(out, piv, c0, c0 + wseg)

    def leaf(c0, ws, c1, c2):
        for r in range(c0, c0 + ws):
            out[r + 1:c0 + ws, c1:c2] -= torch.outer(
                out[r + 1:c0 + ws, r], out[r, c1:c2])

    def mm(r0, r1, k0, k1, c0, c1):
        out[r0:r1, c0:c1] -= _product(out[r0:r1, k0:k1],
                                      out[k0:k1, c0:c1])

    _rec_drive(m, w, ib, base, leaf, mm)
    return out, torch.tensor(piv, dtype=torch.int32, device=a.device)


#: candidate slots of the base case's cooperative grid (BASE_MAX_BLOCKS
#: in csrc/lu_base.cuh)
_BASE_MAX_BLOCKS = 1024
#: the recursive panel's base case kernel (csrc/lu_base_grid.cuh): most
#: blocks (LG_MAX_BLOCKS), words of a candidate slot (LG_SLOT) and
#: widest segment (LG_WMAX)
_LG_MAX_BLOCKS, _LG_SLOT, _LG_WMAX = 160, 34, 32


def lu_grid_scratch_words(max_blocks: int) -> int:
    """int64 words of the base case's exchange (lu_base_grid.cuh
    lu_grid_scratch_words): a generation counter and its pad, then per
    column parity `max_blocks` candidate slots and row j's segment."""
    return 2 + 2 * (max_blocks * _LG_SLOT + _LG_WMAX)


def _panel_launch_setup(name: str, a: torch.Tensor):
    """What both panel kernels take: the library on a's device, the
    output (a contiguous copy of the panel, factored in place) and the
    int32 pivots. Raises on a panel the kernels do not take."""
    m, w = a.shape
    if a.dtype not in PANEL_DTYPES or w > LU_REC_MAX_W:
        raise ValueError("%s kernel takes an f32/bf16 (m, w) panel with "
                         "w <= %d, got %s %s" % (name, LU_REC_MAX_W,
                                                 tuple(a.shape), a.dtype))
    lib = _build.load(name)
    _build.set_device(lib, name, a.get_device())
    out = a.clone(memory_format=torch.contiguous_format)
    piv = torch.zeros(w, dtype=torch.int32, device=a.device)
    return lib, out, piv


def _lu_panel_rec_cuda(a: torch.Tensor, ib: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    m, w = a.shape
    if not (w <= m and ib >= 1):
        raise ValueError("lu_panel_rec kernel takes w <= m and ib >= 1, "
                         "got %s ib=%d" % (tuple(a.shape), ib))
    lib, out, piv = _panel_launch_setup("lu_panel_rec", a)
    # the wider segments' cooperative base case (csrc/lu_base.cuh
    # launch_lu_base): per-block pivot candidates and posted rows, one
    # grid-barrier counter
    scr_f = torch.empty(2 * _BASE_MAX_BLOCKS + 4 * w, dtype=torch.float32,
                        device=a.device)
    scr_i = torch.empty(1 + 2 * _BASE_MAX_BLOCKS, dtype=torch.int32,
                        device=a.device)
    blocks = min(_build.sm_count(a.get_device()), _LG_MAX_BLOCKS)
    # zeroed once a panel: the exchange's epochs start above every word
    scr_g = torch.zeros(lu_grid_scratch_words(blocks), dtype=torch.int64,
                        device=a.device)
    ptr, pptr, s = out.data_ptr(), piv.data_ptr(), _stream(a)
    bf16 = int(a.dtype == torch.bfloat16)

    def base(c0, wseg):
        _build.check(lib.lu_rec_base(ptr, pptr, m, w, c0, wseg,
                                     scr_f.data_ptr(), scr_i.data_ptr(),
                                     scr_g.data_ptr(), blocks, bf16, s),
                     "lu_rec_base")

    def leaf(c0, ws, c1, c2):
        _build.check(lib.lu_rec_solve_leaf(ptr, w, c0, ws, c1, c2, bf16, s),
                     "lu_rec_solve_leaf")

    def mm(r0, r1, k0, k1, c0, c1):
        _build.check(lib.lu_rec_mm_update(ptr, w, r0, r1, k0, k1, c0, c1,
                                          bf16, s), "lu_rec_mm_update")

    _rec_drive(m, w, ib, base, leaf, mm)
    return out, piv


def _lu_panel_rec_launch(a: torch.Tensor, ib: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE panel through the recursive kernel (the counterpart of one
    ``_lu_panel_rec_pallas`` dispatch): the CUDA kernels for a CUDA
    tensor, counted once per panel; the plain version for a CPU
    tensor."""
    if a.device.type != "cuda":
        return panel_rec_plain(a, ib)
    out = _lu_panel_rec_cuda(a, ib)
    _lu_panel_rec_launch.launches += 1
    return out


_lu_panel_rec_launch.launches = 0


# -- the trailing update of the tall split ---------------------------------

def rank_update_plain(a22: torch.Tensor, l21: torch.Tensor,
                      u12: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: A22 - L21 @ U12, the product accumulated
    in f32 and rounded to A22's type before the subtract."""
    return a22 - _product(l21, u12)


def _check_rank_update(a22: torch.Tensor, l21: torch.Tensor,
                       u12: torch.Tensor) -> None:
    """Raise unless the kernel takes the operands: (m2, w2), (m2, w1),
    (w1, w2) of one type, f32 or bf16, on one device."""
    m2, w2 = a22.shape
    w1 = l21.shape[1]
    if not (a22.dtype == l21.dtype == u12.dtype
            and a22.dtype in PANEL_DTYPES
            and l21.shape[0] == m2 and tuple(u12.shape) == (w1, w2)
            and l21.device == u12.device == a22.device):
        raise ValueError("rank_update kernel takes f32 or bf16 CUDA "
                         "(m2, w2), (m2, w1), (w1, w2) of one type; got "
                         "%s %s %s %s" % (tuple(a22.shape),
                                          tuple(l21.shape),
                                          tuple(u12.shape), a22.dtype))


def _rank_update(a22: torch.Tensor, l21: torch.Tensor,
                 u12: torch.Tensor) -> torch.Tensor:
    """A22 - L21 @ U12 through the CUDA kernel for CUDA tensors
    (counted), the plain version for CPU tensors. The reference
    launches its row-gridded kernel only when one of its row-block
    heights (2048 ... 128) divides m2, else an XLA matmul; the CUDA
    kernel masks its own edge, so the port launches it at every height
    (the same values in exact arithmetic)."""
    if a22.device.type != "cuda":
        return rank_update_plain(a22, l21, u12)
    _check_rank_update(a22, l21, u12)
    m2, w2 = a22.shape
    w1 = l21.shape[1]
    lib = _build.load("rank_update")
    _build.set_device(lib, "rank_update", a22.get_device())
    a22, l21, u12 = a22.contiguous(), l21.contiguous(), u12.contiguous()
    out = torch.empty_like(a22)
    bf16 = a22.dtype == torch.bfloat16
    # U12^T for the bf16 tensor-core path, whose B operand is K-major
    # (the kernel decides from the widths whether it takes that path)
    scratch = torch.empty((w2, w1), dtype=a22.dtype, device=a22.device) \
        if bf16 else None
    _build.check(lib.rank_update(a22.data_ptr(), l21.data_ptr(),
                                 u12.data_ptr(), out.data_ptr(), m2, w2, w1,
                                 int(bf16),
                                 None if scratch is None
                                 else scratch.data_ptr(),
                                 _stream(a22)), "rank_update")
    _rank_update.launches += 1
    return out


_rank_update.launches = 0


# -- the recursive panel's public entry ------------------------------------

def _lu_rec_split(a: torch.Tensor, ib: Optional[int], max_elems: int,
                  panel: Callable = None, update: Callable = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-level recursive halving for panels too tall for one
    dispatch: factor the left half, apply its composed permutation to
    the right half, solve U12, run the trailing update kernel, recurse
    on the right, then permute the left half's lower rows by the
    right's pivots. The pivot SEQUENCE equals factoring the whole
    panel column by column. `panel`/`update` default to the kernel
    wrappers; lu_panel_rec_plain passes the plain versions. Nothing
    here reads a device value on the host."""
    from ..linalg.blocked import solve_triangular
    panel = panel or _lu_panel_rec_launch
    update = update or _rank_update
    m, w = a.shape
    if m * w <= max_elems:
        return panel(a, _rec_ib(w, ib))
    w1 = w // 2
    left, piv1 = _lu_rec_split(a[:, :w1], ib, max_elems, panel, update)
    right = a[:, w1:][lu_pivots_to_permutation(piv1, m)]
    u12 = solve_triangular(left[:w1, :w1], right[:w1], upper=False,
                           unitriangular=True)
    a22 = update(right[w1:], left[w1:, :w1], u12)
    sub, piv2 = _lu_rec_split(a22, ib, max_elems, panel, update)
    perm2 = lu_pivots_to_permutation(piv2, m - w1)
    left = torch.cat([left[:w1], left[w1:][perm2]], dim=0)
    packed = torch.cat([left, torch.cat([u12, sub], dim=0)], dim=1)
    return packed, torch.cat([piv1, w1 + piv2])


def _runnable_on_cpu(reason: Optional[str], dtype, shape_ok: bool) -> bool:
    """A rejection the plain versions still serve: the tensor is on the
    CPU (the counterpart of the reference's interpret mode off-TPU) and
    the kernel would take its type and shape."""
    return reason == NOT_CUDA and dtype in PANEL_DTYPES and shape_ok


def lu_panel_rec(a: torch.Tensor, ib: Optional[int] = None,
                 max_elems: Optional[int] = None
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(packed, piv int32) partial-pivot LU panel via BLOCK RECURSION:
    one kernel dispatch when (m, w) fits the element budget, the
    host-level halving with the trailing-update kernel when taller.
    Returns None (with the reason as an obs instant) when the shape or
    dtype is ineligible. A CPU tensor of an eligible shape and type
    takes the plain versions. `ib` overrides the tuned base-case
    width, `max_elems` the single-dispatch budget."""
    m, w = a.shape
    reason = lu_panel_rec_reject_reason(m, w, a.dtype, a.device,
                                        max_elems, ib)
    if reason is not None and not _runnable_on_cpu(
            reason, a.dtype,
            _rec_shape_reason(m, w, a.dtype, max_elems, ib) is None):
        _reject("lu_panel_rec", reason, m=m, w=w, dtype=str(a.dtype))
        return None
    return _lu_rec_split(a, ib, _rec_max_elems(a.dtype, max_elems))


def lu_panel_rec_plain(a: torch.Tensor, ib: Optional[int] = None,
                       max_elems: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole public entry on plain parts (the split included), on
    any device: what lu_panel_rec computes, for holding the kernels
    against it on the card."""
    return _lu_rec_split(a, ib, _rec_max_elems(a.dtype, max_elems),
                         panel_rec_plain, rank_update_plain)


# -- the rank-1 panel --------------------------------------------------------

def lu_panel_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the rank-1 panel, on any device: the
    base-case recurrence over the whole width; (packed LU, int32 swap
    targets)."""
    out = a.clone()
    piv = [0] * a.shape[1]
    _segment_plain(out, piv, 0, a.shape[1])
    return out, torch.tensor(piv, dtype=torch.int32, device=a.device)


def lu_panel_segmented_plain(a: torch.Tensor, seg: int = _LG_WMAX
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """lu_panel_plain in the rank-1 kernel's order (csrc/lu_panel.cu):
    per segment of `seg` columns [c0, c0 + seg) up to the last column
    with a pivot row, the base case confined to the segment (its swaps
    gathered into every other column), then the segment's rank-1
    updates of the trailing columns, column by column. Every entry
    takes the recurrence's operations in its order, so the result is
    bitwise lu_panel_plain's for any `seg`."""
    m, w = a.shape
    out = a.clone()
    piv = [0] * w
    for c0 in range(0, min(m, w), seg):
        c1 = min(c0 + seg, w)
        _segment_plain(out, piv, c0, c1)
        for j in range(c0, min(c1, m)):
            out[j + 1:, c1:] -= torch.outer(out[j + 1:, j], out[j, c1:])
    return out, torch.tensor(piv, dtype=torch.int32, device=a.device)


def _lu_panel_launch(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE panel through the rank-1 kernel (the counterpart of one
    ``_lu_panel_pallas`` dispatch): the CUDA kernel for a CUDA tensor,
    counted; the plain version for a CPU tensor."""
    if a.device.type != "cuda":
        return lu_panel_plain(a)
    m, w = a.shape
    lib, out, piv = _panel_launch_setup("lu_panel", a)
    # the segments' exchange (csrc/lu_base_grid.cuh), zeroed by the
    # kernel's entry; its second scratch pointer is not read
    scr = torch.empty(lu_grid_scratch_words(_LG_MAX_BLOCKS),
                      dtype=torch.int64, device=a.device)
    _build.check(lib.lu_panel(out.data_ptr(), piv.data_ptr(), m, w,
                              scr.data_ptr(), None,
                              int(a.dtype == torch.bfloat16), _stream(a)),
                 "lu_panel")
    _lu_panel_launch.launches += 1
    return out, piv


_lu_panel_launch.launches = 0


def lu_panel(a: torch.Tensor
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(packed, piv int32) partial-pivot LU panel via the rank-1
    kernel; None, with the reason as an obs instant, when the gate
    rejects it (the caller falls back to the fori loop). A CPU tensor
    of a shape and type the kernel takes runs the plain version."""
    m, w = a.shape
    reason = lu_panel_reject_reason(m, w, a.dtype, a.device)
    if reason is not None and not _runnable_on_cpu(
            reason, a.dtype, _lu_shape_ok(m, w, a.dtype)):
        _reject("lu_panel", reason, m=m, w=w, dtype=str(a.dtype))
        return None
    return _lu_panel_launch(a)


# -- the Householder panel ----------------------------------------------------

#: widest QR panel of one dispatch (tune key ("qr_panel", "max_w"))
QR_PANEL_MAX_W = 128
#: tallest QR panel of one dispatch
QR_PANEL_MAX_M = 8192
#: the kernel's launch (csrc/qr_panel.cu): widest panel it takes, rows
#: a block, most blocks (each posts a partial vector that every block
#: reads, once a column)
_QR_KERNEL_MAX_W, _QR_BLOCK_ROWS, _QR_MAX_BLOCKS = 256, 32, 64


def qr_panel_blocks(m: int, sms: int) -> int:
    """Blocks of the qr_panel kernel over m rows on `sms` SMs: one for
    every _QR_BLOCK_ROWS rows, at most _QR_MAX_BLOCKS and one a SM (every
    block is resident: they poll each other's words)."""
    return max(1, min(-(-m // _QR_BLOCK_ROWS), _QR_MAX_BLOCKS, sms))


def qr_scratch_words(blocks: int, w: int) -> int:
    """int64 words of the qr_panel kernel's exchange: per column parity
    `blocks` partial vectors of w words, then row j."""
    return 2 * (blocks + 1) * w


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in x's type, as the kernels'
    sqrtf: through f64 (exact after one rounding), since torch's f32
    sqrt on the CPU may be an ulp off."""
    return torch.sqrt(x.double()).to(x.dtype)


def _qr_shape_ok(m: int, w: int) -> bool:
    from ..tune.select import tuned_int
    return w <= tuned_int("qr_panel", "max_w", QR_PANEL_MAX_W) \
        and m <= QR_PANEL_MAX_M and m % 128 == 0 and w % 8 == 0


def qr_panel_reject_reason(m: int, w: int, dtype, device=None
                           ) -> Optional[str]:
    """Why an (m, w) panel will NOT run as one qr_panel kernel (None ==
    eligible): NOT_CUDA (the reference's 'platform'), 'dtype' (not
    f32/bf16), 'shape' (the reference's caps: w <= the tuned max_w,
    m <= 8192, m % 128 == 0, w % 8 == 0)."""
    if not _on_cuda(device):
        return NOT_CUDA
    if dtype not in PANEL_DTYPES:
        return "dtype"
    if not _qr_shape_ok(m, w):
        return "shape"
    return None


def qr_panel_eligible(m: int, w: int, dtype, device=None) -> bool:
    """ROUTING gate for the Householder panel (qr._qr_panel consults it
    after the library geqrf, which takes no bf16)."""
    return qr_panel_reject_reason(m, w, dtype, device) is None


def qr_panel_plain(a: torch.Tensor, steps: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the Householder panel, on any device:
    (packed V\\R in a's type, taus f32), with the kernel's arithmetic
    (the reference's ``_qr_panel_pallas``): per column j the scalars in
    f32 (a zero column gives tau 0, a zero denominator is replaced by
    1), v = x / (alpha - beta) kept in f32, vta = v^T f32(panel), the
    update T(x - T((tau v) vta)), then T(v) below the diagonal and
    T(beta) on it. `steps` stops after that many columns: the columns
    from `steps` on are then the trailing panel as the updates left it
    (the state the next step starts from)."""
    m, w = a.shape
    out = a.clone()
    taus = torch.zeros(w, dtype=torch.float32, device=a.device)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    for j in range(min(m, w) if steps is None else steps):
        x = out[j:, j].to(torch.float32, copy=True)
        alpha = x[0]
        nrm2 = (x * x).sum()
        nrm = _sqrt(nrm2)
        beta = torch.where(alpha >= 0, -nrm, nrm)
        degenerate = nrm2 <= 0
        safe_beta = torch.where(degenerate, one, beta)
        tau = torch.where(degenerate, torch.zeros_like(one),
                          (beta - alpha) / safe_beta)
        denom = alpha - safe_beta
        denom = torch.where(denom == 0, one, denom)
        v = x / denom
        v[0] = 1.0
        vta = v @ out[j:, j + 1:].float()
        out[j:, j + 1:] -= ((tau * v)[:, None] * vta[None, :]).to(a.dtype)
        v[0] = beta
        out[j:, j] = v.to(a.dtype)
        taus[j] = tau
    return out, taus


def _qr_panel_launch(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE panel through the qr_panel kernel (the counterpart of one
    ``_qr_panel_pallas`` dispatch): the CUDA kernel for a CUDA tensor,
    counted; the plain version for a CPU tensor. Taus come back f32."""
    if a.device.type != "cuda":
        return qr_panel_plain(a)
    m, w = a.shape
    if a.dtype not in PANEL_DTYPES or not 0 < w <= min(m, _QR_KERNEL_MAX_W):
        raise ValueError("qr_panel kernel takes an f32/bf16 (m, w) panel "
                         "with 0 < w <= m and w <= %d, got %s %s"
                         % (_QR_KERNEL_MAX_W, tuple(a.shape), a.dtype))
    lib = _build.load("qr_panel")
    _build.set_device(lib, "qr_panel", a.get_device())
    out = a.clone(memory_format=torch.contiguous_format)
    taus = torch.empty(w, dtype=torch.float32, device=a.device)
    blocks = qr_panel_blocks(m, _build.sm_count(a.get_device()))
    # zeroed once a call: the exchange's epochs start above every word
    scr = torch.zeros(qr_scratch_words(blocks, w), dtype=torch.int64,
                      device=a.device)
    _build.check(lib.qr_panel(out.data_ptr(), taus.data_ptr(), m, w,
                              blocks, scr.data_ptr(),
                              int(a.dtype == torch.bfloat16), _stream(a)),
                 "qr_panel")
    _qr_panel_launch.launches += 1
    return out, taus


_qr_panel_launch.launches = 0


def qr_panel(a: torch.Tensor
             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(packed, taus in a's type) Householder panel via the qr_panel
    kernel; None, with the reason as an obs instant, when the gate
    rejects it (the caller falls back to the column loop). A CPU tensor
    of a shape and type the kernel takes runs the plain version."""
    m, w = a.shape
    reason = qr_panel_reject_reason(m, w, a.dtype, a.device)
    if reason is not None and not _runnable_on_cpu(reason, a.dtype,
                                                   _qr_shape_ok(m, w)):
        _reject("qr_panel", reason, m=m, w=w, dtype=str(a.dtype))
        return None
    packed, taus = _qr_panel_launch(a)
    return packed, taus.to(a.dtype)


# -- the Cholesky block and the triangular inverse --------------------------

#: stripe width of the Cholesky block kernel
_CHOL_BLK = 128
#: largest block factored in one dispatch (tune key
#: ("chol_panel", "fused_max"))
CHOL_FUSED_MAX = 1024
#: largest block inverted in one dispatch (tune key ("trtri",
#: "fused_max"))
TRTRI_FUSED_MAX = 512


def _chol_shape_ok(n: int) -> bool:
    from ..tune.select import tuned_int
    return n <= tuned_int("chol_panel", "fused_max", CHOL_FUSED_MAX) \
        and n % _CHOL_BLK == 0


def _trtri_shape_ok(n: int) -> bool:
    from ..tune.select import tuned_int
    return n <= tuned_int("trtri", "fused_max", TRTRI_FUSED_MAX) \
        and n % 128 == 0


def _f32_reason(shape_ok: bool, dtype, device) -> Optional[str]:
    if not _on_cuda(device):
        return NOT_CUDA
    if dtype != torch.float32:
        return "dtype"
    return None if shape_ok else "shape"


def chol_panel_eligible(n: int, dtype, device=None) -> bool:
    """ROUTING gate for the Cholesky block kernel: an f32 CUDA block of
    order n <= the tuned fused_max (1024), n % 128 == 0."""
    return _f32_reason(_chol_shape_ok(n), dtype, device) is None


def trtri_eligible(n: int, dtype, device=None) -> bool:
    """ROUTING gate for the triangular-inverse kernel: an f32 CUDA block
    of order n <= the tuned fused_max (512), n % 128 == 0."""
    return _f32_reason(_trtri_shape_ok(n), dtype, device) is None


def chol_panel_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Cholesky block, on any device, in
    the kernel's (and ``_chol_fused_pallas``'s) order: 128-wide stripes
    left to right, each taking the left-looking update
    A[k0:, stripe] - L[k0:, :k0] L[stripe, :k0]^T (products summed in
    f32), then the per-column recurrence inside it (d = sqrt(s_jj), a
    zero d divides by 1, the rank-1 update of the stripe's columns
    right of j). Only the lower triangle of `a` is read; the result has
    zeros above the diagonal."""
    n = a.shape[0]
    L = torch.zeros_like(a)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for k0 in range(0, n, _CHOL_BLK):
        k1 = min(k0 + _CHOL_BLK, n)
        S = a[k0:, k0:k1] - L[k0:, :k0] @ L[k0:k1, :k0].T
        for jj in range(k1 - k0):
            d = _sqrt(S[jj, jj])
            v = S[jj + 1:, jj] / torch.where(d == 0, one, d)
            S[jj, jj] = d
            S[jj + 1:, jj] = v
            S[jj + 1:, jj + 1:] -= torch.outer(v, v[:k1 - k0 - jj - 1])
        L[k0:, k0:k1] = S
        L[k0:k1, k0:k1] = torch.tril(S[:k1 - k0])
    return L


def _check_chol_block(a: torch.Tensor) -> None:
    """Raise unless the Cholesky kernel takes the block: f32 (n, n),
    n % 128 == 0."""
    n = a.shape[0]
    if a.dtype != torch.float32 or tuple(a.shape) != (n, n) \
            or n % _CHOL_BLK:
        raise ValueError("chol_panel kernel takes an f32 (n, n) block with "
                         "n %% %d == 0, got %s %s"
                         % (_CHOL_BLK, tuple(a.shape), a.dtype))


def _chol_panel_launch(a: torch.Tensor, serial: bool = False
                       ) -> torch.Tensor:
    """ONE block through the Cholesky kernel (the counterpart of one
    ``_chol_fused_pallas`` dispatch): the CUDA kernel for a CUDA
    tensor, counted; the plain version for a CPU tensor. serial=True
    launches the blocks of each stripe's solve and trailing update one
    at a time, in order: the same result, bitwise, if no block depends
    on when another starts."""
    if a.device.type != "cuda":
        return chol_panel_plain(a)
    _check_chol_block(a)
    n = a.shape[0]
    lib = _build.load("chol_panel")
    _build.set_device(lib, "chol_panel", a.get_device())
    work = a.clone(memory_format=torch.contiguous_format)
    out = torch.zeros_like(work)
    _build.check(lib.chol_panel(work.data_ptr(), out.data_ptr(), n,
                                int(serial), _stream(a)),
                 "chol_panel")
    _chol_panel_launch.launches += 1
    return out


_chol_panel_launch.launches = 0


def chol_panel(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of an SPD block: the Cholesky kernel where its
    gate takes the block, the plain version for an f32 CPU block of a
    shape it takes (the reference's interpret mode), else the library
    Cholesky (``blocked.chol_diag_factor``, the reference's XLA
    fallback). The upper triangle of the result is unspecified, as
    LAPACK's; only the lower triangle of `a` is read."""
    n = a.shape[0]
    reason = _f32_reason(_chol_shape_ok(n), a.dtype, a.device)
    if reason is None or (reason == NOT_CUDA and a.dtype == torch.float32
                          and _chol_shape_ok(n)):
        return _chol_panel_launch(a)
    _reject("chol_panel", reason, n=n, dtype=str(a.dtype))
    from ..linalg.blocked import chol_diag_factor
    return chol_diag_factor(a)


def trtri_lower_plain(a: torch.Tensor, unit_diagonal: bool = False
                      ) -> torch.Tensor:
    """Plain PyTorch version of the triangular inverse, on any device:
    forward substitution by rows, x_j = (e_j - L[j, :j] X[:j]) / L_jj
    (products summed in f32, a zero L_jj taken as 1, no divide with a
    unit diagonal), zeros above the diagonal (``_trtri_lower_pallas``)."""
    n = a.shape[0]
    X = torch.zeros_like(a)
    for j in range(n):
        xj = -(a[j, :j] @ X[:j])
        xj[j] += 1.0
        if not unit_diagonal:
            ljj = a[j, j]
            xj = xj / torch.where(ljj == 0, torch.ones_like(ljj), ljj)
        X[j] = xj
    return X


def _trtri_lower_launch(a: torch.Tensor, unit_diagonal: bool
                        ) -> torch.Tensor:
    """ONE block through the triangular-inverse kernel (the counterpart
    of one ``_trtri_lower_pallas`` dispatch): the CUDA kernel for a
    CUDA tensor, counted; the plain version for a CPU tensor."""
    if a.device.type != "cuda":
        return trtri_lower_plain(a, unit_diagonal)
    n = a.shape[0]
    if a.dtype != torch.float32 or tuple(a.shape) != (n, n) \
            or n > TRTRI_FUSED_MAX:
        raise ValueError("trtri_lower kernel takes an f32 (n, n) block with "
                         "n <= %d, got %s %s"
                         % (TRTRI_FUSED_MAX, tuple(a.shape), a.dtype))
    lib = _build.load("trtri_lower")
    _build.set_device(lib, "trtri_lower", a.get_device())
    a = a.contiguous()
    out = torch.zeros_like(a)
    _build.check(lib.trtri_lower(a.data_ptr(), out.data_ptr(), n,
                                 int(unit_diagonal), _stream(a)),
                 "trtri_lower")
    _trtri_lower_launch.launches += 1
    return out


_trtri_lower_launch.launches = 0


def trtri_lower(a: torch.Tensor, unit_diagonal: bool = False
                ) -> torch.Tensor:
    """Inverse of a lower-triangular block: the kernel where its gate
    takes the block, the plain version for an f32 CPU block of a shape
    it takes, else one library solve against the identity (the
    reference's XLA fallback)."""
    n = a.shape[0]
    reason = _f32_reason(_trtri_shape_ok(n), a.dtype, a.device)
    if reason is None or (reason == NOT_CUDA and a.dtype == torch.float32
                          and _trtri_shape_ok(n)):
        return _trtri_lower_launch(a, unit_diagonal)
    _reject("trtri_lower", reason, n=n, dtype=str(a.dtype))
    from ..linalg.blocked import solve_triangular
    return solve_triangular(a, torch.eye(n, dtype=a.dtype, device=a.device),
                            upper=False, unitriangular=unit_diagonal)


# -- the ragged batched kernels ---------------------------------------------

#: stripe / base-case width of the ragged kernels (tune key ("ragged",
#: "blk")); the queue's ragged ceiling is aligned to lcm(align, blk)
RAGGED_BLK = 32
#: widest stripe the CUDA ragged kernels take (one lane per column)
RAGGED_MAX_BLK = 32
#: largest ceiling the CUDA ragged kernels take: ragged_getrf's base
#: case keeps a stripe's rows in one 256-thread block's registers, at
#: most four rows a thread
RAGGED_MAX_N = 1024


def ragged_blk(blk: Optional[int] = None, opts=None) -> int:
    """The tuned/frozen ragged block width, clamped to a positive
    multiple of 8 (the reference's rule). ``opts`` threads the caller's
    tuning controls (Option.Tune etc.) into the cache read."""
    if blk is None:
        from ..tune.select import tuned_int
        blk = tuned_int("ragged", "blk", RAGGED_BLK, opts=opts)
    return max(8, (int(blk) // 8) * 8)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _ragged_dtype_ok(dtype, device) -> bool:
    """f32/bf16 on the card; any real float type on the CPU, where the
    entries run their plain versions (the reference's interpreter rule:
    arithmetic in promote(dtype, f32), so f64 batches factor at full
    precision)."""
    dtype = _torch_dtype(dtype)
    if _on_cuda(device):
        return dtype in PANEL_DTYPES
    return dtype.is_floating_point


def ragged_supported(dtype, device=None, n: Optional[int] = None) -> bool:
    """Submit-time routing gate of the queue's ragged strategy: can the
    ragged kernels take this dtype on `device` at all, and (given `n`)
    an order that fits the card's ceiling cap. Shape eligibility of the
    flush's ceiling is checked per dispatch by the ``ragged_*_eligible``
    gates; the queue builds the ceiling to pass them
    (bucket.ragged_ceiling)."""
    if not _ragged_dtype_ok(dtype, device):
        return False
    return n is None or not _on_cuda(device) or n <= RAGGED_MAX_N


def _ragged_reject_reason(n: int, dtype, blk: int, device
                          ) -> Optional[str]:
    """'dtype' (not f32/bf16 on the card, not a real float type on the
    CPU), then 'shape': the ceiling is not a positive multiple of blk,
    or on the card above RAGGED_MAX_N or blk above RAGGED_MAX_BLK."""
    if not _ragged_dtype_ok(dtype, device):
        return "dtype"
    if n < blk or n % blk:
        return "shape"
    if _on_cuda(device) and (n > RAGGED_MAX_N or blk > RAGGED_MAX_BLK):
        return "shape"
    return None


def ragged_potrf_eligible(n: int, dtype, blk: Optional[int] = None,
                          device=None) -> bool:
    """Eligibility gate of the ragged batched Cholesky: a dtype the
    device takes and a ceiling that is a positive multiple of the
    ragged block width (on the card also <= RAGGED_MAX_N)."""
    return _ragged_reject_reason(n, dtype, ragged_blk(blk), device) is None


def ragged_getrf_eligible(n: int, dtype, blk: Optional[int] = None,
                          device=None) -> bool:
    """Eligibility gate of the ragged batched LU (the potrf
    conditions)."""
    return _ragged_reject_reason(n, dtype, ragged_blk(blk), device) is None


def ragged_trsm_eligible(n: int, k: int, dtype, blk: Optional[int] = None,
                         device=None) -> bool:
    """Eligibility gate of the ragged batched triangular solve: the
    ceiling conditions plus at least one right-hand-side column."""
    return _ragged_reject_reason(n, dtype, ragged_blk(blk), device) is None \
        and k >= 1


def _sizes_list(sizes, n: int) -> list:
    """Per-element orders on the host, clamped to [0, n] as the kernels
    clamp them."""
    if isinstance(sizes, torch.Tensor):
        sizes = sizes.detach().cpu().tolist()
    return [min(max(int(s), 0), n) for s in np.asarray(sizes).reshape(-1)]


def ragged_potrf_plain(stack: torch.Tensor, sizes, blk: int
                       ) -> torch.Tensor:
    """Plain PyTorch version of the ragged Cholesky, on any device, in
    the kernel's order: per element of order s, blk-wide stripes of the
    live block, each taking the left-looking update
    S - T(L[k0:s, :k0] L[k0:k0+cw, :k0]^T) (products summed in the
    arithmetic type), then the column recurrence d = sqrt(s_jj) (d == 0
    divides by 1), v = T(s_j / d), s_rc = T(s_rc - T(v_r v_c)). The live
    block comes back lower-triangular, the pad as the identity; the pad
    of `stack` is never read."""
    B, N = stack.shape[0], stack.shape[-1]
    ct = _ct(stack.dtype)
    out = torch.eye(N, dtype=stack.dtype, device=stack.device) \
        .repeat(B, 1, 1)
    for b, s in enumerate(_sizes_list(sizes, N)):
        L = torch.zeros((s, s), dtype=stack.dtype, device=stack.device)
        for k0 in range(0, s, blk):
            cw = min(blk, s - k0)
            S = stack[b, k0:s, k0:k0 + cw].clone()
            if k0 > 0:
                S -= _product(L[k0:, :k0], L[k0:k0 + cw, :k0].T)
            for jj in range(cw):
                d = _sqrt(S[jj, jj].to(ct)).to(ct)
                dsafe = torch.where(d == 0, torch.ones_like(d), d)
                v = (S[jj + 1:, jj].to(ct) / dsafe).to(S.dtype)
                S[jj + 1:, jj] = v
                S[jj, jj] = d.to(S.dtype)
                S[jj + 1:, jj + 1:] -= torch.outer(v, v[:cw - jj - 1])
            L[k0:, k0:k0 + cw] = S
            L[k0:k0 + cw, k0:k0 + cw] = torch.tril(S[:cw])
        out[b, :s, :s] = L
    return out


def ragged_getrf_plain(stack: torch.Tensor, sizes, blk: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the ragged LU, on any device: per
    element of order s, blocks of blk columns over the live block, each
    the base case (argmax pivot, lowest row on ties, full-row swap, the
    safe divide rounded to the storage type, the rank-1 update confined
    to the block), the U12 row substitution T(x - T(l u)) and the
    trailing update T(x - T(L21 U12)). The pad comes back as the
    identity and its swap targets as identity swaps; the pad of `stack`
    is never read. Returns (packed, int32 swap targets (B, N))."""
    B, N = stack.shape[0], stack.shape[-1]
    out = torch.eye(N, dtype=stack.dtype, device=stack.device) \
        .repeat(B, 1, 1)
    piv = torch.arange(N, dtype=torch.int32).repeat(B, 1)
    for b, s in enumerate(_sizes_list(sizes, N)):
        O = stack[b, :s, :s].clone()
        p = list(range(s))
        for k0 in range(0, s, blk):
            k1 = min(k0 + blk, s)
            _segment_plain(O, p, k0, k1)
            for r in range(k0, k1):
                O[r + 1:k1, k1:] -= torch.outer(O[r + 1:k1, r], O[r, k1:])
            O[k1:, k1:] -= _product(O[k1:, k0:k1], O[k0:k1, k1:])
        out[b, :s, :s] = O
        piv[b, :s] = torch.tensor(p, dtype=torch.int32)
    return out, piv.to(stack.device)


def ragged_trsm_plain(packed: torch.Tensor, rhs: torch.Tensor, sizes,
                      blk: int, upper: bool = False, trans: bool = False,
                      unit: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the ragged triangular solve, on any
    device: per element of order s, blocks of blk rows in the order of
    the effective system (backward when upper != trans), each a row
    substitution x_r = T((x_r - w . x_solved) / d) over the block's
    solved rows (w a row of the packed factor, or its column r when
    trans; d = 1 with `unit`, a zero d divides by 1), then the update
    x_tgt = T(x_tgt - T(T_tgt,blk x_blk)) of the rows still to solve.
    Rows past s come back zero; the pads are never read."""
    B, N, K = rhs.shape
    ct = _ct(packed.dtype)
    back = upper != trans
    out = torch.zeros_like(rhs)
    for b, s in enumerate(_sizes_list(sizes, N)):
        t = packed[b, :s, :s].to(ct)
        x = rhs[b, :s].clone()
        nblk = -(-s // blk)
        for kbi in range(nblk):
            kb = nblk - 1 - kbi if back else kbi
            k0, k1 = kb * blk, min(kb * blk + blk, s)
            for r in (range(k1 - 1, k0 - 1, -1) if back
                      else range(k0, k1)):
                lo, hi = (r + 1, k1) if back else (k0, r)
                w = t[lo:hi, r] if trans else t[r, lo:hi]
                prod = w @ x[lo:hi].to(ct)
                d = torch.ones((), dtype=ct, device=t.device) if unit \
                    else t[r, r]
                d = torch.where(d == 0, torch.ones_like(d), d)
                x[r] = ((x[r].to(ct) - prod) / d).to(x.dtype)
            lo, hi = (0, k0) if back else (k1, s)
            tb = t[k0:k1, lo:hi].T if trans else t[lo:hi, k0:k1]
            x[lo:hi] -= (tb @ x[k0:k1].to(ct)).to(x.dtype)
        out[b, :s] = x
    return out


def _ragged_sizes(sizes, B: int, device) -> torch.Tensor:
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=device)
    if tuple(sizes.shape) != (B,):
        raise ValueError("ragged kernels take one size per element: got "
                         "%s sizes for a batch of %d"
                         % (tuple(sizes.shape), B))
    return sizes.contiguous()


def _ragged_setup(name: str, x: torch.Tensor, blk: int, donate: bool):
    """The library on x's device and the output: x itself when donated
    (and contiguous), else a new tensor. Raises on what the CUDA
    kernels do not take."""
    N = x.shape[1]
    if x.dtype not in PANEL_DTYPES or x.dim() != 3 or N > RAGGED_MAX_N \
            or not 8 <= blk <= RAGGED_MAX_BLK:
        raise ValueError("%s kernel takes an f32/bf16 (B, N, .) stack with "
                         "N <= %d and 8 <= blk <= %d, got %s %s blk=%d"
                         % (name, RAGGED_MAX_N, RAGGED_MAX_BLK,
                            tuple(x.shape), x.dtype, blk))
    lib = _build.load(name)
    _build.set_device(lib, name, x.get_device())
    out = x if donate and x.is_contiguous() else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    return lib, out


def _ragged_potrf_launch(stack: torch.Tensor, sizes: torch.Tensor,
                         blk: int, donate: bool) -> torch.Tensor:
    """ONE launch of the ragged Cholesky kernel (the counterpart of one
    ``_ragged_potrf_pallas`` dispatch) for a CUDA stack, counted; the
    plain version for a CPU stack."""
    if stack.device.type != "cuda":
        return ragged_potrf_plain(stack, sizes, blk)
    B, N = stack.shape[0], stack.shape[-1]
    if stack.shape[1] != N or N % 8 or blk % 8:
        raise ValueError("ragged_potrf kernel takes square elements of a "
                         "ceiling and blk that are multiples of 8, got %s "
                         "blk=%d" % (tuple(stack.shape), blk))
    lib, out = _ragged_setup("ragged_potrf", stack, blk, donate)
    a = stack.contiguous()
    _build.check(lib.ragged_potrf(a.data_ptr(), out.data_ptr(),
                                  sizes.data_ptr(), B, N, blk,
                                  int(stack.dtype == torch.bfloat16),
                                  _stream(stack)), "ragged_potrf")
    _ragged_potrf_launch.launches += 1
    return out


_ragged_potrf_launch.launches = 0


def _ragged_getrf_launch(stack: torch.Tensor, sizes: torch.Tensor,
                         blk: int, donate: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE launch of the ragged LU kernel (the counterpart of one
    ``_ragged_getrf_pallas`` dispatch) for a CUDA stack, counted; the
    plain version for a CPU stack."""
    if stack.device.type != "cuda":
        return ragged_getrf_plain(stack, sizes, blk)
    B, N = stack.shape[0], stack.shape[-1]
    if stack.shape[1] != N:
        raise ValueError("ragged_getrf kernel takes square elements, got "
                         "%s" % (tuple(stack.shape),))
    lib, out = _ragged_setup("ragged_getrf", stack, blk, donate)
    a = stack.contiguous()
    piv = torch.empty((B, N), dtype=torch.int32, device=stack.device)
    _build.check(lib.ragged_getrf(a.data_ptr(), out.data_ptr(),
                                  piv.data_ptr(), sizes.data_ptr(), B, N,
                                  blk, int(stack.dtype == torch.bfloat16),
                                  _stream(stack)), "ragged_getrf")
    _ragged_getrf_launch.launches += 1
    return out, piv


_ragged_getrf_launch.launches = 0


def _ragged_trsm_launch(packed: torch.Tensor, rhs: torch.Tensor,
                        sizes: torch.Tensor, blk: int, upper: bool,
                        trans: bool, unit: bool, donate: bool
                        ) -> torch.Tensor:
    """ONE launch of the ragged triangular-solve kernel (the counterpart
    of one ``_ragged_trsm_pallas`` dispatch) for CUDA tensors, counted;
    the plain version for CPU tensors."""
    if packed.device.type != "cuda":
        return ragged_trsm_plain(packed, rhs, sizes, blk, upper, trans,
                                 unit)
    B, N, K = rhs.shape
    if tuple(packed.shape) != (B, N, N) or packed.dtype != rhs.dtype \
            or packed.device != rhs.device:
        raise ValueError("ragged_trsm kernel takes (B, N, N) factors and a "
                         "(B, N, K) rhs of one type on one device, got %s "
                         "%s, %s %s" % (tuple(packed.shape), packed.dtype,
                                        tuple(rhs.shape), rhs.dtype))
    lib, out = _ragged_setup("ragged_trsm", rhs, blk, donate)
    t, b = packed.contiguous(), rhs.contiguous()
    _build.check(lib.ragged_trsm(t.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 sizes.data_ptr(), B, N, K, blk, int(upper),
                                 int(trans), int(unit),
                                 int(rhs.dtype == torch.bfloat16),
                                 _stream(rhs)), "ragged_trsm")
    _ragged_trsm_launch.launches += 1
    return out


_ragged_trsm_launch.launches = 0


def ragged_potrf(stack: torch.Tensor, sizes, blk: Optional[int] = None,
                 donate: bool = False) -> Optional[torch.Tensor]:
    """Ragged batched lower Cholesky of a (B, N, N) stack with
    per-element orders ``sizes`` (int32, read by the kernel on the
    device). Element i's [:sizes[i], :sizes[i]] block is its factor;
    the pad comes back as the identity. ``donate=True`` lets the kernel
    factor in the caller's stack. Returns None (the reason as an obs
    instant) when ineligible: the caller keeps the bucket strategy."""
    B, N = stack.shape[0], stack.shape[-1]
    b = ragged_blk(blk)
    reason = _ragged_reject_reason(N, stack.dtype, b, stack.device)
    if reason is not None:
        _reject("ragged_potrf", reason, n=N, dtype=str(stack.dtype))
        return None
    return _ragged_potrf_launch(stack, _ragged_sizes(sizes, B, stack.device),
                                b, donate)


def ragged_getrf(stack: torch.Tensor, sizes, blk: Optional[int] = None,
                 donate: bool = False
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Ragged batched partial-pivot LU of a (B, N, N) stack with
    per-element orders ``sizes``. Returns (packed L\\U stack, int32
    LAPACK swap targets (B, N), identity past each element's order), or
    None when ineligible (reason published; the caller keeps the bucket
    strategy). The kernel writes the swap targets as int32 directly
    (the reference's f32 pivot row exists for its TPU compiler).
    ``donate`` as ragged_potrf."""
    B, N = stack.shape[0], stack.shape[-1]
    b = ragged_blk(blk)
    reason = _ragged_reject_reason(N, stack.dtype, b, stack.device)
    if reason is not None:
        _reject("ragged_getrf", reason, n=N, dtype=str(stack.dtype))
        return None
    return _ragged_getrf_launch(stack, _ragged_sizes(sizes, B, stack.device),
                                b, donate)


def ragged_trsm(packed: torch.Tensor, rhs: Optional[torch.Tensor], sizes,
                upper: bool = False, trans: bool = False,
                unit: bool = False, blk: Optional[int] = None,
                donate: bool = False) -> Optional[torch.Tensor]:
    """Ragged batched triangular solve of (B, N, N) factors against a
    (B, N, K) right-hand-side stack with per-element orders ``sizes``:
    the `upper`-designated triangle of each packed element (`trans`:
    transposed, `unit`: unit diagonal) solves its live (s, K) block;
    rows past s come back zero. ``donate=True`` lets the kernel write
    the solution into the rhs (the factors are never written: the
    posv/gesv compositions reuse them). Returns None when ineligible
    (reason published; the caller keeps the bucket strategy)."""
    if rhs is None:
        return None
    B, N = packed.shape[0], packed.shape[-1]
    K = rhs.shape[-1]
    b = ragged_blk(blk)
    reason = _ragged_reject_reason(N, packed.dtype, b, packed.device)
    if reason is not None or K < 1:
        _reject("ragged_trsm", reason or "shape", n=N, k=K,
                dtype=str(packed.dtype))
        return None
    return _ragged_trsm_launch(packed, rhs,
                               _ragged_sizes(sizes, B, packed.device), b,
                               bool(upper), bool(trans), bool(unit), donate)


# -- the Givens chain apply (steqr2 / bdsqr transform accumulation) --------

#: rotation-group width b of the reference's window factors (tune key
#: ("steqr2", "chain_blk")); the gate keeps the reference's shape rule
GIVENS_CHAIN_BLK = 128
#: the reference's VMEM budget of one gridded step (its `_chain_rb`
#: rule), kept so both packages route the same shapes
_CHAIN_VMEM_BUDGET = 12 << 20


def _chain_anchor(j: int, n: int, blk: int) -> int:
    """Window anchor of rotation group j: b-spaced, clamped so the last
    (2b)-wide window stays inside [0, n)."""
    return min(j * blk, n - 2 * blk)


def givens_chain_factors(cs: torch.Tensor, sn: torch.Tensor, n: int,
                         blk: int, dtype=None) -> torch.Tensor:
    """The sweep's rotation chain as (n/blk, 2*blk, 2*blk) banded block
    factors: group j holds rotations [j*blk, min((j+1)*blk, n-1)),
    identity-padded inside the 2*blk window at its anchor. Embedded at
    their anchors and multiplied in group order they reproduce
    ``svd._givens_chain_matrix`` (the reference's factor layout; the
    CUDA kernel streams the chain and does not use them). Built on
    cs's device by one batched compose, with no loop over groups."""
    from ..linalg.svd import _givens_chain_matrix
    dtype = dtype or cs.dtype
    dev = cs.device
    j = torch.arange(n // blk, device=dev)[:, None]
    k = torch.clamp(j * blk, max=n - 2 * blk) \
        + torch.arange(2 * blk - 1, device=dev)[None, :]
    inside = (k >= j * blk) & (k < torch.clamp((j + 1) * blk, max=n - 1))
    kk = torch.clamp(k, max=n - 2)
    cw = torch.where(inside, cs.to(dtype)[kk],
                     torch.ones((), dtype=dtype, device=dev))
    sw = torch.where(inside, sn.to(dtype)[kk],
                     torch.zeros((), dtype=dtype, device=dev))
    return _givens_chain_matrix(cw, sw, 2 * blk, dtype)


def _chain_blk(blk: Optional[int]) -> int:
    if blk is not None:
        return blk
    from ..tune.select import tuned_int
    return tuned_int("steqr2", "chain_blk", GIVENS_CHAIN_BLK)


def _chain_rb(rows: int, n: int, blk: int) -> Optional[int]:
    """The reference's row-block height of its gridded apply (largest
    divisor of `rows` whose step fits its VMEM budget beside the
    factor stack), or None. The CUDA kernel does not use it; the gate
    does, so both packages take the same shapes."""
    facs_bytes = 16 * n * blk
    if facs_bytes >= _CHAIN_VMEM_BUDGET:
        return None
    for rb in (512, 256, 128, 64, 32, 16, 8):
        if rows % rb == 0 \
                and 2 * rb * n * 4 + facs_bytes <= _CHAIN_VMEM_BUDGET:
            return rb
    return None


def _chain_shape_ok(rows: int, n: int, blk: int) -> bool:
    return n % blk == 0 and n >= 2 * blk \
        and rows % 8 == 0 and _chain_rb(rows, n, blk) is not None


def givens_chain_eligible(rows: int, n: int, dtype,
                          blk: Optional[int] = None, device=None) -> bool:
    """ROUTING gate of the chain apply (eig.steqr2_qr / svd.bdsqr_qr
    consult it when the tune cache routes 'pallas_rec'): the
    reference's shape rule (n a multiple of the block width with at
    least two windows, rows % 8 == 0, its row-block budget), then the
    type: f32 on the card (the kernel's), any real float type on the
    CPU, where the plain version serves (the counterpart of the
    reference's interpreter)."""
    if not _chain_shape_ok(rows, n, _chain_blk(blk)):
        return False
    if _on_cuda(device):
        return dtype == torch.float32
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def givens_chain_apply_plain(Z: torch.Tensor, cs: torch.Tensor,
                             sn: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on any device: Z @ G for G the composed
    chain of the n-1 adjacent rotations (cs, sn), streamed along each
    row with one carry (t = z_0; out_k = c_k t + s_k z_{k+1},
    t = -s_k t + c_k z_{k+1}; out_{n-1} = t), each product and sum
    rounded in Z's type, in the kernel's order."""
    n = Z.shape[-1]
    cs, sn = cs.to(Z.dtype), sn.to(Z.dtype)
    out = torch.empty_like(Z)
    t = Z[..., 0]
    for k in range(n - 1):
        z = Z[..., k + 1]
        out[..., k] = cs[k] * t + sn[k] * z
        t = (-sn[k]) * t + cs[k] * z
    out[..., n - 1] = t
    return out


def chain_rows_per_block(rows: int, sms: int) -> int:
    """Rows a block of the chain kernel takes (one warp, one lane a
    row): the most of 32, 16 and 8 whose blocks still cover three
    quarters of the `sms` SMs, else 8, so the band's loads spread over
    the card (2048 rows on 132 SMs: 16, 128 blocks; 512 rows: 8)."""
    for rb in (32, 16):
        if -(-rows // rb) * 4 >= 3 * sms:
            return rb
    return 8


def _chain_operand(Z: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Z as the kernel's tensor maps take it, and whether its columns
    are the contiguous axis: one unit stride, the other a multiple of 4
    elements, 16-byte aligned; otherwise a row-major copy padded to
    such a stride."""
    rows, n = Z.shape
    aligned = Z.data_ptr() % 16 == 0
    if aligned and Z.stride(1) == 1 and Z.stride(0) % 4 == 0:
        return Z, True
    if aligned and Z.stride(0) == 1 and Z.stride(1) % 4 == 0:
        return Z, False
    pad = torch.empty((rows, -(-n // 4) * 4), dtype=Z.dtype,
                      device=Z.device)[:, :n]
    pad.copy_(Z)
    return pad, True


def _chain_out(Z: torch.Tensor, kmaj: bool) -> torch.Tensor:
    """An output of Z's shape and orientation whose leading stride is a
    multiple of 4 elements."""
    rows, n = Z.shape
    if kmaj:
        return torch.empty((rows, -(-n // 4) * 4), dtype=Z.dtype,
                           device=Z.device)[:, :n]
    return torch.empty((n, -(-rows // 4) * 4), dtype=Z.dtype,
                       device=Z.device)[:, :rows].T


def _rotations(v: torch.Tensor, device) -> torch.Tensor:
    """A rotation vector as the kernel's 1D tensor map takes it: f32,
    contiguous, 16-byte aligned, on `device`."""
    v = v.to(device=device, dtype=torch.float32).contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _givens_chain_launch(Z: torch.Tensor, cs: torch.Tensor,
                         sn: torch.Tensor) -> torch.Tensor:
    """Z @ G through the CUDA kernel for a CUDA tensor (counted), the
    plain version for a CPU tensor. Z may be a transposed view (bdsqr
    applies its right chain to Gvh^T): the kernel takes strides and
    writes an output of the same orientation, so no copy is made."""
    if Z.device.type != "cuda":
        return givens_chain_apply_plain(Z, cs, sn)
    rows, n = Z.shape
    if Z.dtype != torch.float32 or n < 1 or cs.shape[0] < n - 1 \
            or sn.shape[0] < n - 1:
        raise ValueError("givens_chain kernel takes an f32 (rows, n) Z "
                         "and n-1 rotations, got %s %s and %s"
                         % (tuple(Z.shape), Z.dtype, tuple(cs.shape)))
    Z, kmaj = _chain_operand(Z)
    out = _chain_out(Z, kmaj)
    cs, sn = _rotations(cs, Z.device), _rotations(sn, Z.device)
    lib = _build.load("givens_chain")
    dev = Z.get_device()
    _build.set_device(lib, "givens_chain", dev)
    _build.check(lib.givens_chain(
        Z.data_ptr(), Z.stride(0), Z.stride(1), out.data_ptr(),
        out.stride(0), out.stride(1), cs.data_ptr(), sn.data_ptr(), rows, n,
        chain_rows_per_block(rows, _build.sm_count(dev)), _stream(Z)),
        "givens_chain")
    _givens_chain_launch.launches += 1
    return out


_givens_chain_launch.launches = 0


def givens_chain_apply(Z: torch.Tensor, cs: torch.Tensor, sn: torch.Tensor,
                       blk: Optional[int] = None) -> Optional[torch.Tensor]:
    """Z @ G for G the composed Givens chain of (cs, sn) (equal to
    Z @ svd._givens_chain_matrix(cs, sn, n)); None, with the reason as
    an obs instant, when the gate rejects (the caller keeps the dense
    compose). A CPU tensor takes the plain version."""
    rows, n = Z.shape
    if not givens_chain_eligible(rows, n, Z.dtype, blk, Z.device):
        _reject("givens_chain_apply", "shape", rows=rows, n=n,
                dtype=str(Z.dtype))
        return None
    return _givens_chain_launch(Z, cs, sn)


# -- the shifted QR sweeps (one steqr2_qr / bdsqr_qr pass each) ------------

#: longest tridiagonal or bidiagonal a sweep kernel takes: d and e live
#: in its shared memory (8 n bytes)
QR_SWEEP_MAX_N = 16384
#: passes one steqr_sweeps launch runs at most in eig.steqr2_qr: the
#: host reads the passes run and the count once a launch, so 1/32 of
#: the reads a pass; the rotation rows cost 8 (n-1) bytes a pass
#: (0.5 MB at n = 2048)
STEQR_PASSES_PER_LAUNCH = 32
#: passes one bdsqr_sweeps launch runs at most in svd.bdsqr_qr, as
#: above; the four rotation rows cost 16 (n-1) bytes a pass (0.26 MB
#: at n = 512)
BDSQR_PASSES_PER_LAUNCH = 32


def _np_type(dtype) -> type:
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _hypot(f, g):
    """|(f, g)| as the kernels take it: an f32 pair through f64 (exact
    squares, one rounding for the sum, one for the root, one back to
    f32), so the kernel and the plain version agree bitwise without
    relying on two libraries' hypotf; f64 through np.hypot."""
    if isinstance(f, np.float32):
        fd, gd = np.float64(f), np.float64(g)
        return np.float32(np.sqrt(fd * fd + gd * gd))
    return np.hypot(f, g)


def _lartg(f, g):
    """Plane rotation (c, s, r) with c f + s g = r (LAPACK dlartg, the
    reference's svd._lartg), on scalars of one numpy float type."""
    r = _hypot(f, g)
    if r == 0:
        return type(f)(1), type(f)(0), r
    return f / r, g / r, r


def dlas2_min_plain(f, g, h):
    """Smallest singular value of [[f, g], [0, h]] (LAPACK dlas2, the
    reference's svd._dlas2_min) on scalars of one numpy float type,
    in the kernel's order of operations."""
    t = type(f)
    one, two, zero = t(1), t(2), t(0)
    fa, ga, ha = abs(f), abs(g), abs(h)
    fhmn, fhmx = min(fa, ha), max(fa, ha)
    if fhmn == 0:
        return zero
    if ga <= fhmx:
        as_ = one + fhmn / fhmx
        at = (fhmx - fhmn) / fhmx
        au = ga / fhmx
        au = au * au
        return fhmn * (two / (np.sqrt(as_ * as_ + au)
                              + np.sqrt(at * at + au)))
    au = fhmx / ga
    if au == 0:
        return fhmn * fhmx / ga
    x = (one + fhmn / fhmx) * au
    y = ((fhmx - fhmn) / fhmx) * au
    c = one / (np.sqrt(one + x * x) + np.sqrt(one + y * y))
    return two * fhmn * c * au


def _clamp_np(d, e, tol):
    """The reference's deflation clamp: e_i -> 0 where
    |e_i| <= tol (|d_i| + |d_{i+1}|); returns (e, keep)."""
    keep = np.abs(e) > tol * (np.abs(d[:-1]) + np.abs(d[1:]))
    return np.where(keep, e, e.dtype.type(0)), keep


def _block(keep):
    """(ll, mlast) of the trailing unreduced block: mlast the last
    off-diagonal above tolerance, ll one past the last one below it
    before mlast (0 if none); None when none is above."""
    nz = np.flatnonzero(keep)
    if nz.size == 0:
        return None
    mlast = int(nz[-1])
    below = np.flatnonzero(~keep[:mlast])
    return (int(below[-1]) + 1 if below.size else 0), mlast


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().copy()


def unconverged(d: torch.Tensor, e: torch.Tensor, tol: float
                ) -> torch.Tensor:
    """Count of off-diagonals above the deflation tolerance
    (|e_i| > tol (|d_i| + |d_{i+1}|)), a 0-d int32 tensor on d's
    device."""
    keep = e.abs() > tol * (d[:-1].abs() + d[1:].abs())
    return keep.sum().to(torch.int32)


def steqr_sweep_plain(d: torch.Tensor, e: torch.Tensor):
    """Plain version of ONE pass of the symmetric tridiagonal QR
    iteration (the body of the reference's eig.steqr2_qr while_loop),
    on the host in d's type (f32 or f64): clamp the negligible
    off-diagonals, locate the trailing block [ll, m], take the
    Wilkinson shift of its trailing 2x2, and run the bulge chase
    (eig._steqr_shifted_sweep) over the active steps only (the gated
    steps outside the block change nothing in the reference). Returns
    (d, e, cs, sn, count) on d's device: rotations identity outside
    the block, count the off-diagonals still above tolerance after the
    pass (0-d int32)."""
    dev, dt = d.device, d.dtype
    t = _np_type(dt)
    one, two = t(1), t(2)
    eps = t(_eps(dt))
    dn, en = _host(d), _host(e)
    n = dn.shape[0]
    cs, sn = np.ones(n - 1, t), np.zeros(n - 1, t)
    with np.errstate(all="ignore"):
        en, keep = _clamp_np(dn, en, eps)
        blk = _block(keep)
        if blk is not None:
            ll, mlast = blk
            m = mlast + 1
            em1 = en[m - 1]
            delta = (dn[m - 1] - dn[m]) / two
            sgn = one if delta >= 0 else -one
            denom = abs(delta) + _hypot(delta, em1)
            shift = dn[m] - sgn * em1 * em1 / (one if denom == 0 else denom)
            x, z = dn[ll] - shift, en[ll]
            for k in range(ll, m):
                c, s, r = _lartg(x, z)
                if k > ll:
                    en[k - 1] = r
                dk, dk1, ek = dn[k], dn[k + 1], en[k]
                cc, ss, tcs = c * c, s * s, two * c * s
                dn[k] = cc * dk + tcs * ek + ss * dk1
                dn[k + 1] = ss * dk - tcs * ek + cc * dk1
                x = c * s * (dk1 - dk) + (cc - ss) * ek
                en[k] = x
                if k < m - 1:
                    z = s * en[k + 1]
                    en[k + 1] = c * en[k + 1]
                cs[k], sn[k] = c, s
        count = int(_clamp_np(dn, en, eps)[1].sum())
    return (torch.from_numpy(dn).to(dev), torch.from_numpy(en).to(dev),
            torch.from_numpy(cs).to(dev), torch.from_numpy(sn).to(dev),
            torch.tensor(count, dtype=torch.int32, device=dev))


def bdsqr_sweep_plain(d: torch.Tensor, e: torch.Tensor):
    """Plain version of ONE pass of the bidiagonal QR iteration (the
    body of the reference's svd.bdsqr_qr while_loop), on the host in
    d's type: the clamp at 20 eps, the block [ll, m], the dlas2 shift
    (zeroed when negligible against d_ll) and LAPACK dbdsqr's downward
    chase (svd._bdsqr_shifted_sweep) over the active steps only.
    Returns (d, e, cosr, sinr, cosl, sinl, count) on d's device, the
    rotations identity outside the block, count as in
    steqr_sweep_plain."""
    dev, dt = d.device, d.dtype
    t = _np_type(dt)
    one, zero = t(1), t(0)
    eps = t(_eps(dt))
    tol = t(20) * eps
    dn, en = _host(d), _host(e)
    n = dn.shape[0]
    cr, cl = np.ones(n - 1, t), np.ones(n - 1, t)
    sr, sl = np.zeros(n - 1, t), np.zeros(n - 1, t)
    with np.errstate(all="ignore"):
        en, keep = _clamp_np(dn, en, tol)
        blk = _block(keep)
        if blk is not None:
            ll, m = blk
            mm = min(m, n - 2)
            shift = dlas2_min_plain(dn[mm], en[mm], dn[mm + 1])
            dll = dn[ll]
            q = shift / (one if dll == 0 else dll)
            if q * q < eps:
                shift = zero
            sgn = one if dll > 0 else (-one if dll < 0 else zero)
            f = (abs(dll) - shift) * (sgn + shift
                                      / (one if dll == 0 else dll))
            g = en[ll]
            for i in range(ll, m + 1):
                cosr, sinr, r = _lartg(f, g)
                if i > ll:
                    en[i - 1] = r
                f2 = cosr * dn[i] + sinr * en[i]
                e_i = cosr * en[i] - sinr * dn[i]
                g2 = sinr * dn[i + 1]
                d_i1 = cosr * dn[i + 1]
                cosl, sinl, r2 = _lartg(f2, g2)
                f = cosl * e_i + sinl * d_i1
                d_i1b = cosl * d_i1 - sinl * e_i
                if i < m:
                    g = sinl * en[i + 1]
                    en[i + 1] = cosl * en[i + 1]
                dn[i], dn[i + 1], en[i] = r2, d_i1b, e_i
                cr[i], sr[i], cl[i], sl[i] = cosr, sinr, cosl, sinl
            en[m] = f
        count = int(_clamp_np(dn, en, tol)[1].sum())
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (dn, en, cr, sr, cl, sl)) + (
        torch.tensor(count, dtype=torch.int32, device=dev),)


def _sweeps_plain(one_pass: Callable, tol_eps: int, nrot: int,
                  d: torch.Tensor, e: torch.Tensor, max_passes: int):
    """`one_pass` while the count of off-diagonals above tol_eps * eps
    is not 0, at most `max_passes` times; its `nrot` rotation vectors
    (cosines and sines in turn) to row p of (max_passes, n-1) outputs,
    identity past the passes run."""
    dev, dt = d.device, d.dtype
    t = _np_type(dt)
    rots = [(torch.zeros if k % 2 else torch.ones)(
        (max_passes, d.shape[0] - 1), dtype=dt, device=dev)
        for k in range(nrot)]
    with np.errstate(all="ignore"):
        count = int(_clamp_np(_host(d), _host(e),
                              t(tol_eps) * t(_eps(dt)))[1].sum())
    d, e, p = d.clone(), e.clone(), 0
    while count > 0 and p < max_passes:
        d, e, *rot, cnt = one_pass(d, e)
        for r, x in zip(rots, rot):
            r[p] = x
        count, p = int(cnt), p + 1
    return (d, e, *rots, torch.tensor([p, count], dtype=torch.int32,
                                      device=dev))


def steqr_sweeps_plain(d: torch.Tensor, e: torch.Tensor, max_passes: int):
    """Plain version of up to `max_passes` passes in one call (the
    multi-pass entry): steqr_sweep_plain while the count of
    off-diagonals above tolerance is not 0, the reference's while_loop
    with the caller's cap. Returns (d, e, cs, sn, ran) on d's device:
    the rotations (max_passes, n-1), identity past the passes run, and
    ran = [passes run, count after them (of the input if none ran)],
    int32."""
    return _sweeps_plain(steqr_sweep_plain, 1, 2, d, e, max_passes)


def bdsqr_sweeps_plain(d: torch.Tensor, e: torch.Tensor, max_passes: int):
    """Plain version of up to `max_passes` bidiagonal passes in one call
    (the multi-pass entry), as steqr_sweeps_plain: bdsqr_sweep_plain
    while the count above 20 eps is not 0. Returns (d, e, cosr, sinr,
    cosl, sinl, ran), the rotations (max_passes, n-1)."""
    return _sweeps_plain(bdsqr_sweep_plain, 20, 4, d, e, max_passes)


def _sweep_setup(name: str, d: torch.Tensor, e: torch.Tensor, nrot: int,
                 rows: Optional[int] = None):
    """What the sweep kernels take: the library on d's device,
    contiguous f32 inputs, fresh d / e outputs, `nrot` rotation vectors
    ((rows, n-1) each for the multi-pass entry) and the count (two ints
    for the multi-pass entry: passes, count). Raises on what the kernels
    do not take."""
    n = d.shape[0]
    if d.dtype != torch.float32 or e.dtype != torch.float32 \
            or tuple(e.shape) != (n - 1,) or not 2 <= n <= QR_SWEEP_MAX_N:
        raise ValueError("%s kernel takes f32 d (n,) and e (n-1,) with "
                         "2 <= n <= %d, got %s %s and %s %s"
                         % (name, QR_SWEEP_MAX_N, tuple(d.shape), d.dtype,
                            tuple(e.shape), e.dtype))
    if rows is not None and rows < 0:
        raise ValueError("%s: max_passes must be >= 0, got %d"
                         % (name, rows))
    lib = _build.load("qr_sweep")
    _build.set_device(lib, "qr_sweep", d.get_device())
    d, e = d.contiguous(), e.contiguous()
    shape = (n - 1,) if rows is None else (rows, n - 1)
    rots = [torch.empty(shape, dtype=torch.float32, device=d.device)
            for _ in range(nrot)]
    cnt = torch.empty(() if rows is None else (2,), dtype=torch.int32,
                      device=d.device)
    return lib, d, e, torch.empty_like(d), torch.empty_like(e), rots, cnt


def steqr_sweep(d: torch.Tensor, e: torch.Tensor):
    """One pass of the tridiagonal QR iteration (steqr_sweep_plain's
    contract): the ``steqr_sweep`` CUDA kernel for a CUDA tensor, one
    launch a pass, counted, nothing read back to the host; the plain
    version for a CPU tensor."""
    if d.device.type != "cuda":
        return steqr_sweep_plain(d, e)
    lib, d, e, dout, eout, (cs, sn), cnt = _sweep_setup("steqr_sweep",
                                                        d, e, 2)
    _build.check(lib.steqr_sweep(d.data_ptr(), e.data_ptr(), d.shape[0],
                                 _eps(torch.float32), dout.data_ptr(),
                                 eout.data_ptr(), cs.data_ptr(),
                                 sn.data_ptr(), cnt.data_ptr(), _stream(d)),
                 "steqr_sweep")
    steqr_sweep.launches += 1
    return dout, eout, cs, sn, cnt


steqr_sweep.launches = 0


def steqr_sweeps(d: torch.Tensor, e: torch.Tensor, max_passes: int):
    """Up to `max_passes` passes of the tridiagonal QR iteration in one
    launch, stopping at a count of 0 (steqr_sweeps_plain's contract):
    the ``steqr_sweep`` kernel for a CUDA tensor, d and e kept on the
    card between passes, nothing read back to the host (the caller
    reads ``ran`` once); counted as one ``steqr_sweep`` launch, the
    kernel it runs. The plain version for a CPU tensor."""
    if d.device.type != "cuda":
        return steqr_sweeps_plain(d, e, max_passes)
    lib, d, e, dout, eout, (cs, sn), ran = _sweep_setup(
        "steqr_sweeps", d, e, 2, max_passes)
    _build.check(lib.steqr_sweeps(d.data_ptr(), e.data_ptr(), d.shape[0],
                                  _eps(torch.float32), max_passes,
                                  dout.data_ptr(), eout.data_ptr(),
                                  cs.data_ptr(), sn.data_ptr(),
                                  ran.data_ptr(), _stream(d)),
                 "steqr_sweeps")
    steqr_sweep.launches += 1
    return dout, eout, cs, sn, ran


def bdsqr_sweep(d: torch.Tensor, e: torch.Tensor):
    """One pass of the bidiagonal QR iteration (bdsqr_sweep_plain's
    contract): the ``bdsqr_sweep`` CUDA kernel for a CUDA tensor (the
    multi-pass kernel run for one pass), counted; the plain version for
    a CPU tensor."""
    if d.device.type != "cuda":
        return bdsqr_sweep_plain(d, e)
    lib, d, e, dout, eout, rots, cnt = _sweep_setup("bdsqr_sweep", d, e, 4)
    _build.check(lib.bdsqr_sweep(d.data_ptr(), e.data_ptr(), d.shape[0],
                                 _eps(torch.float32), dout.data_ptr(),
                                 eout.data_ptr(),
                                 *[r.data_ptr() for r in rots],
                                 cnt.data_ptr(), _stream(d)),
                 "bdsqr_sweep")
    bdsqr_sweep.launches += 1
    return (dout, eout, *rots, cnt)


bdsqr_sweep.launches = 0


def bdsqr_sweeps(d: torch.Tensor, e: torch.Tensor, max_passes: int):
    """Up to `max_passes` passes of the bidiagonal QR iteration in one
    launch, stopping at a count of 0 (bdsqr_sweeps_plain's contract):
    the ``bdsqr_sweep`` kernel for a CUDA tensor, d and e kept on the
    card between passes, nothing read back to the host (the caller
    reads ``ran`` once); counted as one ``bdsqr_sweep`` launch, the
    kernel it runs. The plain version for a CPU tensor."""
    if d.device.type != "cuda":
        return bdsqr_sweeps_plain(d, e, max_passes)
    lib, d, e, dout, eout, rots, ran = _sweep_setup(
        "bdsqr_sweeps", d, e, 4, max_passes)
    _build.check(lib.bdsqr_sweeps(d.data_ptr(), e.data_ptr(), d.shape[0],
                                  _eps(torch.float32), max_passes,
                                  dout.data_ptr(), eout.data_ptr(),
                                  *[r.data_ptr() for r in rots],
                                  ran.data_ptr(), _stream(d)),
                 "bdsqr_sweeps")
    bdsqr_sweep.launches += 1
    return (dout, eout, *rots, ran)


# -- counters ----------------------------------------------------------------

_COUNTED = {"lu_panel_rec": _lu_panel_rec_launch,
            "rank_update": _rank_update,
            "lu_panel": _lu_panel_launch,
            "compose_swaps": lu_pivots_to_permutation,
            "qr_panel": _qr_panel_launch,
            "chol_panel": _chol_panel_launch,
            "trtri_lower": _trtri_lower_launch,
            "ragged_potrf": _ragged_potrf_launch,
            "ragged_getrf": _ragged_getrf_launch,
            "ragged_trsm": _ragged_trsm_launch,
            "givens_chain_apply": _givens_chain_launch,
            "steqr_sweep": steqr_sweep,
            "bdsqr_sweep": bdsqr_sweep}


def launch_counts() -> dict:
    """Launch count of every kernel wrapper, by kernel name."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0

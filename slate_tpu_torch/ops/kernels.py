"""Hand-written Hopper kernels (counterpart of
``slate_tpu/ops/pallas_kernels.py``), with the ported entries only:
the block-recursive LU panel ``lu_panel_rec`` and the trailing update
``_rank_update`` of its tall-panel split.

Every kernel here has three parts side by side:

  * the CUDA C++ kernel, in ``csrc/`` (built by ``_build.py``);
  * a launch wrapper (``_lu_panel_rec_launch``, ``_rank_update``, the
    counterparts of ``_lu_panel_rec_pallas`` and ``_rank_update``) that launches the kernel for a CUDA
    tensor and adds one to its ``launches`` count there, and nowhere
    else; it raises on what the kernel does not take. There is no
    fall back: for a tensor on the CPU, and only then, it computes the
    kernel's plain version instead;
  * the plain PyTorch version (``panel_rec_plain``,
    ``rank_update_plain``), the same function with the same recursion
    and pivot tie-break, which the CPU tests hold against the JAX
    package and ``chip_smoke.py`` holds against the kernel on the card
    (``lu_panel_rec_plain`` is the whole public entry on plain parts).

ARBITRATION CONTRACT, as in the reference: the public entry has an
eligibility gate (``lu_panel_rec_reject_reason`` / ``_eligible``) and
returns ``None`` when it rejects, so the caller keeps its fallback; it
has a tune op with a FROZEN row (``KERNEL_REGISTRY``); with the tune
cache cold, no driver routes to it. The gates use the reference's
numbers (LU_REC_MAX_W, LU_REC_IB, LU_REC_MAX_ELEMS), so both packages
split panels at the same points. f32 only in this slice: bf16 is
rejected with reason "dtype".
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _build

#: public kernel entry point -> (eligibility gate, tune-cache op)
KERNEL_REGISTRY = {
    "lu_panel_rec": ("lu_panel_rec_eligible", "lu_panel"),
}

#: widest recursive panel (one dispatch OR the tall split)
LU_REC_MAX_W = 512
#: innermost base-case width (tune key ("lu_panel", "ib"))
LU_REC_IB = 32
#: single-dispatch budget in f32-equivalent panel ELEMENTS (m * w)
LU_REC_MAX_ELEMS = 8192 * 256

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


# -- permutations ----------------------------------------------------------

def lu_pivots_to_permutation(piv: torch.Tensor, m: int) -> torch.Tensor:
    """Compose the swap sequence (j <-> piv[j], in order) into one
    permutation of range(m): a plain port of XLA's
    ``lu_pivots_to_permutation``. Runs on the host (the swaps are
    sequential); returns int64 on piv's device."""
    p = piv.detach().cpu().numpy()
    perm = np.arange(m)
    for j, t in enumerate(p.tolist()):
        perm[j], perm[t] = perm[t], perm[j]
    return torch.as_tensor(perm, device=piv.device)


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
    'dtype' (f32 only in this slice), then the reference's shape
    reasons 'width', 'aspect', 'align', 'height'."""
    if device is None or torch.device(device).type != "cuda":
        return NOT_CUDA
    if dtype != torch.float32:
        return "dtype"
    return _rec_shape_reason(m, w, dtype, max_elems, ib)


def lu_panel_rec_eligible(m: int, w: int, dtype, device=None) -> bool:
    """ROUTING gate for the block-recursive panel."""
    return lu_panel_rec_reject_reason(m, w, dtype, device) is None


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
    device: (packed LU, int32 swap targets). Pivot search takes the
    lowest row among equal magnitudes (``torch.argmax`` returns the
    first maximum), as lu_panel_fori does."""
    m, w = a.shape
    out = a.clone()
    piv = [0] * w

    def base(c0, wseg):
        e = c0 + wseg
        for j in range(c0, e):
            p = j + int(torch.argmax(out[j:, j].abs()))
            piv[j] = p
            if p != j:
                out[[j, p]] = out[[p, j]]
            pivval = out[j, j]
            safe = torch.where(pivval == 0, torch.ones_like(pivval),
                               pivval)
            mults = out[j + 1:, j] / safe
            out[j + 1:, j] = mults
            out[j + 1:, j + 1:e] -= torch.outer(mults, out[j, j + 1:e])

    def leaf(c0, ws, c1, c2):
        for r in range(c0, c0 + ws):
            out[r + 1:c0 + ws, c1:c2] -= torch.outer(
                out[r + 1:c0 + ws, r], out[r, c1:c2])

    def mm(r0, r1, k0, k1, c0, c1):
        out[r0:r1, c0:c1] -= out[r0:r1, k0:k1] @ out[k0:k1, c0:c1]

    _rec_drive(m, w, ib, base, leaf, mm)
    return out, torch.tensor(piv, dtype=torch.int32, device=a.device)


#: candidate slots of the base case's cooperative grid (MAX_BLOCKS in
#: csrc/lu_panel_rec.cu)
_BASE_MAX_BLOCKS = 1024


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lu_panel_rec_cuda(a: torch.Tensor, ib: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    m, w = a.shape
    if a.dtype != torch.float32 or not (w <= m and w <= LU_REC_MAX_W
                                        and ib >= 1):
        raise ValueError("lu_panel_rec kernel takes an f32 (m, w) panel "
                         "with w <= m and w <= %d, got %s %s ib=%d"
                         % (LU_REC_MAX_W, tuple(a.shape), a.dtype, ib))
    lib = _build.load("lu_panel_rec")
    _build.check(lib.slate_set_device(a.get_device()), "slate_set_device")
    out = a.clone(memory_format=torch.contiguous_format)
    piv = torch.zeros(w, dtype=torch.int32, device=a.device)
    # base-case scratch: per-block pivot candidates and posted rows
    # (csrc/lu_panel_rec.cu lu_rec_base), one grid-barrier counter
    scr_f = torch.empty(2 * _BASE_MAX_BLOCKS + 4 * w, dtype=torch.float32,
                        device=a.device)
    scr_i = torch.empty(1 + 2 * _BASE_MAX_BLOCKS, dtype=torch.int32,
                        device=a.device)
    ptr, pptr, s = out.data_ptr(), piv.data_ptr(), _stream(a)

    def base(c0, wseg):
        _build.check(lib.lu_rec_base(ptr, pptr, m, w, c0, wseg,
                                     scr_f.data_ptr(), scr_i.data_ptr(), s),
                     "lu_rec_base")

    def leaf(c0, ws, c1, c2):
        _build.check(lib.lu_rec_solve_leaf(ptr, w, c0, ws, c1, c2, s),
                     "lu_rec_solve_leaf")

    def mm(r0, r1, k0, k1, c0, c1):
        _build.check(lib.lu_rec_mm_update(ptr, w, r0, r1, k0, k1, c0, c1,
                                          s), "lu_rec_mm_update")

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
    """Plain PyTorch version: A22 - L21 @ U12."""
    return a22 - l21 @ u12


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
    m2, w2 = a22.shape
    w1 = l21.shape[1]
    if not (a22.dtype == l21.dtype == u12.dtype == torch.float32
            and l21.shape[0] == m2 and tuple(u12.shape) == (w1, w2)
            and l21.device == u12.device == a22.device):
        raise ValueError("rank_update kernel takes f32 CUDA (m2, w2), "
                         "(m2, w1), (w1, w2); got %s %s %s"
                         % (tuple(a22.shape), tuple(l21.shape),
                            tuple(u12.shape)))
    lib = _build.load("rank_update")
    _build.check(lib.slate_set_device(a22.get_device()), "slate_set_device")
    a22, l21, u12 = a22.contiguous(), l21.contiguous(), u12.contiguous()
    out = torch.empty_like(a22)
    _build.check(lib.rank_update(a22.data_ptr(), l21.data_ptr(),
                                 u12.data_ptr(), out.data_ptr(), m2, w2, w1,
                                 _stream(a22)), "rank_update")
    _rank_update.launches += 1
    return out


_rank_update.launches = 0


# -- the public entry ------------------------------------------------------

def _lu_rec_split(a: torch.Tensor, ib: Optional[int], max_elems: int,
                  panel: Callable = None, update: Callable = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host-level recursive halving for panels too tall for one
    dispatch: factor the left half, apply its composed permutation to
    the right half, solve U12, run the trailing update kernel, recurse
    on the right, then permute the left half's lower rows by the
    right's pivots. The pivot SEQUENCE equals factoring the whole
    panel column by column. `panel`/`update` default to the kernel
    wrappers; lu_panel_rec_plain passes the plain versions."""
    panel = panel or _lu_panel_rec_launch
    update = update or _rank_update
    m, w = a.shape
    if m * w <= max_elems:
        return panel(a, _rec_ib(w, ib))
    w1 = w // 2
    left, piv1 = _lu_rec_split(a[:, :w1], ib, max_elems, panel, update)
    right = a[:, w1:][lu_pivots_to_permutation(piv1, m)]
    u12 = torch.linalg.solve_triangular(left[:w1, :w1], right[:w1],
                                        upper=False, left=True,
                                        unitriangular=True)
    a22 = update(right[w1:], left[w1:, :w1], u12)
    sub, piv2 = _lu_rec_split(a22, ib, max_elems, panel, update)
    perm2 = lu_pivots_to_permutation(piv2, m - w1)
    left = torch.cat([left[:w1], left[w1:][perm2]], dim=0)
    packed = torch.cat([left, torch.cat([u12, sub], dim=0)], dim=1)
    return packed, torch.cat([piv1, w1 + piv2])


def lu_panel_rec(a: torch.Tensor, ib: Optional[int] = None,
                 max_elems: Optional[int] = None
                 ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(packed, piv int32) partial-pivot LU panel via BLOCK RECURSION:
    one kernel dispatch when (m, w) fits the element budget, the
    host-level halving with the trailing-update kernel when taller.
    Returns None (with the reason as an obs instant) when the shape or
    dtype is ineligible. A CPU tensor of an eligible shape takes the
    plain versions (the counterpart of the reference's interpret mode
    off-TPU). `ib` overrides the tuned base-case width, `max_elems`
    the single-dispatch budget."""
    m, w = a.shape
    reason = lu_panel_rec_reject_reason(m, w, a.dtype, a.device,
                                        max_elems, ib)
    if reason is not None and not (
            reason == NOT_CUDA and a.dtype == torch.float32
            and _rec_shape_reason(m, w, a.dtype, max_elems, ib) is None):
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


def launch_counts() -> dict:
    """Launch count of every kernel wrapper, by kernel name."""
    return {"lu_panel_rec": _lu_panel_rec_launch.launches,
            "rank_update": _rank_update.launches}


def reset_launch_counts() -> None:
    _lu_panel_rec_launch.launches = 0
    _rank_update.launches = 0

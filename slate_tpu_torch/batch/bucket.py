"""Shape bucketing for the batch layer (counterpart of
``slate_tpu/batch/bucket.py``, copied into the port).

Every request size rounds up a geometric ladder (floor 64, growth 2,
rungs rounded to the tuned ``batch/align``, FROZEN 8), so one batched
dispatch serves every request of a rung. Padding is validity-masked
by construction: the padded block makes the padded problem factor
exactly into blkdiag(result(A), trivial block):

  * ``identity``: padded diagonal 1, zeros elsewhere (potrf, getrf,
    geqrf and the solves); partial pivoting cannot pick a padded row
    inside a live column, and padded columns pivot on their own unit;
  * ``shift``: padded diagonal at a Gershgorin bound above A's
    spectrum (eigh keeps A's eigenpairs as the first n ascending);
  * ``zero``: right-hand sides.

The RAGGED strategy replaces the ladder for the square factorizations
and solves: :func:`ragged_ceiling` is one stacking shape per flush,
the largest live size rounded to lcm(align, blk), and the kernels
(ops/kernels.ragged_*) bound each element's work by its own order.
:func:`ragged_report` is its waste record.

Where the reference pads numpy arrays, the pads here take numpy
arrays or torch tensors and return CPU torch tensors of the input's
type, so bf16 (which numpy lacks) stacks on the host too.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.tiles import round_up

#: geometric ladder defaults: floor rung and growth factor
FLOOR = 64
GROWTH = 2.0

#: FROZEN default of the ``batch/align`` tunable: rungs and the ragged
#: ceiling round to a multiple of it
ALIGN = 8


def batch_align(align: int | None = None, opts=None) -> int:
    """The tuned/frozen lane alignment every rung and the ragged
    ceiling round to: an explicit ``align`` wins, else the
    ``batch/align`` tune row (FROZEN 8)."""
    if align is not None:
        return max(int(align), 1)
    from ..tune.select import tuned_int
    return max(tuned_int("batch", "align", ALIGN, opts=opts), 1)


def bucket_ladder(n_max: int, floor: int = FLOOR,
                  growth: float = GROWTH,
                  align: int | None = None) -> List[int]:
    """The bucket sizes covering [1, n_max]: floor, floor*growth, ...
    each rounded up to the (tuned) lane alignment, strictly
    increasing."""
    if n_max < 1:
        raise ValueError(f"n_max={n_max} < 1")
    al = batch_align(align)
    rungs = []
    b = float(max(floor, al))
    while True:
        rung = int(math.ceil(b / al)) * al
        if rungs and rung <= rungs[-1]:
            rung = rungs[-1] + al
        rungs.append(rung)
        if rung >= n_max:
            return rungs
        b = max(b * growth, b + al)


def bucket_for(n: int, floor: int = FLOOR,
               growth: float = GROWTH,
               align: int | None = None) -> int:
    """Smallest ladder rung >= n (the shape this request pads to)."""
    return bucket_ladder(max(n, 1), floor, growth, align)[-1]


def ragged_ceiling(ns: Sequence[int], blk: int = 1,
                   align: int | None = None) -> int:
    """The ONE stacking shape of a ragged dispatch: the largest live
    size rounded up to lcm(lane alignment, ragged block width), with
    no power-of-two rounding; the per-element sizes vector carries each
    matrix's true order into the kernels."""
    if not ns:
        raise ValueError("ragged_ceiling wants at least one size")
    al = batch_align(align)
    blk = max(int(blk), 1)
    step = al * blk // math.gcd(al, blk)
    return max(round_up(max(int(n) for n in ns), step), step)


def _host(a) -> torch.Tensor:
    """A CPU torch tensor of `a` (numpy array or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.as_tensor(np.asarray(a))


def pad_square(a, nb: int, mode: str = "identity") -> torch.Tensor:
    """Pad one (n, n) matrix to (nb, nb) with the validity-masked
    block for its driver family (module doc): 'identity' for the
    factorizations and solves, 'shift' (Gershgorin) for eigh, 'zero'
    for operands whose padding needs no diagonal."""
    a = _host(a)
    n = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError(f"pad_square wants a square 2-D matrix, "
                         f"got shape {tuple(a.shape)}")
    if n > nb:
        raise ValueError(f"matrix n={n} exceeds bucket {nb}")
    if mode not in ("identity", "shift", "zero"):
        raise ValueError(f"unknown pad mode {mode!r}")
    out = torch.zeros((nb, nb), dtype=a.dtype)
    out[:n, :n] = a
    if n < nb and mode != "zero":
        pad = torch.arange(n, nb)
        # shift: |lambda| <= ||A||_inf for Hermitian A, so c =
        # ||A||_inf + 1 puts every padded eigenvalue above every true
        # one and ascending order keeps A's spectrum in the first n
        c = 1.0 if mode == "identity" or n == 0 \
            else float(a.abs().sum(dim=1).max()) + 1.0
        out[pad, pad] = c
    return out


def pad_rect(a, mb: int, nb: int, mode: str = "identity") -> torch.Tensor:
    """Pad one (m, n) matrix to (mb, nb); 'identity' places the padded
    columns' units on the OFFSET diagonal (m+j, n+j), in padded rows,
    so every padded column is orthogonal to the live rows and an
    overdetermined least-squares crop x[:n] is the A-only minimizer.
    Requires mb - m >= nb - n (rect_buckets chooses mb that way)."""
    a = _host(a)
    m, n = a.shape
    if m > mb or n > nb:
        raise ValueError(f"matrix {tuple(a.shape)} exceeds bucket "
                         f"({mb}, {nb})")
    out = torch.zeros((mb, nb), dtype=a.dtype)
    out[:m, :n] = a
    if mode == "identity":
        if (nb - n) > (mb - m):
            raise ValueError(
                f"pad_rect identity mode needs row slack >= column "
                f"slack, got ({mb}-{m}) < ({nb}-{n}); widen mb "
                f"(rect_buckets does)")
        k = nb - n
        if k > 0:
            out[torch.arange(m, m + k), torch.arange(n, n + k)] = 1
    elif mode != "zero":
        raise ValueError(f"unknown pad mode {mode!r}")
    return out


def rect_buckets(m: int, n: int, floor: int = FLOOR,
                 growth: float = GROWTH,
                 align: int | None = None) -> Tuple[int, int]:
    """Bucket pair for an (m, n) rectangle: bn covers n, and bm covers
    m PLUS the column slack (bn - n), so pad_rect's offset diagonal
    always fits inside padded rows."""
    bn = bucket_for(n, floor, growth, align)
    bm = bucket_for(max(m, m + (bn - n)), floor, growth, align)
    return bm, bn


def pad_rhs(b, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad a right-hand-side block to (rows, cols)."""
    b = _host(b)
    out = torch.zeros((rows, cols), dtype=b.dtype)
    out[: b.shape[0], : b.shape[1]] = b
    return out


def padding_waste(ns: Sequence[Tuple[int, int]] | Sequence[int],
                  mb: int, nb: int | None = None,
                  exponent: int = 2) -> float:
    """Padded-away work fraction of one stacked dispatch:
    1 - sum(m_i*n_i^(e-1)) / (B * mb*nb^(e-1)). exponent=2 is the
    element (memory) fraction, exponent=3 the cubic-flop fraction.
    `ns` holds per-request logical sizes (n or (m, n))."""
    if nb is None:
        nb = mb
    if not ns:
        return 0.0
    live = 0.0
    for s in ns:
        m, n = (s, s) if isinstance(s, (int, np.integer)) else s
        live += m * float(n) ** (exponent - 1)
    total = len(ns) * mb * float(nb) ** (exponent - 1)
    return max(0.0, 1.0 - live / total)


def stack_report(ns, mb: int, nb: int | None = None) -> dict:
    """The occupancy/waste record one dispatch publishes."""
    return {
        "occupancy": len(ns),
        "padding_waste": padding_waste(ns, mb, nb, exponent=2),
        "padding_waste_flops": padding_waste(ns, mb, nb, exponent=3),
    }


def ragged_report(ns: Sequence[int], blk: int,
                  floor: int = FLOOR, growth: float = GROWTH,
                  align: int | None = None) -> dict:
    """The occupancy/waste record of one RAGGED dispatch. Waste is
    measured against each element's block-aligned extent
    ceil(s/blk)*blk, the extent the reference's kernels confine their
    sweep to. ``flops_saved`` is the cubic work avoided against the
    bucket ladder; ``scheduled_flops`` the dispatch's cubic extent (the
    weight of the queue's flops-weighted mean occupancy)."""
    sizes = [int(s if isinstance(s, (int, np.integer)) else s[1])
             for s in ns]
    ext = [round_up(s, max(int(blk), 1)) for s in sizes]
    live2 = sum(s * s for s in sizes)
    live3 = sum(s ** 3 for s in sizes)
    ext2 = sum(a * a for a in ext)
    ext3 = sum(a ** 3 for a in ext)
    saved = sum(
        max(bucket_for(s, floor, growth, align) ** 3 - a ** 3, 0)
        for s, a in zip(sizes, ext))
    return {
        "occupancy": len(sizes),
        "padding_waste": max(0.0, 1.0 - live2 / max(ext2, 1)),
        "padding_waste_flops": max(0.0, 1.0 - live3 / max(ext3, 1)),
        "scheduled_flops": float(ext3),
        "flops_saved": float(saved),
    }

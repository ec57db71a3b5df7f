"""Algorithm-variant selection (counterpart of
``slate_tpu/core/methods.py``): MethodTrsm, MethodGemm, MethodHemm,
MethodLU, MethodFactor, MethodLUPanel, MethodCholQR, MethodGels,
MethodBatchStrategy, the out-of-core streams' MethodOOC,
MethodPrecision, MethodLUPivot, MethodScheduler and MethodVisitFuse,
MethodEig, MethodSVD and the shared height-cap rule. (MethodOwnership,
the sharded stream's, comes with ``dist/``, ROADMAP queue 1, item 10;
so does the grid SUMMA that ``MethodGemm.Summa`` names, and gemm
raises on it until then.)

"Native" here means ``torch.linalg.lu_factor`` (LAPACK on the CPU,
cuSOLVER on the card) where the reference means XLA's LU custom call.
"""

from __future__ import annotations

import enum

import torch


class MethodTrsm(enum.Enum):
    """Reference method.hh:27-60: trsmA broadcasts B to A's ranks (better
    for few RHS); trsmB broadcasts A (better for many RHS)."""
    Auto = "auto"
    A = "A"
    B = "B"

    @staticmethod
    def select(side_left: bool, a_n: int, b_m: int, b_n: int
               ) -> "MethodTrsm":
        # many RHS relative to A's order -> trsmB. The RHS count is
        # B's columns for Left, B's rows for Right
        nrhs = b_n if side_left else b_m
        return MethodTrsm.B if nrhs >= a_n else MethodTrsm.A


class MethodGemm(enum.Enum):
    """Reference method.hh:79: small n (few C columns) -> gemmA.
    ``Summa`` is the reference's hand-scheduled SUMMA over a grid of
    devices; it comes with the distributed slice (ROADMAP queue 1, item
    10), and gemm raises on it until then."""
    Auto = "auto"
    A = "A"
    C = "C"
    Summa = "summa"

    @staticmethod
    def select(m: int, n: int, k: int) -> "MethodGemm":
        return MethodGemm.A if n <= 256 and k >= 4 * n else MethodGemm.C


class MethodHemm(enum.Enum):
    """Reference method.hh:132."""
    Auto = "auto"
    A = "A"
    C = "C"

    @staticmethod
    def select(m: int, n: int) -> "MethodHemm":
        return MethodHemm.A if n <= 256 else MethodHemm.C


class MethodCholQR(enum.Enum):
    """Reference method.hh:184: how to form A^H A (one product here,
    whichever is named)."""
    Auto = "auto"
    GemmA = "gemmA"
    GemmC = "gemmC"
    HerkA = "herkA"
    HerkC = "herkC"

    @staticmethod
    def select(m: int, n: int) -> "MethodCholQR":
        return MethodCholQR.HerkC


class MethodGels(enum.Enum):
    """Reference method.hh:237: QR (robust) vs CholQR (fast,
    well-conditioned tall-skinny) vs TSQR (the tree QR of
    linalg/ca.py)."""
    Auto = "auto"
    QR = "qr"
    CholQR = "cholqr"
    TSQR = "tsqr"

    @staticmethod
    def select(m: int, n: int, on_grid: bool = False) -> "MethodGels":
        """The reference's heuristic: tall-skinny (m >= 3n) takes
        CholQR on one device (TSQR on a mesh), else QR."""
        if m >= 3 * n:
            return MethodGels.TSQR if on_grid else MethodGels.CholQR
        return MethodGels.QR


class MethodLU(enum.Enum):
    """Reference method.hh:281: partial-pivot / tournament / no-pivot."""
    Auto = "auto"
    PartialPiv = "PPLU"
    CALU = "CALU"
    NoPiv = "NoPiv"
    BEAM = "BEAM"


def vmem_height_cap(base_m: int, dtype) -> int:
    """Itemsize-proportional height/element cap of the recursive panel
    kernel, the same rule as the reference (whose scalar recurrences
    stay f32 whatever the panel dtype): sub-f32 dtypes SHRINK the cap,
    wider dtypes clamp at the f32 cap. Kept with the reference's
    numbers so both packages split panels at the same points."""
    return base_m * min(_itemsize(dtype), 4) // 4


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    import numpy as np
    return np.dtype(dtype).itemsize


def _dtype_name(dtype) -> str:
    from ..tune.cache import dtype_name
    return dtype_name(dtype)


class MethodFactor(enum.Enum):
    """Execution path for the dense factorizations: ``Fused`` hands
    the whole factorization to the library call, ``Tiled`` runs the
    blocked algorithm (the single-device Auto choice for getrf)."""
    Auto = "auto"
    Fused = "fused"
    Tiled = "tiled"

    @staticmethod
    def native_lu_dtype_ok(dtype) -> bool:
        """The dtypes ``torch.linalg.lu_factor`` takes: f32/f64/c64/
        c128, as the reference's native LU."""
        return _dtype_name(dtype) in ("float32", "float64", "complex64",
                                      "complex128")

    @staticmethod
    def native_lu_ok(dtype, m: int) -> bool:
        """dtype support only: the reference's TPU height limit
        (NATIVE_LU_MAX_M, a scoped-VMEM compile limit of XLA's LU
        custom call) has no counterpart on CUDA or the CPU, so `m` is
        not capped here."""
        return MethodFactor.native_lu_dtype_ok(dtype)

    @staticmethod
    def select(data, dtype_ok: bool = True) -> "MethodFactor":
        """Auto resolution on one device: Fused, unless the driver
        reports that its library call cannot take the dtype
        (`dtype_ok=False`), then Tiled. (The reference's third case, an
        array sharded over several devices, has no counterpart until
        the distributed slice.)"""
        return MethodFactor.Fused if dtype_ok else MethodFactor.Tiled


class MethodLUPanel(enum.Enum):
    """Execution route for ONE LU panel factorization (lu._lu_panel):

      * ``Native``: ``torch.linalg.lu_factor`` on the panel;
      * ``PallasRec``: the block-recursive hand kernel
        (ops/kernels.lu_panel_rec), the port of the reference's Pallas
        route of the same name;
      * ``Pallas``: the rank-1 hand kernel (ops/kernels.lu_panel), the
        port of the reference's round-3 Pallas panel: the cold route
        of bf16 panels on the card;
      * ``Fori``: the plain column loop (lu.lu_panel_fori).

    ``Auto`` resolves via the tune cache (a MEASURED
    ``method_lu_panel`` entry per (op, size, dtype) bucket), falling
    back to ``cold_default``. ``tune.autotune(ops=("lu_panel",), n=h)``
    writes those entries: it measures every route its gate takes at
    panel height h on the device and persists the winner, e.g.
    ``pallas_rec``, when it beats the cold route by more than
    ``tune.probe.WIN_MARGIN``."""
    Auto = "auto"
    Native = "native"
    Fori = "fori"
    Pallas = "pallas"
    PallasRec = "pallas_rec"

    @staticmethod
    def cold_default(m: int, w: int, dtype, device=None
                     ) -> "MethodLUPanel":
        """The frozen chain of the reference: native where the dtype
        allows, the rank-1 kernel where its gate takes the panel (a
        CUDA tensor, f32/bf16, the reference's shape limits), else the
        fori loop. `device` is the panel's: off the card the kernel's
        gate rejects, as the reference's does off the TPU."""
        if MethodFactor.native_lu_ok(dtype, m):
            return MethodLUPanel.Native
        from ..ops import kernels as pk
        if pk.lu_panel_eligible(m, w, dtype, device):
            return MethodLUPanel.Pallas
        return MethodLUPanel.Fori

    @staticmethod
    def resolve(m: int, w: int, dtype, device=None) -> "MethodLUPanel":
        """Measured cache entry (validated against the hard gates),
        else cold_default."""
        from ..tune.select import tuned_method
        cached = tuned_method("lu_panel", "lu_panel", n=m, dtype=dtype)
        if cached is MethodLUPanel.Native \
                and not MethodFactor.native_lu_ok(dtype, m):
            cached = None
        if cached is not None and cached is not MethodLUPanel.Auto:
            return cached
        return MethodLUPanel.cold_default(m, w, dtype, device)


class MethodBatchStrategy(enum.Enum):
    """Stacking strategy of the batch layer's coalescing queue:

      * ``Bucket``: every request pads up a geometric ladder of shapes
        (batch/bucket.py), one batched dispatch per (op, bucket, nrhs,
        dtype);
      * ``Ragged``: the square factorizations and solves drop the
        bucket from the coalescing key, stack to the flush's largest
        live size rounded to lcm(align, blk), and run the ragged
        kernels (ops/kernels.ragged_potrf/getrf/trsm), which bound
        each element's work by its own order.

    ``Auto`` resolves through the tune cache (``batch/strategy``,
    FROZEN "bucket"), so a cold cache keeps the bucket route."""
    Auto = "auto"
    Bucket = "bucket"
    Ragged = "ragged"

    @staticmethod
    def resolve(dtype=None) -> "MethodBatchStrategy":
        """The tuned/frozen ``batch/strategy`` route; an unknown value
        from a newer cache demotes to Bucket, never an error."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("batch", str(_resolve(
                "batch", "strategy", dtype=dtype)))
        except KeyError:
            m = MethodBatchStrategy.Bucket
        return MethodBatchStrategy.Bucket \
            if m is MethodBatchStrategy.Auto else m


class MethodOOC(enum.Enum):
    """Execution route of the out-of-core streams when a grid is
    supplied: ``Stream`` (the single-device host <-> device stream,
    linalg/ooc.py through linalg/stream.py) or ``Sharded`` (the
    block-cyclic multi-process stream, dist/shard_ooc.py).
    ``Auto`` resolves through the tune cache (``ooc/shard_method``,
    FROZEN "stream"); a measured "sharded" entry is demoted to Stream
    below ``ooc/shard_min_panels`` panels per rank."""
    Auto = "auto"
    Stream = "stream"
    Sharded = "sharded"

    @staticmethod
    def resolve(n: int, nt: int, nranks: int, dtype) -> "MethodOOC":
        """The tuned / frozen ``ooc/shard_method`` route, demoted to
        Stream when the panel count cannot give every rank its
        ``ooc/shard_min_panels`` share; an unknown value from a newer
        cache demotes to Stream, never an error."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("ooc", str(_resolve(
                "ooc", "shard_method", n=n, dtype=dtype)))
        except KeyError:
            m = MethodOOC.Stream
        if m is MethodOOC.Sharded:
            minp = int(_resolve("ooc", "shard_min_panels", n=n,
                                dtype=dtype))
            if nt < minp * max(int(nranks), 1):
                return MethodOOC.Stream
        return MethodOOC.Stream if m is MethodOOC.Auto else m

    @staticmethod
    def lookahead(n: int, dtype) -> int:
        """The sharded stream's broadcast depth (``ooc/shard_lookahead``,
        FROZEN 0), clamped non-negative; a non-integer entry demotes to
        0."""
        from ..tune.select import resolve as _resolve
        try:
            return max(int(_resolve("ooc", "shard_lookahead", n=n,
                                    dtype=dtype)), 0)
        except (TypeError, ValueError):
            return 0


class MethodPrecision(enum.Enum):
    """Arithmetic mode of the out-of-core streams: ``Full`` stages and
    updates in the input dtype; ``Mixed`` keeps the panel FACTOR in the
    input dtype but stages, caches and multiplies the visiting factor
    panels in the lo dtype (refine.lo_dtype: bf16 for f32, f32 for
    f64), and the solves finish with refine.host_ir. ``Auto`` resolves
    through ``ooc/precision`` (FROZEN "f32")."""
    Auto = "auto"
    Full = "f32"
    Mixed = "bf16"

    @staticmethod
    def resolve(n: int, dtype) -> "MethodPrecision":
        """The tuned / frozen ``ooc/precision`` route (an unknown value
        demotes to Full)."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("precision", str(_resolve(
                "ooc", "precision", n=n, dtype=dtype)))
        except KeyError:
            m = MethodPrecision.Full
        return MethodPrecision.Full if m is MethodPrecision.Auto else m


class MethodLUPivot(enum.Enum):
    """Pivot discipline of the out-of-core LU: ``Partial`` (pivoting
    confined to the resident panel, host-side row-swap fixups of the
    written L panels, which retire the cached ones) or ``Tournament``
    (CALU selection before the panel is written: immutable factor
    panels in original row order, no fixups, checkpointable). ``Auto``
    resolves through ``ooc/lu_pivot`` (FROZEN "partial")."""
    Auto = "auto"
    Partial = "partial"
    Tournament = "tournament"

    @staticmethod
    def resolve(n: int, dtype) -> "MethodLUPivot":
        """The tuned / frozen ``ooc/lu_pivot`` route (an unknown value
        demotes to Partial)."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("lu_pivot", str(_resolve(
                "ooc", "lu_pivot", n=n, dtype=dtype)))
        except KeyError:
            m = MethodLUPivot.Partial
        return MethodLUPivot.Partial if m is MethodLUPivot.Auto else m


class MethodScheduler(enum.Enum):
    """Issue loop of the out-of-core streams: ``Walk`` (the hand-written
    panel loops) or ``Graph`` (the same loop bodies as typed nodes of a
    task graph, issued by sched/runtime.py in an order that is a linear
    extension of the walk's, so the results are bitwise the walk's).
    ``Auto`` resolves through ``ooc/scheduler`` (FROZEN "walk")."""
    Auto = "auto"
    Walk = "walk"
    Graph = "graph"

    @staticmethod
    def resolve(n: int, dtype) -> "MethodScheduler":
        """The tuned / frozen ``ooc/scheduler`` route (an unknown value
        demotes to Walk)."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("scheduler", str(_resolve(
                "ooc", "scheduler", n=n, dtype=dtype)))
        except KeyError:
            m = MethodScheduler.Walk
        return MethodScheduler.Walk if m is MethodScheduler.Auto else m


class MethodVisitFuse(enum.Enum):
    """Update granularity of the out-of-core streams: ``PerPanel`` (one
    visit a (panel, earlier panel) pair) or ``Fused`` (a panel's whole
    visit sweep as one update: one wide product for the Cholesky and
    LU visits, the ordered compact-WY applies of QR in one graph node).
    ``Auto`` resolves through ``ooc/visit_fuse`` (FROZEN
    "per_panel")."""
    Auto = "auto"
    PerPanel = "per_panel"
    Fused = "fused"

    @staticmethod
    def resolve(n: int, dtype) -> "MethodVisitFuse":
        """The tuned / frozen ``ooc/visit_fuse`` route (an unknown value
        demotes to PerPanel)."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("visit_fuse", str(_resolve(
                "ooc", "visit_fuse", n=n, dtype=dtype)))
        except KeyError:
            m = MethodVisitFuse.PerPanel
        return MethodVisitFuse.PerPanel \
            if m is MethodVisitFuse.Auto else m


class MethodOwnership(enum.Enum):
    """Panel ownership of the sharded out-of-core stream:
    ``Static`` is the block-cyclic ``CyclicSchedule`` (ownership is
    arithmetic on the panel index, fixed for the stream); ``Elastic``
    re-owns not-yet-factored panels away from slow ranks at segment
    boundaries (dist/elastic.py), bitwise the static result. ``Auto``
    resolves through ``mesh/ownership`` (FROZEN "static")."""
    Auto = "auto"
    Static = "static"
    Elastic = "elastic"

    @staticmethod
    def resolve(n: int, dtype) -> "MethodOwnership":
        """The tuned / frozen ``mesh/ownership`` route (an unknown value
        demotes to Static)."""
        from ..tune.select import resolve as _resolve
        try:
            m = str2method("ownership", str(_resolve(
                "mesh", "ownership", n=n, dtype=dtype)))
        except KeyError:
            m = MethodOwnership.Static
        return MethodOwnership.Static if m is MethodOwnership.Auto \
            else m


class MethodEig(enum.Enum):
    """Eigensolver backend: QR iteration vs divide & conquer."""
    Auto = "auto"
    QRIteration = "qr_iteration"
    DC = "dc"

    @staticmethod
    def select(n: int, want_vectors: bool) -> "MethodEig":
        return MethodEig.DC if want_vectors else MethodEig.QRIteration


class MethodSVD(enum.Enum):
    """SVD backend: the library SVD (Auto, DC) vs the staged QR
    iteration."""
    Auto = "auto"
    QRIteration = "qr_iteration"
    DC = "dc"


def str2method(family: str, s: str):
    fam = {"trsm": MethodTrsm, "gemm": MethodGemm, "hemm": MethodHemm,
           "lu": MethodLU, "factor": MethodFactor,
           "lu_panel": MethodLUPanel, "cholqr": MethodCholQR,
           "gels": MethodGels, "batch": MethodBatchStrategy,
           "eig": MethodEig, "svd": MethodSVD, "ooc": MethodOOC,
           "lu_pivot": MethodLUPivot, "precision": MethodPrecision,
           "scheduler": MethodScheduler,
           "ownership": MethodOwnership,
           "visit_fuse": MethodVisitFuse}[family]
    for mem in fam:
        if mem.value.lower() == s.lower() or mem.name.lower() == s.lower():
            return mem
    raise KeyError(f"unknown {family} method {s!r}")

"""Core enums (counterpart of ``slate_tpu/core/enums.py``).

A copy of the JAX package's vocabulary, so that option dictionaries,
structure flags and method names read the same in both packages. The
values are identical, which lets ``from_jax_state`` map an enum by its
name.
"""

from __future__ import annotations

import enum


class Uplo(enum.Enum):
    """Which triangle of a matrix is referenced (blaspp Uplo)."""

    General = "g"
    Lower = "l"
    Upper = "u"

    def flip(self) -> "Uplo":
        if self is Uplo.Lower:
            return Uplo.Upper
        if self is Uplo.Upper:
            return Uplo.Lower
        return self


class Op(enum.Enum):
    """Transposition flag carried on matrix views."""

    NoTrans = "n"
    Trans = "t"
    ConjTrans = "c"


class Diag(enum.Enum):
    NonUnit = "n"
    Unit = "u"


class Side(enum.Enum):
    Left = "l"
    Right = "r"


class Norm(enum.Enum):
    One = "1"
    Inf = "i"
    Fro = "f"
    Max = "m"


class NormScope(enum.Enum):
    """Reference enums.hh:115: a norm of the whole matrix, or one per
    column or per row."""

    Columns = "c"
    Rows = "r"
    Matrix = "m"


class GridOrder(enum.Enum):
    """Process-grid ordering (reference enums.hh:125)."""

    Col = "c"
    Row = "r"


class Target(enum.Enum):
    """Execution-target compatibility shim (reference enums.hh:34-40);
    accepted for API parity, one execution path per device."""

    Host = "h"
    HostTask = "t"
    HostNest = "n"
    HostBatch = "b"
    Devices = "d"


class TileKind(enum.Enum):
    """Reference Tile.hh:120, kept for API parity: every tile here is
    storage that PyTorch owns."""

    Workspace = "w"
    SlateOwned = "o"
    UserOwned = "u"


class Layout(enum.Enum):
    """Reference layout flag. Storage here is row-major (C-order)
    tensors; kept so layout-sensitive call sites can assert."""

    ColMajor = "c"
    RowMajor = "r"


class Option(enum.Enum):
    """Typed option keys (reference enums.hh:63-99), the same members
    as the JAX package so one options dict drives both."""

    ChunkSize = enum.auto()
    Lookahead = enum.auto()
    BlockSize = enum.auto()
    InnerBlocking = enum.auto()
    MaxPanelThreads = enum.auto()
    Tolerance = enum.auto()
    MaxIterations = enum.auto()
    UseFallbackSolver = enum.auto()
    PivotThreshold = enum.auto()
    Target = enum.auto()
    PrintVerbose = enum.auto()
    PrintEdgeItems = enum.auto()
    PrintWidth = enum.auto()
    PrintPrecision = enum.auto()
    HoldLocalWorkspace = enum.auto()
    Depth = enum.auto()
    MethodCholQR = enum.auto()
    MethodEig = enum.auto()
    MethodGels = enum.auto()
    MethodGemm = enum.auto()
    MethodHemm = enum.auto()
    MethodLU = enum.auto()
    MethodFactor = enum.auto()
    Grid = enum.auto()
    #: utils.trace.Timers instance: drivers record named phase wall
    #: times into it
    Timers = enum.auto()
    MethodTrsm = enum.auto()
    MethodSVD = enum.auto()
    #: per-call autotuning switch (tune/select.py): False bypasses the
    #: measured cache for this call
    Tune = enum.auto()


class MatrixType(enum.Enum):
    """Structure tag for the matrix class hierarchy."""

    General = "ge"
    Trapezoid = "tz"
    Triangular = "tr"
    Symmetric = "sy"
    Hermitian = "he"
    GeneralBand = "gb"
    TriangularBand = "tb"
    HermitianBand = "hb"

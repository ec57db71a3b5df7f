"""Core types (counterpart of ``slate_tpu/core/``)."""

from .enums import (Diag, GridOrder, Layout, MatrixType,  # noqa: F401
                    Norm, NormScope, Op, Option, Side, Target, TileKind,
                    Uplo)
from .exceptions import (DimensionError, OptionError, SlateError,  # noqa: F401
                         slate_assert, slate_error_if)
from .matrix import (BandMatrix, HermitianBandMatrix,  # noqa: F401
                     HermitianMatrix, Matrix, SymmetricMatrix,
                     TrapezoidMatrix, TriangularBandMatrix,
                     TriangularMatrix)
from .methods import (MethodBatchStrategy, MethodCholQR,  # noqa: F401
                      MethodEig, MethodFactor, MethodGels, MethodGemm,
                      MethodHemm, MethodLU, MethodLUPanel, MethodLUPivot,
                      MethodOOC, MethodOwnership, MethodPrecision,
                      MethodScheduler, MethodSVD, MethodTrsm,
                      MethodVisitFuse, str2method)
from .options import (get_option, get_option_tuned,  # noqa: F401
                      normalize_options)
from .tiles import TiledMatrix, ceil_div, next_pow2, round_up  # noqa: F401

"""Core types (counterpart of ``slate_tpu/core/``)."""

from .enums import (Diag, GridOrder, MatrixType, Norm,  # noqa: F401
                    NormScope, Op, Option, Side, Target, Uplo)
from .exceptions import (DimensionError, OptionError, SlateError,  # noqa: F401
                         slate_assert)
from .matrix import (BandMatrix, HermitianBandMatrix,  # noqa: F401
                     HermitianMatrix, Matrix, SymmetricMatrix,
                     TrapezoidMatrix, TriangularBandMatrix,
                     TriangularMatrix)
from .methods import (MethodBatchStrategy, MethodCholQR,  # noqa: F401
                      MethodEig, MethodFactor, MethodGels, MethodLU,
                      MethodLUPanel, MethodLUPivot, MethodOOC,
                      MethodPrecision, MethodScheduler, MethodSVD,
                      MethodVisitFuse)
from .options import get_option, get_option_tuned  # noqa: F401
from .tiles import TiledMatrix, ceil_div, next_pow2, round_up  # noqa: F401

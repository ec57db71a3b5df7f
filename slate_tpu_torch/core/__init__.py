"""Core types (counterpart of ``slate_tpu/core/``)."""

from .enums import (Diag, MatrixType, Norm, NormScope, Op,  # noqa: F401
                    Option, Side, Target, Uplo)
from .exceptions import (DimensionError, OptionError, SlateError,  # noqa: F401
                         slate_assert)
from .matrix import (HermitianBandMatrix, HermitianMatrix,  # noqa: F401
                     Matrix, SymmetricMatrix, TriangularMatrix)
from .methods import (MethodBatchStrategy, MethodCholQR,  # noqa: F401
                      MethodEig, MethodFactor, MethodGels, MethodLU,
                      MethodLUPanel, MethodSVD)
from .options import get_option, get_option_tuned  # noqa: F401
from .tiles import TiledMatrix, ceil_div, next_pow2, round_up  # noqa: F401

"""Core types (counterpart of ``slate_tpu/core/``)."""

from .enums import Diag, MatrixType, Op, Option, Side, Target, Uplo  # noqa: F401
from .exceptions import (DimensionError, OptionError, SlateError,  # noqa: F401
                         slate_assert)
from .matrix import (HermitianMatrix, Matrix, SymmetricMatrix,  # noqa: F401
                     TriangularMatrix)
from .methods import (MethodCholQR, MethodFactor, MethodGels,  # noqa: F401
                      MethodLU, MethodLUPanel)
from .options import get_option, get_option_tuned  # noqa: F401
from .tiles import TiledMatrix, ceil_div, round_up  # noqa: F401

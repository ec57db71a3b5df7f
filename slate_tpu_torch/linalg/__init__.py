"""Linear-algebra drivers (counterpart of ``slate_tpu/linalg/``), the
dense LU slice and its mixed-precision solves."""

from .blas3 import gemm, trsm  # noqa: F401
from .lu import (LUFactors, apply_pivots, gesv, gesv_mixed,  # noqa: F401
                 gesv_mixed_gmres, getrf, getrs)

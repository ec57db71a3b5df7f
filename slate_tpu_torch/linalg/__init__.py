"""Linear-algebra drivers (counterpart of ``slate_tpu/linalg/``), the
dense LU slice."""

from .blas3 import gemm, trsm  # noqa: F401
from .lu import LUFactors, apply_pivots, gesv, getrf, getrs  # noqa: F401

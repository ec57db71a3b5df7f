"""Linear-algebra drivers (counterpart of ``slate_tpu/linalg/``): the
dense LU, Cholesky and QR / least-squares slices and their
mixed-precision solves."""

from .blas3 import (gemm, hemm, her2k, herk, symm, syr2k,  # noqa: F401
                    syrk, trmm, trsm)
from .chol import (pbsv, pbtrf, pbtrs, posv, posv_mixed,  # noqa: F401
                   posv_mixed_gmres, potrf, potri, potrs, trtri, trtrm)
from .lu import (LUFactors, apply_pivots, gesv, gesv_mixed,  # noqa: F401
                 gesv_mixed_gmres, getrf, getrs)
from .qr import (LQFactors, QRFactors, cholqr, gelqf,  # noqa: F401
                 geqrf, gels, gels_cholqr, gels_qr, gels_tsqr, unmlq,
                 unmqr)

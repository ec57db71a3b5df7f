"""Linear-algebra drivers (counterpart of ``slate_tpu/linalg/``): the
dense LU (partial pivot, CALU, no-pivot, inverse, butterfly),
Cholesky and QR / least-squares slices and their mixed-precision
solves, the band LU and Cholesky and the band BLAS, Aasen's
symmetric-indefinite solver, the norms, condition estimators and
elementwise aux drivers, the Hermitian eigensolvers and the SVD, and
the out-of-core streams (``ooc``: host-resident matrices streamed
through the card a column panel at a time, on ``stream``'s engine)."""

from .aux import (add, copy, redistribute, scale,  # noqa: F401
                  scale_row_col, set, set_entries)
from .blas3 import (gbmm, gemm, gemmA, gemmC, hbmm, hemm,  # noqa: F401
                    her2k, herk, symm, syr2k, syrk, tbsm, trmm, trsm,
                    trsmA, trsmB)
from .chol import (pbsv, pbtrf, pbtrs, posv, posv_mixed,  # noqa: F401
                   posv_mixed_gmres, potrf, potri, potrs, trtri, trtrm)
from .lu import (LUFactors, apply_pivots, gbsv, gbtrf,  # noqa: F401
                 gbtrs, gesv, gesv_mixed, gesv_mixed_gmres, gesv_nopiv,
                 gesv_rbt, getrf, getrf_nopiv, getrf_tntpiv, getri,
                 getriOOP, getrs)
from .indefinite import (LTLFactors, hesv, hetrf, hetrs,  # noqa: F401
                         sysv, sytrf, sytrs)
from .cond import gecondest, pocondest, trcondest  # noqa: F401
from .norms import colNorms, norm  # noqa: F401
from .qr import (LQFactors, QRFactors, cholqr, gelqf,  # noqa: F401
                 geqrf, gels, gels_cholqr, gels_qr, gels_tsqr,
                 qr_multiply_by_q, unmlq, unmqr)
from .ca import tournament_pivot_rows, tsqr  # noqa: F401
from .ooc import (gemm_ooc, geqrf_ooc, gels_ooc, gesv_ooc,  # noqa: F401
                  getrf_ooc, getrf_tntpiv_ooc, getrs_ooc, posv_ooc,
                  potrf_ooc, potrs_ooc, unmqr_ooc)
# the streaming engine behind every *_ooc driver (budgets, stats)
from .stream import PanelCache, StreamEngine  # noqa: F401
# the stedc module first: importing a submodule binds its name in this
# package, and the name must end up bound to eig's stedc function
from .stedc import (Deflation, stedc_deflate, stedc_merge,  # noqa: F401
                    stedc_rotate, stedc_secular, stedc_solve,
                    stedc_sort, stedc_z_vector)
from .eig import (EigResult, TridiagResult, eig_vals,  # noqa: F401
                  he2hb, hb2st, hegst, hegv, heev, sterf, stedc,
                  steqr2, sygv, syev, unmtr_hb2st, unmtr_he2hb)
from .svd import (BidiagResult, Ge2tbResult, SVDResult, bdsqr,  # noqa: F401
                  ge2tb, gesvd, svd, svd_vals, tb2bd, unmbr_ge2tb,
                  unmbr_tb2bd)

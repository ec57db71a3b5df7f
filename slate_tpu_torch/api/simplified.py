"""Simplified / modern API names (counterpart of
``slate_tpu/api/simplified.py``; reference include/slate/
simplified_api.hh — multiply :15, triangular_multiply :106,
triangular_solve :129, rank_k_update :172, lu_* :226-362, chol_* :379-
493, indefinite_* :510-578, least_squares_solve :610, qr_* :626-638,
lq_* :655-667, *_rcondest, eig/eig_vals :695-800)."""

from __future__ import annotations

from ..linalg import blas3 as _blas3
from ..linalg import chol as _chol
from ..linalg import cond as _cond
from ..linalg import eig as _eig
from ..linalg import indefinite as _ind
from ..linalg import lu as _lu
from ..linalg import qr as _qr
from ..linalg.svd import svd as _svd_fn, svd_vals as _svd_vals

# BLAS-3
multiply = _blas3.gemm
triangular_multiply = _blas3.trmm
triangular_solve = _blas3.trsm
rank_k_update = _blas3.herk
rank_2k_update = _blas3.her2k
hermitian_multiply = _blas3.hemm
symmetric_multiply = _blas3.symm
band_multiply = _blas3.gbmm

# LU family (simplified_api.hh:226-362)
lu_factor = _lu.getrf
lu_factor_nopiv = _lu.getrf_nopiv
lu_solve = _lu.gesv
lu_solve_nopiv = _lu.gesv_nopiv
lu_solve_using_factor = _lu.getrs
lu_inverse_using_factor = _lu.getri
lu_rcondest_using_factor = _cond.gecondest
band_lu_factor = _lu.gbtrf
band_lu_solve = _lu.gbsv
band_lu_solve_using_factor = _lu.gbtrs

# Cholesky family (:379-493)
chol_factor = _chol.potrf
chol_solve = _chol.posv
chol_solve_using_factor = _chol.potrs
chol_inverse_using_factor = _chol.potri
chol_rcondest_using_factor = _cond.pocondest
band_chol_factor = _chol.pbtrf
band_chol_solve = _chol.pbsv
band_chol_solve_using_factor = _chol.pbtrs

# indefinite (:510-578)
indefinite_factor = _ind.hetrf
indefinite_solve = _ind.hesv
indefinite_solve_using_factor = _ind.hetrs

# least squares / orthogonal (:610-667)
least_squares_solve = _qr.gels
qr_factor = _qr.geqrf
qr_multiply_by_q = _qr.unmqr
lq_factor = _qr.gelqf
lq_multiply_by_q = _qr.unmlq

# condition estimates
triangular_rcondest = _cond.trcondest

# eigen / svd (:695-800)
eig = _eig.heev
eig_vals = _eig.eig_vals
generalized_eig = _eig.hegv
singular_values = _svd_vals
svd_decompose = _svd_fn

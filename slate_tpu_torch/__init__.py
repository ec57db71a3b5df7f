"""slate_tpu_torch — the PyTorch / CUDA port of ``slate_tpu``.

A second package beside the JAX one (``slate_tpu/``, the reference),
ported slice by slice for one NVIDIA H100. Module paths mirror the JAX
package; each module's docstring names its counterpart. Ported so far,
on one device: the dense LU solve (getrf / getrs / gesv with partial
pivoting, getrf_tntpiv with tournament pivoting, getrf_nopiv /
gesv_nopiv, getri / getriOOP, the butterfly gesv_rbt) and its
mixed-precision solves (gesv_mixed, gesv_mixed_gmres: a bf16 factor
refined to f32 accuracy); the norms, condition estimators (gecondest /
pocondest / trcondest) and elementwise aux drivers; the Cholesky family (potrf / potrs /
posv, trtri / trtrm / potri, posv_mixed, posv_mixed_gmres); QR and
least squares (geqrf / unmqr, gelqf / unmlq, cholqr, gels over QR,
CholQR and TSQR); the band solvers (pbtrf / pbtrs / pbsv, gbtrf /
gbtrs / gbsv) and band BLAS (gbmm / hbmm / tbsm); Aasen's
symmetric-indefinite solver (hetrf / hetrs / hesv and the sy*
aliases); the BLAS-3 drivers they use; the user surface (the
``simplified`` names, the scipy-compatible ``api.lapack_compat``,
``generate_matrix``, ``print_matrix``, ``core.func``); the batch layer
(``batch/``: batched drivers, the coalescing queue, bucket and ragged
strategies); the Hermitian eigensolvers (heev, hegv, the staged he2hb /
hb2st / steqr2 / stedc / sterf, and the spectral divide & conquer
``linalg.spectral_dc.eigh_dc`` with its polar iteration) and the SVD
(svd, the staged ge2tb / tb2bd / bdsqr); the hand-written kernels
(``ops/kernels.py``); the autotuner (``tune.autotune``), which measures
the routes to those kernels on the card and persists the winners; and
observability and resilience (``obs``: events, metrics, the flight
recorder, request traces, series, the watchdog, the Perfetto export,
the report; ``resil``: fault injection, retries and the escalation
ladder, checkpoints); and the out-of-core streams (``posv_ooc``,
``gesv_ooc``, ``gels_ooc``, ``gemm_ooc`` and their factor / solve
parts: numpy matrices in host memory streamed through the card a
column panel at a time, with the residency cache and transfer pipeline
of ``linalg.stream`` and the task-graph runtime of ``sched``); the
serving daemon (``serve``: tenants and admission, a factor cache for
repeated operators, a socket front end over the batch queue); and the
LAPACK / ScaLAPACK layout import and export (``core.io`` over the C++
``native`` layout engine); and the in-core distribution (``parallel``:
the p x q process grid over ``torch.distributed``, its collectives and
the 2D block-cyclic layout; ``dist``: the tree engine, grid TSQR, the
distributed steqr2 and stedc, the tuning share): the drivers' grid
routes under ``Option.Grid``, with ``testing.multiproc`` as the
multi-process launcher.

Entry points that create data put it on the CUDA card unless the
caller passes ``device="cpu"``; without a card they raise.
"""

import torch

# The reference computes every f32 product at Precision.HIGHEST (full
# f32). TF32 keeps about three decimal digits, so it is switched off
# for matmuls and for cuDNN alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# The reference's bf16 products accumulate in f32 (Precision.HIGHEST,
# preferred_element_type f32); cuBLAS may otherwise reduce a bf16 GEMM
# in bf16 along the way.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from .core import (BandMatrix, Diag, DimensionError,  # noqa: E402,F401
                   GridOrder, HermitianBandMatrix, HermitianMatrix, Layout,
                   Matrix, MatrixType, Norm, NormScope, MethodBatchStrategy,
                   MethodCholQR, MethodEig, MethodFactor, MethodGels,
                   MethodGemm, MethodHemm, MethodLU, MethodLUPanel,
                   MethodLUPivot, MethodOOC, MethodOwnership,
                   MethodPrecision, MethodScheduler, MethodSVD, MethodTrsm,
                   MethodVisitFuse,
                   Op, Option, OptionError, Side, SlateError,
                   SymmetricMatrix, Target, TiledMatrix, TileKind,
                   TrapezoidMatrix, TriangularBandMatrix, TriangularMatrix,
                   Uplo, ceil_div, get_option, normalize_options, round_up,
                   slate_assert, slate_error_if, str2method)
from .core import (enums, exceptions, matrix, methods,  # noqa: E402,F401
                   options, tiles)
from .interop import from_jax_state  # noqa: E402,F401
from .linalg import (BidiagResult, Deflation,  # noqa: E402,F401
                     EigResult, Ge2tbResult,
                     LQFactors, LTLFactors, LUFactors, QRFactors,
                     SVDResult, TridiagResult, add, apply_pivots, bdsqr,
                     cholqr, colNorms, copy, eig_vals, gbmm, gbsv, gbtrf,
                     gbtrs, gecondest, ge2tb, gelqf, gemm, gemmA, gemmC,
                     gemm_ooc, geqrf, geqrf_ooc, gels, gels_cholqr,
                     gels_ooc, gels_qr, gels_tsqr, gesv, gesv_mixed,
                     gesv_mixed_gmres, gesv_nopiv, gesv_ooc, gesv_rbt,
                     gesvd, getrf, getrf_nopiv, getrf_ooc, getrf_tntpiv,
                     getrf_tntpiv_ooc, getri, getriOOP, getrs, getrs_ooc,
                     hb2st, hbmm, he2hb, heev, hegst,
                     hegv, hemm, her2k, herk, hesv, hetrf, hetrs, norm,
                     PanelCache, pbsv, pbtrf, pbtrs, pocondest, posv,
                     posv_mixed, posv_mixed_gmres, posv_ooc, potrf,
                     potrf_ooc, potri, potrs, potrs_ooc, StreamEngine,
                     qr_multiply_by_q, redistribute, scale,
                     scale_row_col, set, set_entries, stedc,
                     stedc_deflate, stedc_merge, stedc_rotate,
                     stedc_secular, stedc_solve, stedc_sort,
                     stedc_z_vector, steqr2, sterf, svd, svd_vals, syev,
                     sygv, symm, syr2k, syrk, sysv, sytrf, sytrs, tb2bd,
                     tbsm, tournament_pivot_rows, trcondest, trmm, trsm,
                     trsmA, trsmB, trtri, trtrm, tsqr, unmbr_ge2tb,
                     unmbr_tb2bd, unmlq, unmqr, unmqr_ooc, unmtr_hb2st,
                     unmtr_he2hb)
from .linalg import (aux, blas3, blocked, ca, chol,  # noqa: E402,F401
                     cond, eig, indefinite, lu, norms, ooc, qr, stream)
from .matgen import generate_matrix  # noqa: E402,F401
from .utils import Timers, print_matrix, sprint_matrix  # noqa: E402,F401
from . import (api, batch, matgen, obs, ops, resil,  # noqa: E402,F401
               sched, serve, tune)
from . import dist, parallel  # noqa: E402,F401
from .parallel import (ProcessGrid, collectives,  # noqa: E402,F401
                       distribute_cyclic, make_grid, mesh, sharding,
                       single_device_grid, undistribute)
from .api import lapack_compat, simplified  # noqa: E402,F401

__version__ = "0.1.0"

/* slate_tpu_torch C API: flat-function interop layer (counterpart of
 * slate_tpu/c_api/slate_c.h: the same eight functions and signatures,
 * so a C program written against that header builds against this one
 * unchanged).
 *
 * Reference analogue: include/slate/c_api/slate.h +
 * src/c_api/wrappers.cc. The flat functions wrap the PyTorch port by
 * embedding CPython: the first call initializes an interpreter,
 * imports slate_tpu_torch.c_api.bridge, and every entry point hands
 * raw host buffers (by address) to the bridge, which wraps them with
 * ctypes/numpy, runs the driver on the configured device (the CUDA
 * card unless slate_tpu_init names the CPU) and writes results back in
 * place.
 *
 * The embedded interpreter is the one libpython belongs to, with that
 * installation's module path: where the port and torch live elsewhere
 * (a virtual environment), hand their directories over in PYTHONPATH.
 *
 * Conventions (match LAPACK / reference c_api):
 *   - matrices are row-major contiguous (C order), lda == row stride
 *     in elements;
 *   - dtype selects f32/f64 ('s'/'d');
 *   - return value is the LAPACK info code (0 success; < 0 internal /
 *     bridge failure).
 */

#ifndef SLATE_TPU_C_API_H
#define SLATE_TPU_C_API_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Initialize the embedded runtime explicitly (optional: every entry
 * point initializes lazily). platform names the device: "cpu", "cuda"
 * ("gpu" is taken as "cuda"), or NULL for the default, the CUDA card.
 * Returns 0 on success. */
int slate_tpu_init(const char* platform);

/* Cholesky factorization, lower triangle, in place (potrf). */
int slate_potrf(char dtype, int64_t n, void* a, int64_t lda);

/* Solve A X = B by LU with partial pivoting (gesv); A is overwritten
 * with the packed factors, B with the solution, ipiv (length n,
 * 0-based swap targets) with the pivots. */
int slate_gesv(char dtype, int64_t n, int64_t nrhs, void* a,
               int64_t lda, int32_t* ipiv, void* b, int64_t ldb);

/* SPD solve A X = B via Cholesky (posv); A overwritten with L,
 * B with X. */
int slate_posv(char dtype, int64_t n, int64_t nrhs, void* a,
               int64_t lda, void* b, int64_t ldb);

/* C := alpha A B + beta C (gemm), all row-major. */
int slate_gemm(char dtype, int64_t m, int64_t n, int64_t k,
               double alpha, const void* a, int64_t lda,
               const void* b, int64_t ldb,
               double beta, void* c, int64_t ldc);

/* Least squares min ||A x - b|| (gels), m >= n; solution in the first
 * n rows of B. A is clobbered. */
int slate_gels(char dtype, int64_t m, int64_t n, int64_t nrhs,
               void* a, int64_t lda, void* b, int64_t ldb);

/* Hermitian eigenvalues (ascending) into w; A clobbered (heev). */
int slate_heev(char dtype, int64_t n, void* a, int64_t lda, void* w);

/* Singular values (descending) into s, length min(m,n) (svd_vals). */
int slate_svd_vals(char dtype, int64_t m, int64_t n, void* a,
                   int64_t lda, void* s);

#ifdef __cplusplus
}
#endif

#endif /* SLATE_TPU_C_API_H */

// Lower Cholesky of one SPD block: the device work of ops/kernels.py
// chol_panel.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_chol_fused_pallas (the
// reference's fused Cholesky of a block of order n <= 1024, n % 128 ==
// 0, f32). Its order is kept: 128-wide column stripes, left to right;
// each stripe first takes the left-looking update
//   S = A[k0:, k0:k1] - L[k0:, :k0] L[k0:k1, :k0]^T
// (products summed in f32, the sum subtracted once), then a per-column
// recurrence inside it: d = sqrt(s_jj), v = s_j / d below the diagonal
// (d == 0 -> divide by 1), s_jj = d, and the rank-1 update
// s_rc -= v_r v_c of the stripe's columns c > j. Only the lower
// triangle is read; the result has zeros above the diagonal, as the
// reference's. f32 only; products and differences in the recurrence use
// __fmul_rn/__fsub_rn, so it rounds as the plain PyTorch version does.
//
// Bound on an H100: n^3 / 3 FLOPs, 358 MFLOP at n = 1024, 5.3 us at the
// f32 rate (4 MB read and written: 2.5 us). The recurrence is
// latency-bound: 1024 columns in sequence. Design, two launches a
// stripe: the left-looking update is the tiled GEMM-with-subtract of
// gemm_sub.cuh (op(B) = B^T), gridded over 64 x 64 output tiles, which
// updates the stripe of the working copy `w` in place from the finished
// columns of the factor `l`; the recurrence is one launch of blocks that
// each own up to 32 rows below the stripe's diagonal block and keep them
// in shared memory with a copy of the diagonal block (128 x 128 f32,
// 64 KB). Every block factors the diagonal block itself, identically, so
// the multipliers v_c of the rank-1 updates are at hand everywhere and
// no block waits on another: there is no grid barrier. The recurrence
// reads only `w` and writes only `l`, so no block can read what another
// has already written, whatever order the blocks start in (the `serial`
// argument launches them one at a time, block 0 first, to show it). Not
// done: the two launches of a stripe are not fused, and the GEMM uses
// CUDA cores (TF32 is off, so the tensor cores could not take f32
// products exactly).

#include <cuda_runtime.h>

#include "gemm_sub.cuh"

namespace {

constexpr int CB = 128;               // stripe width (_CHOL_BLK)
constexpr int CB_LD = CB + 1;         // padded row of the diagonal copy
constexpr int CH_THREADS = 256;
constexpr int CH_ROWS = 32;           // rows below the stripe per block

// Factor the stripe [k0, k0 + CB) of the row-major (n, n) working copy
// `w`, its left-looking update already applied, into the same columns
// of the factor `l`. Block b0 + blockIdx.x owns rows
// [k0 + CB + b * CH_ROWS, ...) below the diagonal block; block 0 also
// writes the diagonal block.
__global__ void __launch_bounds__(CH_THREADS)
chol_stripe_kernel(const float* __restrict__ w, float* __restrict__ l,
                   int n, int k0, int b0) {
    extern __shared__ float smem[];
    float* D = smem;                          // CB x CB_LD
    float* X = D + CB * CB_LD;                // CH_ROWS x CB
    const int tid = threadIdx.x, b = b0 + blockIdx.x;
    const int r_lo = k0 + CB + b * CH_ROWS;
    const int nr = max(0, min(n, r_lo + CH_ROWS) - r_lo);

    for (int e = tid; e < CB * CB; e += CH_THREADS) {
        const int r = e / CB, c = e % CB;
        D[r * CB_LD + c] = w[(long)(k0 + r) * n + k0 + c];
    }
    for (int e = tid; e < nr * CB; e += CH_THREADS) {
        const int r = e / CB, c = e % CB;
        X[e] = w[(long)(r_lo + r) * n + k0 + c];
    }
    __syncthreads();

    for (int jj = 0; jj < CB; ++jj) {
        const float d = sqrtf(D[jj * CB_LD + jj]);
        const float dsafe = d == 0.f ? 1.f : d;
        for (int r = jj + 1 + tid; r < CB; r += CH_THREADS)
            D[r * CB_LD + jj] = __fdiv_rn(D[r * CB_LD + jj], dsafe);
        for (int r = tid; r < nr; r += CH_THREADS)
            X[r * CB + jj] = __fdiv_rn(X[r * CB + jj], dsafe);
        __syncthreads();
        if (tid == 0) D[jj * CB_LD + jj] = d;
        // rank-1 update of the columns c > jj: the diagonal block's lower
        // triangle (rows r >= c), then this block's rows
        const int ncol = CB - jj - 1;
        for (int e = tid; e < ncol * ncol; e += CH_THREADS) {
            const int r = jj + 1 + e / ncol, c = jj + 1 + e % ncol;
            if (r >= c)
                D[r * CB_LD + c] = __fsub_rn(
                    D[r * CB_LD + c],
                    __fmul_rn(D[r * CB_LD + jj], D[c * CB_LD + jj]));
        }
        for (int e = tid; e < nr * ncol; e += CH_THREADS) {
            const int r = e / ncol, c = jj + 1 + e % ncol;
            X[r * CB + c] = __fsub_rn(
                X[r * CB + c], __fmul_rn(X[r * CB + jj], D[c * CB_LD + jj]));
        }
        __syncthreads();
    }

    if (b == 0)
        for (int e = tid; e < CB * CB; e += CH_THREADS) {
            const int r = e / CB, c = e % CB;
            l[(long)(k0 + r) * n + k0 + c] = r >= c ? D[r * CB_LD + c] : 0.f;
        }
    for (int e = tid; e < nr * CB; e += CH_THREADS) {
        const int r = e / CB, c = e % CB;
        l[(long)(r_lo + r) * n + k0 + c] = X[e];
    }
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The lower Cholesky factor of the (n, n) row-major f32 block `w`
// (n % 128 == 0) into `l`, which must hold zeros (the entries above the
// diagonal are not written); `w` is overwritten (the stripes' updates).
// serial != 0 launches each stripe's blocks one at a time, block 0
// first. Returns a cudaError_t.
int chol_panel(float* w, float* l, int n, int serial, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t smem = sizeof(float) * ((size_t)CB * CB_LD + CH_ROWS * CB);
    cudaError_t e = cudaFuncSetAttribute(
        chol_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    for (int k0 = 0; k0 < n; k0 += CB) {
        if (k0 > 0) {
            // S = W[k0:, k0:k0+CB] - L[k0:, :k0] L[k0:k0+CB, :k0]^T
            float* stripe = w + (long)k0 * n + k0;
            const float* left = l + (long)k0 * n;
            const int rc = slate_torch::launch_gemm_sub<float, true>(
                stripe, n, left, n, left, n, stripe, n, n - k0, CB, k0, s);
            if (rc != 0) return rc;
        }
        const int below = n - k0 - CB;
        const int blocks = below > 0 ? (below + CH_ROWS - 1) / CH_ROWS : 1;
        if (serial) {
            for (int b = 0; b < blocks; ++b)
                chol_stripe_kernel<<<1, CH_THREADS, smem, s>>>(w, l, n, k0,
                                                               b);
        } else {
            chol_stripe_kernel<<<blocks, CH_THREADS, smem, s>>>(w, l, n, k0,
                                                                0);
        }
        const cudaError_t last = cudaGetLastError();
        if (last != cudaSuccess) return (int)last;
    }
    return 0;
}

}  // extern "C"

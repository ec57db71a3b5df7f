// Ragged batched lower Cholesky: the device work of ops/kernels.py
// ragged_potrf.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_potrf_pallas (a grid
// over the batch, each element rebuilt as blkdiag(A[:s, :s], I) and
// factored by ceil(s/blk) left-looking stripes). The same stripes here,
// over the live block only: for k0 = 0, blk, ... < s, with cw =
// min(blk, s - k0),
//   S = A[k0:s, k0:k0+cw] - T(L[k0:s, :k0] L[k0:k0+cw, :k0]^T)
// (products summed in f32, the sum rounded to the storage type T, the
// subtract rounded to T), then the column recurrence inside the stripe:
// d = sqrt(s_jj) (d == 0 divides by 1), v = T(s_j / d) below the
// diagonal, s_jj = T(d), s_rc = T(s_rc - T(v_r v_c)) for the stripe's
// columns c > j. The live block comes back lower-triangular; the pad
// comes back as the identity (the reference's tril of the identity)
// and is never read, whatever the stacker left there. T is f32 or
// bf16; arithmetic is f32 with __fmul_rn/__fsub_rn/__fdiv_rn, so it
// rounds as the plain PyTorch version does.
//
// Bound on an H100: sum s^3/3 f32 operations over the batch (67
// TFLOP/s on CUDA cores), or the live bytes read and written, whichever
// is larger; for a serving flush of 64 elements of order ~200-1000 the
// operations dominate. Design: one block of 256 threads per element
// (no inter-block traffic, so elements run side by side on the SMs).
// The left-looking update is the shared-memory-tiled GEMM of
// gemm_sub.cuh walked by that one block (op(B) = B^T, read from the
// finished columns of the output); the stripe's column recurrence runs
// in shared memory, N x 33 f32 (132 KiB at N = 1024, rows padded to 33
// so column walks are free of bank conflicts), two block barriers a
// column. Not done: tensor cores, several blocks per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sub.cuh"
#include "ragged.cuh"

namespace {

using namespace slate_torch;

constexpr int SLD = RG_MAX_BLK + 1;   // padded stripe row

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
ragged_potrf_kernel(const T* a_all, T* o_all, const int* sizes, int n,
                    int blk) {
    extern __shared__ float S[];   // (s - k0) x SLD stripe
    const int tid = threadIdx.x;
    const long off = (long)blockIdx.x * n * n;
    const T* a = a_all + off;
    T* o = o_all + off;
    const int s = ragged_order(sizes, blockIdx.x, n);
    ragged_write_pad(o, n, s);

    for (int k0 = 0; k0 < s; k0 += blk) {
        const int cw = min(blk, s - k0), nr = s - k0;
        const T* src = a;
        if (k0 > 0) {
            // left-looking update into the output's stripe, from the
            // factor's finished columns [0, k0)
            cta_gemm_sub<T, true>(a + (long)k0 * n + k0, n,
                                  o + (long)k0 * n, n, o + (long)k0 * n, n,
                                  o + (long)k0 * n + k0, n, nr, cw, k0);
            __syncthreads();
            src = o;
        }
        for (int e = tid; e < nr * cw; e += RG_THREADS) {
            const int r = e / cw, c = e % cw;
            S[r * SLD + c] = to_f(src[(long)(k0 + r) * n + k0 + c]);
        }
        for (int jj = 0; jj < cw; ++jj) {
            __syncthreads();
            const float d = sqrtf(S[jj * SLD + jj]);
            const float dsafe = d == 0.f ? 1.f : d;
            for (int r = jj + 1 + tid; r < nr; r += RG_THREADS)
                S[r * SLD + jj] = rnd<T>(__fdiv_rn(S[r * SLD + jj], dsafe));
            __syncthreads();
            if (tid == 0) S[jj * SLD + jj] = rnd<T>(d);
            const int ncol = cw - jj - 1;
            for (int e = tid; e < (nr - jj - 1) * ncol; e += RG_THREADS) {
                const int r = jj + 1 + e / ncol, c = jj + 1 + e % ncol;
                S[r * SLD + c] = rnd<T>(__fsub_rn(
                    S[r * SLD + c],
                    rnd<T>(__fmul_rn(S[r * SLD + jj], S[c * SLD + jj]))));
            }
        }
        __syncthreads();
        for (int e = tid; e < nr * cw; e += RG_THREADS) {
            const int r = e / cw, c = e % cw;
            o[(long)(k0 + r) * n + k0 + c] =
                from_f<T>(r >= c ? S[r * SLD + c] : 0.f);
        }
        for (int e = tid; e < k0 * cw; e += RG_THREADS) {
            const int r = e / cw, c = e % cw;
            o[(long)r * n + k0 + c] = from_f<T>(0.f);
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const void* a, void* o, const int* sizes, int batch, int n,
           int blk, cudaStream_t stream) {
    if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
    if (blk < 1 || blk > RG_MAX_BLK) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)n * SLD;
    const int rc = ragged_smem(ragged_potrf_kernel<T>, smem);
    if (rc != 0) return rc;
    ragged_potrf_kernel<T><<<batch, RG_THREADS, smem, stream>>>(
        (const T*)a, (T*)o, sizes, n, blk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The (batch, n, n) row-major stack `a` (f32, or bf16 with bf16 != 0)
// factored into `o` (which may be `a`) with per-element orders
// `sizes` (int32, device), stripes of `blk` <= 32 columns, on `stream`.
// Returns a cudaError_t.
int ragged_potrf(const void* a, void* o, const int* sizes, int batch, int n,
                 int blk, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(a, o, sizes, batch, n, blk, s)
                : launch<float>(a, o, sizes, batch, n, blk, s);
}

}  // extern "C"

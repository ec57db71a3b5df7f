// Ragged batched triangular solve: the device work of ops/kernels.py
// ragged_trsm.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_trsm_pallas (a grid
// over the batch; per element a blocked substitution over ceil(s/blk)
// blocks of the effective system, backward when upper != trans). Per
// block, as the reference: the rows in order, each
//   x_r = T((x_r - w . x_solved) / d)
// over the block's rows already solved (w is row r of the packed
// factor, or its column r when trans; d = 1 with a unit diagonal, a
// zero d divides by 1; the sum in f32), then the update of the rows
// still to solve, x_t = T(x_t - T(sum_i t_ti x_i)) (t_it when trans).
// All eight (upper, trans, unit) combinations. Only the live s x s
// block of the factors and the first s rows of the right-hand side are
// read; rows past s come back zero. T is f32 or bf16, arithmetic f32.
//
// Bound on an H100: sum s^2 K f32 operations, or the bytes of the live
// factors and right-hand sides, whichever is larger; at the serving
// shape (K = 1) the bytes. Design: one warp per right-hand-side column
// (the columns are independent, so no block barrier at all), up to 8
// warps a block, a grid of (batch, ceil(K / 8)). A warp keeps its
// column in shared memory; a substitution row is a 32-lane dot reduced
// by shuffles, an update row one lane's dot over the block. Not done:
// blocking several columns per warp, coalescing the transposed reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ragged.cuh"

namespace {

using namespace slate_torch;

constexpr int TR_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(TR_WARPS * 32)
ragged_trsm_kernel(const T* t_all, const T* b_all, T* o_all,
                   const int* sizes, int n, int K, int blk, int upper,
                   int trans, int unit) {
    extern __shared__ float xs[];   // one column of n per warp
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int k = blockIdx.y * (blockDim.x >> 5) + warp;
    if (k >= K) return;
    float* x = xs + (long)warp * n;
    const int s = ragged_order(sizes, blockIdx.x, n);
    const T* t = t_all + (long)blockIdx.x * n * n;
    const T* rhs = b_all + (long)blockIdx.x * n * K;
    T* o = o_all + (long)blockIdx.x * n * K;
    for (int r = lane; r < s; r += 32) x[r] = to_f(rhs[(long)r * K + k]);
    __syncwarp();

    const bool back = (upper != 0) != (trans != 0);
    const int nblk = (s + blk - 1) / blk;
    for (int kbi = 0; kbi < nblk; ++kbi) {
        const int kb = back ? nblk - 1 - kbi : kbi;
        const int k0 = kb * blk, k1 = min(k0 + blk, s);
        for (int ri = 0; ri < k1 - k0; ++ri) {
            const int r = back ? k1 - 1 - ri : k0 + ri;
            const int lo = back ? r + 1 : k0, hi = back ? k1 : r;
            const int i = lo + lane;
            float part = 0.f;
            if (i < hi)
                part = __fmul_rn(to_f(trans ? t[(long)i * n + r]
                                            : t[(long)r * n + i]),
                                 x[i]);
            for (int sh = 16; sh > 0; sh >>= 1)
                part = __fadd_rn(part,
                                 __shfl_down_sync(0xffffffffu, part, sh));
            if (lane == 0) {
                float d = unit ? 1.f : to_f(t[(long)r * n + r]);
                if (d == 0.f) d = 1.f;
                x[r] = rnd<T>(__fdiv_rn(__fsub_rn(x[r], part), d));
            }
            __syncwarp();
        }
        const int lo = back ? 0 : k1, hi = back ? k0 : s;
        for (int c = lo + lane; c < hi; c += 32) {
            float acc = 0.f;
            for (int i = k0; i < k1; ++i)
                acc = fmaf(to_f(trans ? t[(long)i * n + c]
                                      : t[(long)c * n + i]),
                           x[i], acc);
            x[c] = rnd<T>(__fsub_rn(x[c], rnd<T>(acc)));
        }
        __syncwarp();
    }
    for (int r = lane; r < n; r += 32)
        o[(long)r * K + k] = from_f<T>(r < s ? x[r] : 0.f);
}

template <typename T>
int launch(const void* t, const void* b, void* o, const int* sizes,
           int batch, int n, int K, int blk, int upper, int trans, int unit,
           cudaStream_t stream) {
    if (batch <= 0 || n <= 0 || K <= 0) return (int)cudaGetLastError();
    if (blk < 1 || blk > RG_MAX_BLK) return (int)cudaErrorInvalidValue;
    const int warps = K < TR_WARPS ? K : TR_WARPS;
    const size_t smem = sizeof(float) * (size_t)warps * n;
    const int rc = ragged_smem(ragged_trsm_kernel<T>, smem);
    if (rc != 0) return rc;
    const dim3 grid(batch, (K + warps - 1) / warps);
    ragged_trsm_kernel<T><<<grid, warps * 32, smem, stream>>>(
        (const T*)t, (const T*)b, (T*)o, sizes, n, K, blk, upper, trans,
        unit);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Solve the (batch, n, n) row-major factors `t` against the (batch, n, K)
// right-hand sides `b` into `o` (which may be `b`), per-element orders
// `sizes` (int32, device), blocks of `blk` <= 32 rows, the
// upper / transposed / unit-diagonal system as flagged, f32 or bf16
// (bf16 != 0), on `stream`. Returns a cudaError_t.
int ragged_trsm(const void* t, const void* b, void* o, const int* sizes,
                int batch, int n, int K, int blk, int upper, int trans,
                int unit, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(t, b, o, sizes, batch, n, K, blk,
                                        upper, trans, unit, s)
                : launch<float>(t, b, o, sizes, batch, n, K, blk, upper,
                                trans, unit, s);
}

}  // extern "C"

// Shared-memory-tiled GEMM-with-subtract: D = T(C - T(A * op(B))).
//
// One block walking all tiles (cta_gemm_sub): the per-element updates
// of ragged_getrf.cu. (The recursive LU panel's product update, the
// trailing update of its tall split and the Cholesky block use
// sgemm_tile.cuh and the tensor cores instead.) All operands are row-major
// strided views of one storage type T (float or __nv_bfloat16); D may
// alias C (each element is read and then written by the same thread),
// and A and B must not overlap D.
//
// Arithmetic is the reference's (pallas_kernels.py :490-494, :606-611):
// the products accumulate in f32, the sum is rounded to T, and the
// subtract is an f32 op rounded to T. For f32 both roundings are the
// identity.
//
// Bound on an H100: f32 CUDA-core FLOPs (TF32 is off, and wgmma has no
// f32 inputs); for bf16 the tensor cores could take the products, which
// this kernel does not use yet. Design: 64x64 output tiles, 16-deep K
// slabs staged in shared memory as f32, 256 threads each accumulating a
// 4x4 register block with fmaf; rows/columns strided by 16 so the
// shared-memory reads are conflict-free broadcasts. Ragged edges are
// masked with zero fill, so any M, N, K is taken. Not tuned: no double
// buffering, no cp.async, no wgmma.

#pragma once

#include <cuda_runtime.h>

#include "coop.cuh"

namespace slate_torch {

constexpr int GS_BM = 64;
constexpr int GS_BN = 64;
constexpr int GS_BK = 16;
constexpr int GS_THREADS = 256;

// BT: B is given as its transpose, (N, K) row-major with leading
// dimension ldb, and op(B) = B^T.
// The 64x64 tile of D at (row0, col0), by the GS_THREADS threads of
// the calling block.
template <typename T, bool BT>
__device__ __forceinline__ void
gemm_sub_tile(const T* C, long ldc, const T* __restrict__ A, long lda,
              const T* __restrict__ B, long ldb, T* D, long ldd, int M,
              int N, int K, int row0, int col0) {
    __shared__ float As[GS_BK][GS_BM + 4];   // A tile, k-major
    __shared__ float Bs[GS_BK][GS_BN + 4];
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += GS_BK) {
        for (int e = tid; e < GS_BM * GS_BK; e += GS_THREADS) {
            const int r = e / GS_BK, c = e % GS_BK;
            const int gr = row0 + r, gc = k0 + c;
            As[c][r] = (gr < M && gc < K) ? to_f(A[(long)gr * lda + gc])
                                          : 0.f;
        }
        for (int e = tid; e < GS_BK * GS_BN; e += GS_THREADS) {
            // neighbouring threads on neighbouring addresses of B
            const int r = BT ? e % GS_BK : e / GS_BN;
            const int c = BT ? e / GS_BK : e % GS_BN;
            const int gr = k0 + r, gc = col0 + c;
            const long at = BT ? (long)gc * ldb + gr : (long)gr * ldb + gc;
            Bs[r][c] = (gr < K && gc < N) ? to_f(B[at]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < GS_BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty + 16 * i;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = col0 + tx + 16 * j;
            if (c < N)
                D[(long)r * ldd + c] = from_f<T>(__fsub_rn(
                    to_f(C[(long)r * ldc + c]), rnd<T>(acc[i][j])));
        }
    }
}

// D = C - A op(B) by ONE block of GS_THREADS threads walking every
// tile of D in turn (the per-element updates of the ragged kernels,
// one block per element). The caller synchronises the block before it
// reads D.
template <typename T, bool BT>
__device__ void cta_gemm_sub(const T* C, long ldc, const T* A, long lda,
                             const T* B, long ldb, T* D, long ldd, int M,
                             int N, int K) {
    for (int row0 = 0; row0 < M; row0 += GS_BM)
        for (int col0 = 0; col0 < N; col0 += GS_BN)
            gemm_sub_tile<T, BT>(C, ldc, A, lda, B, ldb, D, ldd, M, N, K,
                                 row0, col0);
}

}  // namespace slate_torch

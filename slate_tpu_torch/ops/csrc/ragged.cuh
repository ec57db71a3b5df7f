// What the three ragged batched kernels share (ragged_potrf.cu,
// ragged_getrf.cu, ragged_trsm.cu): one block per element of a
// (B, N, N) stack, each element's live order s read from the device
// sizes vector (clamped to [0, N]), and the pad written, never read.
//
// The reference rebuilds blkdiag(A[:s, :s], I) inside its kernels and
// runs masked whole-ceiling operations; here each block works on the
// live s x s block only and writes the pad directly. Both give the
// same result because the identity pad factors (and solves) to itself.

#pragma once

#include <cuda_runtime.h>

#include "coop.cuh"

namespace slate_torch {

// Threads of a ragged potrf / getrf block: the tile walker's count
// (gemm_sub.cuh GS_THREADS).
constexpr int RG_THREADS = 256;
// Widest stripe (ops/kernels.py RAGGED_MAX_BLK): one lane a column.
constexpr int RG_MAX_BLK = 32;

__device__ __forceinline__ int ragged_order(const int* sizes, int b, int n) {
    const int s = sizes[b];
    return s < 0 ? 0 : (s > n ? n : s);
}

// Every entry of the (n, n) element `o` outside its live s x s block
// set to the identity's.
template <typename T>
__device__ void ragged_write_pad(T* o, int n, int s) {
    const long right = (long)s * (n - s);       // rows < s, cols >= s
    const long below = (long)(n - s) * n;       // rows >= s
    for (long e = threadIdx.x; e < right; e += blockDim.x) {
        const long r = e / (n - s), c = s + e % (n - s);
        o[r * n + c] = from_f<T>(0.f);
    }
    for (long e = threadIdx.x; e < below; e += blockDim.x) {
        const long r = s + e / n, c = e % n;
        o[r * n + c] = from_f<T>(r == c ? 1.f : 0.f);
    }
}

// The live block of `a` copied to `o` (nothing to do in place).
template <typename T>
__device__ void ragged_copy_live(const T* a, T* o, int n, int s) {
    if (a == o) return;
    for (long e = threadIdx.x; e < (long)s * s; e += blockDim.x) {
        const long r = e / s, c = e % s;
        o[r * n + c] = a[r * n + c];
    }
}

// Large dynamic shared memory for `kernel`, then the launch status.
template <typename Kernel>
int ragged_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    return 0;
}

}  // namespace slate_torch

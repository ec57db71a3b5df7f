// What the three ragged batched kernels share (ragged_potrf.cu,
// ragged_getrf.cu, ragged_trsm.cu): each element of a (B, N, N) stack
// has its live order s read from the device sizes vector (clamped to
// [0, N]), and its pad written, never read.
//
// The reference rebuilds blkdiag(A[:s, :s], I) inside its kernels and
// runs masked whole-ceiling operations; here each element's blocks work
// on the live s x s block only and write the pad directly. Both give
// the same result because the identity pad factors (and solves) to
// itself.

#pragma once

#include <cuda_runtime.h>

#include "coop.cuh"

namespace slate_torch {

// Widest stripe (ops/kernels.py RAGGED_MAX_BLK): one lane a column.
constexpr int RG_MAX_BLK = 32;

__device__ __forceinline__ int ragged_order(const int* sizes, int b, int n) {
    const int s = sizes[b];
    return s < 0 ? 0 : (s > n ? n : s);
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

// What the cooperative panel kernels share: the storage type <-> f32
// conversions with the panel type's rounding, the grid-wide barrier, and
// the cooperative launch of up to one block per SM.
//
// The barrier and the launch are used by the LU segment factorization
// (lu_base.cuh: the rank-1 panel, and the recursive panel's wider
// segments); the conversions by every panel kernel. A cooperative
// kernel here keeps its row slice of the panel in shared memory for the
// whole call; the only cross-block traffic is what a column's reduction
// posts between two barriers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace slate_torch {

// -- storage type <-> f32, and the panel type's rounding -----------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// x rounded to T and back: the identity for f32
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// -- the grid barrier ----------------------------------------------------

// Grid-wide barrier over a co-resident (cooperative) grid: a counter
// that only grows; barrier number `epoch` waits for epoch * nblocks
// arrivals. The counter is zeroed before each launch.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int epoch) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(count, 1u);
        const unsigned int target = epoch * gridDim.x;
        while (*(volatile unsigned int*)count < target) __nanosleep(20);
        __threadfence();
    }
    __syncthreads();
}

// -- the cooperative launch ----------------------------------------------

// Number of SMs of the current device.
inline int sm_count() {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

// Blocks of a row-sliced cooperative launch over m rows: at least
// `min_rows` rows per block, at most one block per SM and `max_blocks`.
inline int coop_blocks(int m, int min_rows, int max_blocks) {
    int blocks = sm_count();
    blocks = blocks < max_blocks ? blocks : max_blocks;
    const int by_rows = (m + min_rows - 1) / min_rows;
    blocks = blocks < by_rows ? blocks : by_rows;
    return blocks > 1 ? blocks : 1;
}

// Launch `kernel` cooperatively on `stream` with `smem` bytes of dynamic
// shared memory after checking that one block fits on an SM (so every
// block of a grid of at most one block per SM is co-resident, which the
// grid barrier needs). The barrier counter is zeroed first. Returns a
// cudaError_t.
template <typename Kernel>
int coop_launch(Kernel kernel, int blocks, int threads, size_t smem,
                void** args, unsigned int* barrier, cudaStream_t stream) {
    cudaError_t e = cudaSuccess;
    int per_sm = 0;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cudaMemsetAsync(barrier, 0, sizeof(unsigned int), stream);
    e = cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks),
                                    dim3(threads), args, smem, stream);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

}  // namespace slate_torch

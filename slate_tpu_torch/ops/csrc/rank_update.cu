// Trailing update of the tall-panel split: out = A22 - L21 @ U12.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_rank_update_pallas, which
// grids the same product over row blocks rb in {2048 ... 128} because
// VMEM holds one (rb, w) block at a time. Here the 64x64 output tiles
// of gemm_sub.cuh are the row (and column) grid, and the kernel masks
// its own ragged edge, so it takes every height m2, not only the
// multiples of a row-block height; the port launches it for every
// height (ops/kernels.py _rank_update).
//
// Bound on an H100: f32 CUDA-core FLOPs (2 m2 w1 w2; TF32 is off);
// design as in gemm_sub.cuh. Operands are row-major and contiguous;
// the wrapper allocates `out`.

#include <cuda_runtime.h>

#include "gemm_sub.cuh"

// Make `device` current for this library's runtime.
extern "C" int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

extern "C" int rank_update(const float* a22, const float* l21,
                           const float* u12, float* out, int m2, int w2,
                           int w1, void* stream) {
    return slate_torch::launch_gemm_sub(a22, w2, l21, w1, u12, w2, out, w2,
                                        m2, w2, w1, (cudaStream_t)stream);
}

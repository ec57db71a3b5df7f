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
// f32 and bf16 operands (bf16 != 0): the products accumulate in f32,
// then out = T(A22 - T(P)), as the reference's
// `a - P.astype(a.dtype)`.
//
// Bound on an H100: f32 CUDA-core FLOPs (2 m2 w1 w2; TF32 is off); for
// bf16 the tensor cores could do the products at 989 TFLOP/s, so there
// the bound is the bytes. Design as in gemm_sub.cuh. Operands are
// row-major and contiguous; the wrapper allocates `out`.

#include <cuda_runtime.h>

#include "gemm_sub.cuh"

// Make `device` current for this library's runtime.
extern "C" int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

extern "C" int rank_update(const void* a22, const void* l21,
                           const void* u12, void* out, int m2, int w2,
                           int w1, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
        typedef __nv_bfloat16 T;
        return slate_torch::launch_gemm_sub<T>(
            (const T*)a22, w2, (const T*)l21, w1, (const T*)u12, w2,
            (T*)out, w2, m2, w2, w1, s);
    }
    return slate_torch::launch_gemm_sub<float>(
        (const float*)a22, w2, (const float*)l21, w1, (const float*)u12,
        w2, (float*)out, w2, m2, w2, w1, s);
}

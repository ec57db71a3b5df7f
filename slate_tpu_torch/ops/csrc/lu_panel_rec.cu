// Block-recursive partial-pivot LU panel: the device work of
// ops/kernels.py lu_panel_rec.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_lu_panel_rec_pallas. The
// Pallas kernel recurses over widths at trace time inside one
// dispatch; here the same recursion runs on the host (kernels.py
// _lu_panel_rec_cuda) and launches three kernels on one stream:
//
//   lu_rec_base       the ib-wide base case: the cooperative segment
//                     factorization of lu_base.cuh (argmax pivot
//                     search, lowest row wins ties, full-row swap,
//                     safe-divide multipliers, rank-1 update confined
//                     to the segment);
//   lu_rec_solve_leaf the ib-row unit-lower substitution of the
//                     recursive triangular solve;
//   lu_rec_mm_update  out[r0:r1, c0:c1] -= out[r0:r1, k0:k1] @
//                     out[k0:k1, c0:c1], the tiled GEMM of
//                     gemm_sub.cuh on strided views of the panel.
//
// The panel is row-major (m, w), f32 or bf16 (the `bf16` argument),
// updated in place in the output buffer the wrapper allocates. Pivots
// come back as int32 swap targets. Arithmetic is f32 with the
// reference's rounding to the panel type: the leaf computes
// x = T(x - T(l * r)) (pallas_kernels.py:557-558), the product update
// T(out - T(P)) with P accumulated in f32. Products and differences
// use __fmul_rn/__fsub_rn (no FMA contraction), so they round exactly
// as the plain PyTorch version's outer-product-then-subtract does.
//
// Bound on an H100: the base case is latency-bound (lu_base.cuh); the
// updates are bound by f32 CUDA-core FLOPs. (A first version ran the
// base case as a single block over the whole panel: PERF.md has its
// times.) Not done yet: fusing the leaf and product launches, a
// persistent kernel for the whole recursion, tensor cores for bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sub.cuh"
#include "lu_base.cuh"

namespace {

using slate_torch::from_f;
using slate_torch::rnd;
using slate_torch::to_f;

constexpr int LEAF_THREADS = 128;
constexpr int LEAF_MAX_WS = 32;         // register path of the leaf

// rows [c0, c0+ws) of columns [c1, c2) := L11^{-1} (same), L11 the
// unit-lower block at [c0, c0+ws) x [c0, c0+ws): one thread per
// column runs the sequential substitution down it, with L11 in
// shared memory and, for ws <= LEAF_MAX_WS, the column in registers.
template <typename T>
__global__ void __launch_bounds__(LEAF_THREADS)
lu_rec_solve_leaf_kernel(T* a, int w, int c0, int ws, int c1, int c2) {
    __shared__ float L[LEAF_MAX_WS][LEAF_MAX_WS + 1];
    const int c = c1 + blockIdx.x * blockDim.x + threadIdx.x;
    if (ws <= LEAF_MAX_WS) {
        for (int e = threadIdx.x; e < ws * ws; e += blockDim.x)
            L[e / ws][e % ws] = to_f(a[(long)(c0 + e / ws) * w + c0 + e % ws]);
        __syncthreads();
        if (c >= c2) return;
        float x[LEAF_MAX_WS];
#pragma unroll
        for (int i = 0; i < LEAF_MAX_WS; ++i)
            if (i < ws) x[i] = to_f(a[(long)(c0 + i) * w + c]);
#pragma unroll
        for (int rr = 0; rr < LEAF_MAX_WS; ++rr)
#pragma unroll
            for (int i = rr + 1; i < LEAF_MAX_WS; ++i)
                if (i < ws)
                    x[i] = rnd<T>(__fsub_rn(
                        x[i], rnd<T>(__fmul_rn(L[i][rr], x[rr]))));
#pragma unroll
        for (int i = 0; i < LEAF_MAX_WS; ++i)
            if (i < ws) a[(long)(c0 + i) * w + c] = from_f<T>(x[i]);
        return;
    }
    if (c >= c2) return;
    for (int rr = 0; rr < ws; ++rr) {
        const float x = to_f(a[(long)(c0 + rr) * w + c]);
        for (int i = rr + 1; i < ws; ++i) {
            T* t = a + (long)(c0 + i) * w + c;
            const float l = to_f(a[(long)(c0 + i) * w + c0 + rr]);
            *t = from_f<T>(__fsub_rn(to_f(*t), rnd<T>(__fmul_rn(l, x))));
        }
    }
}

template <typename T>
int solve_leaf(T* a, int w, int c0, int ws, int c1, int c2,
               cudaStream_t s) {
    const int n = c2 - c1;
    if (n <= 0) return (int)cudaGetLastError();
    lu_rec_solve_leaf_kernel<T><<<(n + LEAF_THREADS - 1) / LEAF_THREADS,
                                  LEAF_THREADS, 0, s>>>(a, w, c0, ws, c1,
                                                        c2);
    return (int)cudaGetLastError();
}

template <typename T>
int mm_update(T* a, int w, int r0, int r1, int k0, int k1, int c0, int c1,
              cudaStream_t s) {
    T* d = a + (long)r0 * w + c0;
    return slate_torch::launch_gemm_sub<T>(
        d, w, a + (long)r0 * w + k0, w, a + (long)k0 * w + c0, w, d, w,
        r1 - r0, c1 - c0, k1 - k0, s);
}

typedef __nv_bfloat16 bf16_t;

}  // namespace

extern "C" {

// Make `device` current for this library's runtime (the wrapper calls
// it before launching on a tensor's device).
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Base case over columns [c0, c0+wseg) (scratch as launch_lu_base).
int lu_rec_base(void* a, int* piv, int m, int w, int c0, int wseg,
                float* scratch_f, int* scratch_i, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return slate_torch::launch_lu_base((bf16_t*)a, piv, m, w, c0, wseg,
                                           scratch_f, scratch_i, s);
    return slate_torch::launch_lu_base((float*)a, piv, m, w, c0, wseg,
                                       scratch_f, scratch_i, s);
}

int lu_rec_solve_leaf(void* a, int w, int c0, int ws, int c1, int c2,
                      int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) return solve_leaf((bf16_t*)a, w, c0, ws, c1, c2, s);
    return solve_leaf((float*)a, w, c0, ws, c1, c2, s);
}

int lu_rec_mm_update(void* a, int w, int r0, int r1, int k0, int k1,
                     int c0, int c1, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) return mm_update((bf16_t*)a, w, r0, r1, k0, k1, c0, c1, s);
    return mm_update((float*)a, w, r0, r1, k0, k1, c0, c1, s);
}

}  // extern "C"

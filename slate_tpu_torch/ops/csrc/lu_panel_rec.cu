// Block-recursive partial-pivot LU panel: the device work of
// ops/kernels.py lu_panel_rec.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_lu_panel_rec_pallas. The
// Pallas kernel recurses over widths at trace time inside one
// dispatch; here the same recursion runs on the host (kernels.py
// _lu_panel_rec_cuda) and launches three kernels on one stream:
//
//   lu_rec_base       the ib-wide base case: lu_base_grid.cuh's
//                     segment factorization (rows in registers, one
//                     epoch-tagged exchange through L2 a column, the
//                     swaps outside the segment gathered once at the
//                     end) for segments of at most 32 columns,
//                     lu_base.cuh's cooperative kernel for the others;
//   lu_rec_solve_leaf the ib-row unit-lower substitution of the
//                     recursive triangular solve;
//   lu_rec_mm_update  out[r0:r1, c0:c1] -= out[r0:r1, k0:k1] @
//                     out[k0:k1, c0:c1], the register-tiled product of
//                     sgemm_tile.cuh on strided views of the panel.
//
// The panel is row-major (m, w), f32 or bf16 (the `bf16` argument),
// updated in place in the output buffer the wrapper allocates. Pivots
// come back as int32 swap targets. Arithmetic is f32 with the
// reference's rounding to the panel type: the leaf computes
// x = T(x - T(l * r)) (pallas_kernels.py:557-558), the product update
// T(out - T(P)) with P accumulated in f32 by fmaf in k order. Products
// and differences use __fmul_rn/__fsub_rn (no FMA contraction), so they
// round exactly as the plain PyTorch version's
// outer-product-then-subtract does.
//
// Bound on an H100: the base case is latency-bound (ib exchanges
// between SMs, lu_base_grid.cuh); the leaf is a chain of ib dependent
// updates a column; the updates are bound by f32 CUDA-core FLOPs or by
// their bytes. Design of the leaf: one warp a column, one lane a row
// (ws <= 32), L11 in shared memory read down its columns (conflict-free
// at a pitch of 33), the substitution's x_rr passed by a shuffle; the
// order of every element's updates is the sequential substitution's.
// (One thread a column with the 32 x 32 update loops unrolled waits
// on instruction fetch: ~9 us f32, ~44 us bf16 a launch on an H100.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lu_base.cuh"
#include "lu_base_grid.cuh"
#include "sgemm_tile.cuh"

namespace {

using slate_torch::from_f;
using slate_torch::rnd;
using slate_torch::to_f;

constexpr int LEAF_THREADS = 128;
constexpr int LEAF_MAX_WS = 32;         // the warp path of the leaf
constexpr int MM_TILE = 64;

// rows [c0, c0+ws) of columns [c1, c2) := L11^{-1} (same), L11 the
// unit-lower block at [c0, c0+ws) x [c0, c0+ws): for ws <= 32 one warp
// a column, lane i holding x_i; for wider leaves one thread a column
// walking the substitution in device memory.
template <typename T>
__global__ void __launch_bounds__(LEAF_THREADS)
lu_rec_solve_leaf_kernel(T* a, int w, int c0, int ws, int c1, int c2) {
    __shared__ float L[LEAF_MAX_WS][LEAF_MAX_WS + 1];
    if (ws <= LEAF_MAX_WS) {
        for (int e = threadIdx.x; e < ws * ws; e += blockDim.x)
            L[e / ws][e % ws] = to_f(a[(long)(c0 + e / ws) * w + c0 + e % ws]);
        __syncthreads();
        const int lane = threadIdx.x & 31;
        const int wpb = blockDim.x / 32;
        for (int c = c1 + blockIdx.x * wpb + threadIdx.x / 32; c < c2;
             c += gridDim.x * wpb) {
            T* col = a + (long)(c0 + lane) * w + c;
            float x = lane < ws ? to_f(*col) : 0.f;
            for (int rr = 0; rr + 1 < ws; ++rr) {
                const float xr = __shfl_sync(0xffffffffu, x, rr);
                if (lane > rr && lane < ws)
                    x = rnd<T>(__fsub_rn(x, rnd<T>(__fmul_rn(L[lane][rr], xr))));
            }
            if (lane < ws) *col = from_f<T>(x);
        }
        return;
    }
    const int c = c1 + blockIdx.x * blockDim.x + threadIdx.x;
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
    const int per_block = ws <= LEAF_MAX_WS ? LEAF_THREADS / 32 : LEAF_THREADS;
    lu_rec_solve_leaf_kernel<T><<<(n + per_block - 1) / per_block,
                                  LEAF_THREADS, 0, s>>>(a, w, c0, ws, c1,
                                                        c2);
    return (int)cudaGetLastError();
}

// D = T(D - T(A B)) on the panel's strided views by 64 x 64 tiles of
// sgemm_tile.cuh (VEC: f32 with 16-byte aligned rows and N % 4 == 0).
template <typename T, bool VEC>
__global__ void __launch_bounds__(slate_torch::SG_THREADS)
lu_rec_mm_kernel(T* a, int w, int r0, int k0, int c0, int M, int N, int K) {
    extern __shared__ float4 mm_smem4[];
    T* d = a + (long)r0 * w + c0;
    slate_torch::sgemm_sub_tile<T, MM_TILE, MM_TILE, false, VEC>(
        reinterpret_cast<float*>(mm_smem4), d, w, a + (long)r0 * w + k0, w,
        a + (long)k0 * w + c0, w, d, w, M, N, K, blockIdx.y * MM_TILE,
        blockIdx.x * MM_TILE);
}

template <typename T>
int mm_update(T* a, int w, int r0, int r1, int k0, int k1, int c0, int c1,
              cudaStream_t s) {
    const int M = r1 - r0, N = c1 - c0, K = k1 - k0;
    if (M <= 0 || N <= 0) return (int)cudaGetLastError();
    constexpr int smem = slate_torch::sg_smem_bytes(MM_TILE, MM_TILE);
    const dim3 grid((N + MM_TILE - 1) / MM_TILE, (M + MM_TILE - 1) / MM_TILE);
    if constexpr (sizeof(T) == 4) {
        if (w % 4 == 0 && c0 % 4 == 0 && N % 4 == 0
            && ((uintptr_t)a & 15) == 0) {
            lu_rec_mm_kernel<T, true>
                <<<grid, slate_torch::SG_THREADS, smem, s>>>(a, w, r0, k0, c0,
                                                             M, N, K);
            return (int)cudaGetLastError();
        }
    }
    lu_rec_mm_kernel<T, false><<<grid, slate_torch::SG_THREADS, smem, s>>>(
        a, w, r0, k0, c0, M, N, K);
    return (int)cudaGetLastError();
}

typedef __nv_bfloat16 bf16_t;

// Base case over columns [c0, c0+wseg): lu_base_grid.cuh where it
// takes the segment (over at most `max_blocks` blocks, `grid_scratch`
// as launch_lu_base_grid), else lu_base.cuh (scratch_f / scratch_i as
// launch_lu_base).
template <typename T>
int base(T* a, int* piv, int m, int w, int c0, int wseg, float* scratch_f,
         int* scratch_i, unsigned long long* grid_scratch, int max_blocks,
         cudaStream_t s) {
    if (slate_torch::lu_base_grid_takes(m, c0, wseg, max_blocks))
        return slate_torch::launch_lu_base_grid(a, piv, m, w, c0, wseg,
                                                max_blocks, grid_scratch, s);
    return slate_torch::launch_lu_base(a, piv, m, w, c0, wseg, scratch_f,
                                       scratch_i, s);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime (the wrapper calls
// it before launching on a tensor's device).
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Base case over columns [c0, c0+wseg) (scratch as base()).
int lu_rec_base(void* a, int* piv, int m, int w, int c0, int wseg,
                float* scratch_f, int* scratch_i, void* grid_scratch,
                int max_blocks, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* gs = (unsigned long long*)grid_scratch;
    if (bf16)
        return base((bf16_t*)a, piv, m, w, c0, wseg, scratch_f, scratch_i, gs,
                    max_blocks, s);
    return base((float*)a, piv, m, w, c0, wseg, scratch_f, scratch_i, gs,
                max_blocks, s);
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

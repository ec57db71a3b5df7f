// Block-recursive partial-pivot LU panel: the device work of
// ops/kernels.py lu_panel_rec.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_lu_panel_rec_pallas. The
// Pallas kernel recurses over widths at trace time inside one
// dispatch; here the same recursion runs on the host (kernels.py
// _lu_panel_rec_cuda) and launches three kernels on one stream:
//
//   lu_rec_base       the ib-wide base case: per column, argmax pivot
//                     search (lowest row wins ties), full-row swap,
//                     multipliers with the pivval == 0 -> 1 safe
//                     divide, rank-1 update confined to the segment;
//   lu_rec_solve_leaf the ib-row unit-lower substitution of the
//                     recursive triangular solve;
//   lu_rec_mm_update  out[r0:r1, c0:c1] -= out[r0:r1, k0:k1] @
//                     out[k0:k1, c0:c1], the tiled GEMM of
//                     gemm_sub.cuh on strided views of the panel.
//
// The panel is row-major (m, w) f32, updated in place in the output
// buffer the wrapper allocates. Pivots come back as int32 swap
// targets. Products and differences in the base case and the leaf
// use __fmul_rn/__fsub_rn (no FMA contraction), so they round exactly
// as the plain PyTorch version's outer-product-then-subtract does.
//
// Bound on an H100: the base case is latency-bound, a sequential
// column recurrence (a pivot reduction over all m rows and a row
// exchange per column); the updates are bound by f32 CUDA-core FLOPs.
// Design of the base case: ONE cooperative launch of up to one block
// per SM. Each block owns a contiguous slice of rows and keeps its
// rows' segment (wseg columns) in shared memory for the whole call,
// so the rank-1 updates never touch device memory. Per column, two
// grid-wide barriers: after each block posts its local argmax
// candidate, and after the owners of rows j and p post those rows;
// every block then reduces the candidates itself (the same p
// everywhere) and applies the swap and the update to its slice.
// Candidates and posted rows are double-buffered by column parity, so
// no third barrier is needed. (A first version ran the base case as a
// single block over the whole panel: PERF.md has its times.)
// Not done yet: fusing the leaf and product launches, a persistent
// kernel for the whole recursion.

#include <cuda_runtime.h>

#include "gemm_sub.cuh"

namespace {

constexpr int BASE_THREADS = 256;
constexpr int MAX_BLOCKS = 1024;        // candidate slots per parity
constexpr int LEAF_THREADS = 128;
constexpr int LEAF_MAX_WS = 32;         // register path of the leaf

// (value, row) argmax step: larger |a| wins, equal values go to the
// lower row (the lu_panel_fori tie-break).
__device__ __forceinline__ void argmax_merge(float& v, int& r, float ov,
                                             int orow) {
    if (ov > v || (ov == v && orow < r)) {
        v = ov;
        r = orow;
    }
}

__device__ __forceinline__ void warp_argmax(float& v, int& r) {
    for (int off = 16; off > 0; off >>= 1)
        argmax_merge(v, r, __shfl_down_sync(0xffffffffu, v, off),
                     __shfl_down_sync(0xffffffffu, r, off));
}

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

__global__ void __launch_bounds__(BASE_THREADS)
lu_rec_base_kernel(float* a, int* piv, int m, int w, int c0, int wseg,
                   int rows_per_block, float* cand_val, int* cand_row,
                   float* xrow, unsigned int* bar) {
    extern __shared__ float smem[];
    __shared__ float s_val[BASE_THREADS / 32];
    __shared__ int s_row[BASE_THREADS / 32];
    __shared__ int s_p;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = BASE_THREADS / 32;
    const int G = gridDim.x, b = blockIdx.x;
    const int r_lo = b * rows_per_block;
    const int r_hi = min(m, r_lo + rows_per_block);
    const int nr = max(0, r_hi - r_lo);
    float* seg = smem;                             // nr x wseg
    float* urow = seg + rows_per_block * wseg;     // pivot row segment
    float* mults = urow + wseg;                    // nr multipliers

    for (int e = tid; e < nr * wseg; e += BASE_THREADS) {
        const int r = e / wseg, c = e % wseg;
        seg[e] = a[(long)(r_lo + r) * w + c0 + c];
    }
    __syncthreads();

    unsigned int epoch = 0;
    for (int jj = 0; jj < wseg; ++jj) {
        const int j = c0 + jj, par = jj & 1;
        // local candidate over this block's rows >= j; the rows a
        // thread visits increase, so its own ties keep the lowest row
        float best = -1.f;
        int brow = m;
        for (int r = max(j, r_lo) + tid; r < r_hi; r += BASE_THREADS) {
            const float v = fabsf(seg[(r - r_lo) * wseg + jj]);
            if (v > best) {
                best = v;
                brow = r;
            }
        }
        warp_argmax(best, brow);
        if (lane == 0) {
            s_val[warp] = best;
            s_row[warp] = brow;
        }
        __syncthreads();
        if (tid == 0) {
            for (int i = 1; i < nwarps; ++i)
                argmax_merge(best, brow, s_val[i], s_row[i]);
            cand_val[par * MAX_BLOCKS + b] = best;
            cand_row[par * MAX_BLOCKS + b] = brow;
        }
        grid_barrier(bar, ++epoch);
        // every block reduces all candidates: the same p everywhere
        if (warp == 0) {
            best = -1.f;
            brow = m;
            for (int i = lane; i < G; i += 32)
                argmax_merge(best, brow,
                             __ldcg(&cand_val[par * MAX_BLOCKS + i]),
                             __ldcg(&cand_row[par * MAX_BLOCKS + i]));
            warp_argmax(best, brow);
            if (lane == 0) {
                // an all-NaN column finds no maximum: keep row j
                const int p = brow < m ? brow : j;
                s_p = p;
                if (b == 0) piv[j] = p;
            }
        }
        __syncthreads();
        const int p = s_p;
        float* prow_g = xrow + par * 2 * wseg;     // row p's segment
        float* jrow_g = prow_g + wseg;             // row j's segment
        const bool own_j = j >= r_lo && j < r_hi;
        const bool own_p = p >= r_lo && p < r_hi;
        if (own_p)
            for (int c = tid; c < wseg; c += BASE_THREADS)
                prow_g[c] = seg[(p - r_lo) * wseg + c];
        if (own_j) {
            for (int c = tid; c < wseg; c += BASE_THREADS)
                jrow_g[c] = seg[(j - r_lo) * wseg + c];
            // the columns outside the segment live in device memory,
            // and only this block touches them in this launch
            if (p != j)
                for (int c = tid; c < w; c += BASE_THREADS) {
                    if (c >= c0 && c < c0 + wseg) continue;
                    const float t = a[(long)j * w + c];
                    a[(long)j * w + c] = a[(long)p * w + c];
                    a[(long)p * w + c] = t;
                }
        }
        grid_barrier(bar, ++epoch);
        for (int c = tid; c < wseg; c += BASE_THREADS) {
            const float pv = __ldcg(&prow_g[c]);
            urow[c] = pv;
            if (p != j) {
                if (own_j) seg[(j - r_lo) * wseg + c] = pv;
                if (own_p)
                    seg[(p - r_lo) * wseg + c] = __ldcg(&jrow_g[c]);
            }
        }
        __syncthreads();
        const float pivval = urow[jj];
        const float safe = pivval == 0.f ? 1.f : pivval;
        const int u_lo = max(j + 1, r_lo);
        for (int r = u_lo + tid; r < r_hi; r += BASE_THREADS)
            mults[r - r_lo] = __fdiv_rn(seg[(r - r_lo) * wseg + jj], safe);
        __syncthreads();
        const int ncol = wseg - jj;
        for (int e = tid; e < (r_hi - u_lo) * ncol; e += BASE_THREADS) {
            const int rl = u_lo - r_lo + e / ncol, c = jj + e % ncol;
            const float mu = mults[rl];
            float* t = &seg[rl * wseg + c];
            *t = c == jj ? mu : __fsub_rn(*t, __fmul_rn(mu, urow[c]));
        }
        __syncthreads();
    }

    for (int e = tid; e < nr * wseg; e += BASE_THREADS) {
        const int r = e / wseg, c = e % wseg;
        a[(long)(r_lo + r) * w + c0 + c] = seg[e];
    }
}

// rows [c0, c0+ws) of columns [c1, c2) := L11^{-1} (same), L11 the
// unit-lower block at [c0, c0+ws) x [c0, c0+ws): one thread per
// column runs the sequential substitution down it, with L11 in
// shared memory and, for ws <= LEAF_MAX_WS, the column in registers.
__global__ void __launch_bounds__(LEAF_THREADS)
lu_rec_solve_leaf_kernel(float* a, int w, int c0, int ws, int c1,
                         int c2) {
    __shared__ float L[LEAF_MAX_WS][LEAF_MAX_WS + 1];
    const int c = c1 + blockIdx.x * blockDim.x + threadIdx.x;
    if (ws <= LEAF_MAX_WS) {
        for (int e = threadIdx.x; e < ws * ws; e += blockDim.x)
            L[e / ws][e % ws] = a[(long)(c0 + e / ws) * w + c0 + e % ws];
        __syncthreads();
        if (c >= c2) return;
        float x[LEAF_MAX_WS];
#pragma unroll
        for (int i = 0; i < LEAF_MAX_WS; ++i)
            if (i < ws) x[i] = a[(long)(c0 + i) * w + c];
#pragma unroll
        for (int rr = 0; rr < LEAF_MAX_WS; ++rr)
#pragma unroll
            for (int i = rr + 1; i < LEAF_MAX_WS; ++i)
                if (i < ws) x[i] = __fsub_rn(x[i], __fmul_rn(L[i][rr], x[rr]));
#pragma unroll
        for (int i = 0; i < LEAF_MAX_WS; ++i)
            if (i < ws) a[(long)(c0 + i) * w + c] = x[i];
        return;
    }
    if (c >= c2) return;
    for (int rr = 0; rr < ws; ++rr) {
        const float x = a[(long)(c0 + rr) * w + c];
        for (int i = rr + 1; i < ws; ++i) {
            float* t = a + (long)(c0 + i) * w + c;
            *t = __fsub_rn(*t, __fmul_rn(a[(long)(c0 + i) * w + c0 + rr],
                                         x));
        }
    }
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime (the wrapper calls
// it before launching on a tensor's device).
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Base case over columns [c0, c0+wseg). scratch_f holds 2*MAX_BLOCKS
// candidate values plus 4*wseg posted-row values; scratch_i holds one
// barrier counter plus 2*MAX_BLOCKS candidate rows.
int lu_rec_base(float* a, int* piv, int m, int w, int c0, int wseg,
                float* scratch_f, int* scratch_i, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // at least 16 rows per block, at most one block per SM
    int blocks = min(sms, max(1, (m + 15) / 16));
    blocks = min(blocks, MAX_BLOCKS);
    const int rows = (m + blocks - 1) / blocks;
    const size_t smem = sizeof(float) * ((size_t)rows * wseg + wseg + rows);
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(lu_rec_base_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lu_rec_base_kernel, BASE_THREADS, smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    unsigned int* bar = (unsigned int*)scratch_i;
    cudaMemsetAsync(bar, 0, sizeof(unsigned int), s);
    float* cand_val = scratch_f;
    float* xrow = scratch_f + 2 * MAX_BLOCKS;
    int* cand_row = scratch_i + 1;
    void* args[] = {&a, &piv, &m, &w, &c0, &wseg, (void*)&rows,
                    &cand_val, &cand_row, &xrow, &bar};
    e = cudaLaunchCooperativeKernel((void*)lu_rec_base_kernel,
                                    dim3(blocks), dim3(BASE_THREADS), args,
                                    smem, s);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

int lu_rec_solve_leaf(float* a, int w, int c0, int ws, int c1, int c2,
                      void* stream) {
    const int n = c2 - c1;
    if (n <= 0) return (int)cudaGetLastError();
    lu_rec_solve_leaf_kernel<<<(n + LEAF_THREADS - 1) / LEAF_THREADS,
                               LEAF_THREADS, 0, (cudaStream_t)stream>>>(
        a, w, c0, ws, c1, c2);
    return (int)cudaGetLastError();
}

int lu_rec_mm_update(float* a, int w, int r0, int r1, int k0, int k1,
                     int c0, int c1, void* stream) {
    float* d = a + (long)r0 * w + c0;
    return slate_torch::launch_gemm_sub(
        d, w, a + (long)r0 * w + k0, w, a + (long)k0 * w + c0, w, d, w,
        r1 - r0, c1 - c0, k1 - k0, (cudaStream_t)stream);
}

}  // extern "C"

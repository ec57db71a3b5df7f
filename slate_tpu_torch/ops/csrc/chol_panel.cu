// Lower Cholesky of one SPD block: the device work of ops/kernels.py
// chol_panel.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_chol_fused_pallas (:933),
// the reference's fused Cholesky of a block of order n <= 1024, n % 128
// == 0, f32: 128-wide column stripes left to right, each taking the
// left-looking update of the finished stripes, then a per-column
// recurrence d = sqrt(s_jj), v = s_j / d below the diagonal (d == 0 ->
// divide by 1), s_jj = d, and the rank-1 update of the stripe's columns
// right of j. Only the lower triangle is read; the result has zeros
// above the diagonal. f32 only, TF32 off (the reference computes at
// Precision.HIGHEST).
//
// Bound on an H100: n^3 / 3 FLOPs, 358 MFLOP at n = 1024, 5.3 us at the
// f32 rate (4 MB read and written: 2.5 us). What holds a Cholesky of
// this size back is the column recurrence: 1024 dependent pivots, each
// a square root, a reciprocal and a broadcast. The design keeps that
// chain on one warp with no block barrier a column and everything else
// parallel, three launches a stripe [k0, k1):
//  1. chol_diag_kernel, one block: the 128 x 128 diagonal block in
//     shared memory, factored once, by 16-column sub-panels with a
//     look-ahead of one: warp 0 factors a sub-panel's 16 x 16
//     diagonal block in registers (lane i holds row i; the pivot by
//     __shfl_sync, the multipliers through shared memory, no block
//     barrier a column), then solves the next sub-panel's 16 rows,
//     updates its diagonal block and factors it, while warps 1-7 solve
//     the rows below (one thread a row) and update the rest of the
//     trailing part, S -= X X^T (products summed, then subtracted),
//     register-tiled: one named and one block barrier a sub-panel. The
//     column loops stay rolled and rotate their registers (column
//     j + 1 moves into row[0]), so no register is indexed at run time
//     and the code is not fetched anew for every column;
//  2. chol_trsm_kernel, gridded over 8-row blocks of the rows below:
//     L_below = S_below L_D^-T by substitution in the same column
//     order, L_D in shared memory (padded rows: a warp reads a column
//     of it without bank conflicts), two rows a warp, the solved value
//     by shuffle;
//  3. chol_syrk_kernel, gridded over the 64 x 64 tiles of the lower
//     trailing matrix: W[k1:, k1:] -= L_below L_below^T, the
//     register-tiled cp.async product of sgemm_tile.cuh (op(B) = B^T),
//     all eight 16-deep K slabs in flight at once.
// v = s / d is taken as s * (1 / d): in the diagonal blocks 1 / d is
// the hardware's reciprocal square root of the pivot refined by one
// Newton step (no branch on the chain of pivots), in the rows below a
// correctly rounded reciprocal of the stored d = sqrt(s_jj) (correctly
// rounded); a zero d is taken as 1.
// The reference's left-looking update becomes this right-looking one:
// a left-looking stripe update of the last stripes has at most 7 output
// tiles of K = 896 (one SM's work), the right-looking one up to 105
// independent tiles of K = 128 and no cross-block sum. The values agree
// in exact arithmetic; the sums are taken in another order (a
// stripe's update is subtracted per finished stripe, not once), held to
// the plain version within 1e-5 of the scale, and every operation on
// a block whose entries are 0, 1 or on the diagonal alone is exact, so
// those stay bitwise. No per-element integer division: every index is
// a shift, a mask or a compile-time constant.
//
// No block of a launch reads what another block of it writes (the
// diagonal kernel is one block; the solve reads W's rows and L_D and
// writes its own rows of L; the update reads L's stripe and writes its
// own tile of W), so the blocks may start in any order; `serial`
// launches them one at a time to show it.

#include <cuda_runtime.h>

#include "pdl.cuh"
#include "sgemm_tile.cuh"

namespace {

using slate_torch::launch_pdl;
using slate_torch::pdl_wait;

constexpr int CB = 128;               // stripe width (_CHOL_BLK)
constexpr int LD = CB + 1;            // padded row of a shared 128 x 128
constexpr unsigned FULL = 0xffffffffu;

constexpr int DG_THREADS = 256;
constexpr int DG_SMEM = ((CB + 16) * LD + 2 * 16 + 32) * (int)sizeof(float);

constexpr int TR_THREADS = 128;
constexpr int TR_RPW = 2;             // rows a warp
constexpr int TR_ROWS = TR_THREADS / 32 * TR_RPW;
constexpr int TR_SMEM = (CB * LD + CB) * (int)sizeof(float);

constexpr int SY_TILE = 64;
constexpr int SY_STAGES = CB / slate_torch::SG_BK + 1;   // all of K at once
constexpr int SY_SMEM = slate_torch::sg_smem_bytes(SY_TILE, SY_TILE,
                                                   SY_STAGES);

constexpr int SUB = 16;                // sub-panel width

// 1 / sqrt(p) for the pivot chain, without the branches of the
// correctly rounded square root and reciprocal: the hardware's
// estimate and one Newton step taken by FMA (within an ulp or two, and
// exactly 1 at p = 1); 1 for a zero pivot (the reference's d == 0 ->
// divide by 1).
__device__ __forceinline__ float pivot_rinv(float p) {
    const float y = rsqrtf(p);
    const float r = fmaf(-__fmul_rn(p, y), y, 1.f);
    return p == 0.f ? 1.f : fmaf(y, __fmul_rn(0.5f, r), y);
}

// Column j of the SUB x SUB diagonal block at (c0, c0), lane i < SUB
// holding row i with column j in row[0]: v = s / d as s * (1 / d), and
// the rank-1 update s_c -= v v_c of the columns right of j (one FMA;
// v_c broadcast from `vbuf`, where each lane posts its v), rotated so
// that column j + 1 lands in row[0]. d = sqrt(s_jj), correctly rounded,
// is stored after the update, off the chain of pivots. Only the CMAX
// columns right of j that exist in this phase are updated; entries
// above the diagonal take garbage and are never read.
template <int CMAX>
__device__ __forceinline__ void diag_column(float (&row)[SUB], float* D,
                                            float* rinvs, float* vbuf,
                                            int c0, int j, int lane) {
    const float p = __shfl_sync(FULL, row[0], j);
    const float rinv = pivot_rinv(p);
    const float v = __fmul_rn(row[0], rinv);
    vbuf[lane] = v;
    __syncwarp();
    const float d = sqrtf(p);
    const float out = lane > j ? v : d;
#pragma unroll
    for (int c = 1; c <= CMAX; ++c)
        row[c - 1] = fmaf(-v, vbuf[j + c], row[c]);
    __syncwarp();
    if (lane >= j && lane < SUB) D[(c0 + lane) * LD + c0 + j] = out;
    if (lane == 0) rinvs[j] = rinv;
}

// Column j of the forward substitution of a row below the diagonal
// block, column j in s[0]: x_j = s_j / d_j, s_c -= x_j L_cj (one FMA;
// L_cj broadcast from shared memory, the rows past the block reading
// the padding below D), rotated as diag_column.
template <int CMAX>
__device__ __forceinline__ void solve_column(float (&s)[SUB], float* D,
                                             const float* rinvs, int c0,
                                             int r, int j) {
    const float x = __fmul_rn(s[0], rinvs[j]);
    D[r * LD + c0 + j] = x;
    const float* l = D + (c0 + j) * LD + c0 + j;
#pragma unroll
    for (int c = 1; c <= CMAX; ++c) s[c - 1] = fmaf(-x, l[c * LD], s[c]);
}

// The SUB x SUB diagonal block at (c0, c0) by warp 0, lanes < SUB
// holding its rows; its 1 / d_j into rinvs. The column loops stay
// rolled (straight-line code of this length waits on instruction fetch)
// and keep their registers at fixed indices by the rotation; each
// quarter of the columns updates only the columns that can still lie
// right of the pivot.
__device__ __forceinline__ void factor_diag(float* D, float* rinvs,
                                            float* vbuf, int c0, int lane) {
    constexpr int Q = SUB / 4;
    float row[SUB];
    const int r = c0 + (lane < SUB ? lane : 0);
#pragma unroll
    for (int c = 0; c < SUB; ++c) row[c] = D[r * LD + c0 + c];
#pragma unroll 1
    for (int j = 0; j < Q; ++j)
        diag_column<SUB - 1>(row, D, rinvs, vbuf, c0, j, lane);
#pragma unroll 1
    for (int j = Q; j < 2 * Q; ++j)
        diag_column<SUB - 1 - Q>(row, D, rinvs, vbuf, c0, j, lane);
#pragma unroll 1
    for (int j = 2 * Q; j < 3 * Q; ++j)
        diag_column<SUB - 1 - 2 * Q>(row, D, rinvs, vbuf, c0, j, lane);
#pragma unroll 1
    for (int j = 3 * Q; j < SUB; ++j)
        diag_column<SUB - 1 - 3 * Q>(row, D, rinvs, vbuf, c0, j, lane);
}

// Row r's columns [c0, c0 + SUB) solved against the factored diagonal
// block at (c0, c0), by one thread.
__device__ __forceinline__ void solve_row(float* D, const float* rinvs,
                                          int c0, int r) {
    constexpr int Q = SUB / 4;
    float s[SUB];
#pragma unroll
    for (int c = 0; c < SUB; ++c) s[c] = D[r * LD + c0 + c];
#pragma unroll 1
    for (int j = 0; j < Q; ++j) solve_column<SUB - 1>(s, D, rinvs, c0, r, j);
#pragma unroll 1
    for (int j = Q; j < 2 * Q; ++j)
        solve_column<SUB - 1 - Q>(s, D, rinvs, c0, r, j);
#pragma unroll 1
    for (int j = 2 * Q; j < 3 * Q; ++j)
        solve_column<SUB - 1 - 2 * Q>(s, D, rinvs, c0, r, j);
#pragma unroll 1
    for (int j = 3 * Q; j < SUB; ++j)
        solve_column<SUB - 1 - 3 * Q>(s, D, rinvs, c0, r, j);
}

// The 128 x 128 diagonal block D, factored by 16-column sub-panels with
// a look-ahead of one: while warp 0 solves the next sub-panel's rows,
// updates its diagonal block and factors it, warps 1-7 solve the rows
// below and update the rest of the trailing part, S -= X X^T (products
// summed first, then subtracted), register-tiled. One named barrier (the
// next block's rows solved) and one block barrier a sub-panel.
__device__ __forceinline__ void factor_block(float* D, float* rinvs,
                                             float* vbuf) {
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    if (warp == 0) factor_diag(D, rinvs, vbuf, 0, lane);
    __syncthreads();
#pragma unroll 1
    for (int P = 0; P < CB / SUB - 1; ++P) {
        const int c0 = SUB * P, c1 = c0 + SUB;
        const float* rv = rinvs + SUB * (P & 1);
        if (warp == 0) {
            if (lane < SUB) solve_row(D, rv, c0, c1 + lane);
            __threadfence_block();
            asm volatile("bar.arrive 1, %0;\n" :: "n"(DG_THREADS) : "memory");
            {
                // the next diagonal block, D[c1 + i, c1 + j] -= X X^T:
                // lane holds row i = lane % 16, columns j = lane / 16 + 2 q
                const int r = c1 + (lane & (SUB - 1)), j0 = lane >> 4;
                float acc[SUB / 2];
#pragma unroll
                for (int q = 0; q < SUB / 2; ++q) acc[q] = 0.f;
#pragma unroll 1
                for (int k = 0; k < SUB; ++k) {
                    const float x = D[r * LD + c0 + k];
#pragma unroll
                    for (int q = 0; q < SUB / 2; ++q)
                        acc[q] = fmaf(x, D[(c1 + j0 + 2 * q) * LD + c0 + k],
                                      acc[q]);
                }
#pragma unroll
                for (int q = 0; q < SUB / 2; ++q) {
                    const int c = c1 + j0 + 2 * q;
                    if (c <= r) D[r * LD + c] = __fsub_rn(D[r * LD + c], acc[q]);
                }
            }
            __syncwarp();
            factor_diag(D, rinvs + SUB * ((P + 1) & 1), vbuf, c1, lane);
        } else {
            const int t = tid - 32, w = warp - 1;
            const int rb0 = c1 + SUB, rows = CB - rb0;
            if (t < rows) solve_row(D, rv, c0, rb0 + t);
            asm volatile("bar.sync 1, %0;\n" :: "n"(DG_THREADS) : "memory");
            // rows [rb0, CB) in runs of 4 (run w, w + 7, ...), columns
            // c1 + lane + 32 jj up to the row
#pragma unroll 1
            for (int r0 = rb0 + 4 * w; r0 < CB; r0 += 28) {
                float acc[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
                for (int k = 0; k < SUB; ++k) {
                    float a[4], b[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a[i] = D[(r0 + i) * LD + c0 + k];
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        b[jj] = D[min(c1 + lane + 32 * jj, CB - 1) * LD + c0 + k];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj)
                            acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        const int r = r0 + i, c = c1 + lane + 32 * jj;
                        if (c <= r)
                            D[r * LD + c] = __fsub_rn(D[r * LD + c], acc[i][jj]);
                    }
            }
        }
        __syncthreads();
    }
}

// The 128 x 128 block of the row-major (n, n) `src` at (k0, k0) into
// the padded shared rows of `D`, by `threads` threads: 16-byte loads,
// all in flight before the first store.
template <int threads>
__device__ __forceinline__ void load_block(float* D, const float* src,
                                           int n, int k0) {
    constexpr int PER = CB * CB / 4 / threads, BATCH = PER < 16 ? PER : 16;
#pragma unroll
    for (int b0 = 0; b0 < PER; b0 += BATCH) {
        float4 v[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = (b0 + i) * threads + threadIdx.x;
            v[i] = *reinterpret_cast<const float4*>(
                src + (long)(k0 + (e >> 5)) * n + k0 + (e & 31) * 4);
        }
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
            const int e = (b0 + i) * threads + threadIdx.x;
            float* d = D + (e >> 5) * LD + (e & 31) * 4;
            d[0] = v[i].x; d[1] = v[i].y; d[2] = v[i].z; d[3] = v[i].w;
        }
    }
}

// The diagonal block [k0, k0 + CB)^2 of the working copy `w` (its
// updates applied) factored into the same block of `l`, zeros above the
// diagonal.
__global__ void __launch_bounds__(DG_THREADS, 1)
chol_diag_kernel(const float* __restrict__ w, float* __restrict__ l, int n,
                 int k0) {
    extern __shared__ float dg_smem[];
    pdl_wait();
    float* D = dg_smem;
    // D, then SUB rows of padding that the solves' broadcasts may read
    // past the last block, a sub-panel's 1 / d_j ([2][SUB]) and the
    // diagonal factor's broadcast of v ([32])
    float* rinvs = D + (CB + SUB) * LD;
    float* vbuf = rinvs + 2 * SUB;
    load_block<DG_THREADS>(D, w, n, k0);
    __syncthreads();
    factor_block(D, rinvs, vbuf);
#pragma unroll 16
    for (int i = 0; i < CB * CB / DG_THREADS; ++i) {
        const int e = i * DG_THREADS + threadIdx.x;
        const int r = e >> 7, c = e & (CB - 1);
        l[(long)(k0 + r) * n + k0 + c] = c <= r ? D[r * LD + c] : 0.f;
    }
}

// Rows [k1 + 16 b, ...) of the stripe's columns, b = b0 + blockIdx.x:
// L[r, k0:k1] = W[r, k0:k1] L_D^-T. Lane i of a warp holds columns
// k0 + i + 32 g, g = 0..3, of each of its four rows.
__global__ void __launch_bounds__(TR_THREADS)
chol_trsm_kernel(const float* __restrict__ w, float* __restrict__ l, int n,
                 int k0, int b0) {
    extern __shared__ float tr_smem[];
    pdl_wait();
    float* LD_ = tr_smem;                 // L_D, padded rows
    float* rinv = LD_ + CB * LD;          // 1 / d_j (d_j == 0 -> 1)
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    load_block<TR_THREADS>(LD_, l, n, k0);
    __syncthreads();
    if (tid < CB) {
        const float d = LD_[tid * LD + tid];
        rinv[tid] = __frcp_rn(d == 0.f ? 1.f : d);
    }
    __syncthreads();

    const int r0 = k0 + CB + (b0 + blockIdx.x) * TR_ROWS + warp * TR_RPW;
    float s[TR_RPW][4];
#pragma unroll
    for (int q = 0; q < TR_RPW; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g)
            s[q][g] = r0 + q < n
                          ? w[(long)(r0 + q) * n + k0 + 32 * g + lane]
                          : 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
            const int j = 32 * g + jj;
            const float ri = rinv[j];
            float lj[4];
#pragma unroll
            for (int g2 = g; g2 < 4; ++g2)
                lj[g2] = LD_[(32 * g2 + lane) * LD + j];
#pragma unroll
            for (int q = 0; q < TR_RPW; ++q) {
                const float x = __fmul_rn(__shfl_sync(FULL, s[q][g], jj), ri);
                const float u = fmaf(-x, lj[g], s[q][g]);
                s[q][g] = lane == jj ? x : (lane > jj ? u : s[q][g]);
#pragma unroll
                for (int g2 = g + 1; g2 < 4; ++g2)
                    s[q][g2] = fmaf(-x, lj[g2], s[q][g2]);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < TR_RPW; ++q)
        if (r0 + q < n)
#pragma unroll
            for (int g = 0; g < 4; ++g)
                l[(long)(r0 + q) * n + k0 + 32 * g + lane] = s[q][g];
}

// Tile t = b0 + blockIdx.x of the lower trailing matrix, in row order
// (t = ti (ti + 1) / 2 + tj, tj <= ti): W[k1:, k1:] -= L[k1:, k0:k1]
// L[k1:, k0:k1]^T.
__global__ void __launch_bounds__(slate_torch::SG_THREADS)
chol_syrk_kernel(float* w, const float* l, int n, int k0, int b0) {
    extern __shared__ float4 sy_smem4[];
    pdl_wait();
    const int k1 = k0 + CB, t = b0 + blockIdx.x;
    int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    while (ti * (ti + 1) / 2 > t) --ti;
    const int tj = t - ti * (ti + 1) / 2;
    float* C = w + (long)k1 * n + k1;
    const float* A = l + (long)k1 * n + k0;
    slate_torch::sgemm_sub_tile<float, SY_TILE, SY_TILE, true, true,
                                SY_STAGES>(
        reinterpret_cast<float*>(sy_smem4), C, n, A, n, A, n, C, n, n - k1,
        n - k1, CB, ti * SY_TILE, tj * SY_TILE);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The lower Cholesky factor of the (n, n) row-major f32 block `w`
// (n % 128 == 0) into `l`, which must hold zeros (the entries above the
// diagonal blocks are not written); `w` is overwritten (the trailing
// updates). serial != 0 launches the solve's and the update's blocks
// one at a time, in order. Returns a cudaError_t.
int chol_panel(float* w, float* l, int n, int serial, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaFuncSetAttribute(
        chol_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DG_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(chol_trsm_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TR_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(chol_syrk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SY_SMEM);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    for (int k0 = 0; k0 < n; k0 += CB) {
        e = launch_pdl(chol_diag_kernel, dim3(1), dim3(DG_THREADS),
                       DG_SMEM, s, (const float*)w, l, n, k0);
        if (e != cudaSuccess) return (int)e;
        const int below = n - k0 - CB;
        if (below > 0) {
            const int tb = below / TR_ROWS;
            const int m = below / SY_TILE, tiles = m * (m + 1) / 2;
            if (serial) {
                for (int b = 0; b < tb; ++b)
                    chol_trsm_kernel<<<1, TR_THREADS, TR_SMEM, s>>>(w, l, n,
                                                                    k0, b);
                for (int b = 0; b < tiles; ++b)
                    chol_syrk_kernel<<<1, slate_torch::SG_THREADS, SY_SMEM,
                                       s>>>(w, l, n, k0, b);
            } else {
                e = launch_pdl(chol_trsm_kernel, dim3(tb), dim3(TR_THREADS),
                               TR_SMEM, s,
                               (const float*)w, l, n, k0, 0);
                if (e == cudaSuccess)
                    e = launch_pdl(chol_syrk_kernel, dim3(tiles),
                                   dim3(slate_torch::SG_THREADS), SY_SMEM,
                                   s, w, (const float*)l, n, k0, 0);
                if (e != cudaSuccess) return (int)e;
            }
        }
        const cudaError_t last = cudaGetLastError();
        if (last != cudaSuccess) return (int)last;
    }
    return 0;
}

}  // extern "C"

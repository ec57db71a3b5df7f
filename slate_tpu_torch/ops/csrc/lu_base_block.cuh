// A block-local partial-pivot LU of a column stripe: one block of 256
// threads factors columns [k0, k0 + cw), cw <= 32, of rows [k0, s) of a
// row-major matrix (leading dimension ld), s - k0 <= 1024. The base case
// of the ragged LU (ragged_getrf.cu, every stripe) and of the rank-1
// panel where a segment's rows fit one block (lu_panel.cu).
//
// The same function as lu_base.cuh / lu_base_grid.cuh: per column j the
// argmax of |a| over rows >= j in f32 (the lowest row wins ties), the
// row swap within the stripe, the multipliers T(f32(col) / f32(safe))
// with the pivval == 0 -> 1 safe divide, and the rank-1 update
// x = T(x - T(mu * u)) of the stripe's columns right of j (__fmul_rn /
// __fsub_rn). The swaps of the other columns are left to gather_cols,
// from the lists swap_lists composes.
//
// Bound on an H100: latency, a dependent column recurrence; here the
// exchange of a column stays inside one SM (no L2 round trip). Design:
// R = 1, 2 or 4 rows a thread in registers, rotated a column a step so
// every register index is known at compile time (lu_base_grid.cuh); per
// column a shuffle argmax, each warp's candidate posting its row to
// shared memory beside it and row j's owner row j, ONE block barrier,
// every thread reducing the eight candidates (the same p everywhere)
// and reading the winner's row (slots alternate by column parity), the
// swap in registers and the rank-1 update with the pivot row read from
// shared memory. By clock64 marks on an H100 a column takes ~1.9k /
// ~3.2k / ~5.0k cycles at 1 / 2 / 4 rows a thread, growing with the
// rows held, not with the barriers (a second barrier a column, or the
// pivot row read into registers in 8-column chunks, changed nothing).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lu_base_grid.cuh"

namespace slate_torch {

constexpr unsigned LB_FULL = 0xffffffffu;
constexpr int LB_THREADS = 256;
constexpr int LB_WARPS = LB_THREADS / 32;
constexpr int LB_W = 32;                 // register row of a stripe
constexpr int LB_MAX_ROWS = 4 * LB_THREADS;

// What the base case and the gather share in shared memory: the warps'
// candidates with their rows and row j (rotated), by column parity; the
// stripe's pivots; the gather's (destination, source) rows.
struct LuBlockSmem {
    float val[2][LB_WARPS];
    int row[2][LB_WARPS];
    __align__(16) float crow[2][LB_WARPS][LB_W];
    __align__(16) float jrow[2][LB_W];
    int piv[LB_W];
    int src[2 * LB_W], dst[2 * LB_W], nt;
};

// x[c] = T(x[c] - T(mu * u[c])) for 1 <= c < end, u the pivot row in
// shared memory, in groups of 8 that are skipped (a uniform branch) when
// wholly right of `end` (lu_base_grid.cuh rank1, which holds u in
// registers: beside four rows a thread it spilled).
template <typename T>
__device__ __forceinline__ void rank1_sm(float (&x)[LB_W], const float* u,
                                         float mu, int end) {
#pragma unroll
    for (int g = 0; g < LB_W / 8; ++g) {
        if (8 * g + (g == 0) >= end) break;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int c = 8 * g + q;
            if (c == 0) continue;
            const float nv =
                rnd<T>(__fsub_rn(x[c], rnd<T>(__fmul_rn(mu, u[c]))));
            x[c] = c < end ? nv : x[c];
        }
    }
}

// Post row x[kk] (kk < R a runtime index) to dst in shared memory.
template <int R>
__device__ __forceinline__ void post_sm(const float (&x)[R][LB_W], int kk,
                                        float* dst) {
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (k == kk)
#pragma unroll
            for (int q = 0; q < LB_W / 4; ++q)
                reinterpret_cast<float4*>(dst)[q] = make_float4(
                    x[k][4 * q], x[k][4 * q + 1], x[k][4 * q + 2],
                    x[k][4 * q + 3]);
}

// The base case of the stripe [k0, k0 + cw) over rows [k0, s), by the
// whole block: the packed stripe and its pivots into o and piv (row
// indices of o), the pivots also in sm.piv. R rows a thread:
// k0 + k LB_THREADS + tid. Not inlined: its registers are allocated
// apart from its callers' (inlined into the ragged LU's kernel, the
// four-row version spilled).
template <typename T, int R>
__device__ __noinline__ void lu_block_factor(T* o, int* piv, long ld, int s,
                                             int k0, int cw,
                                             LuBlockSmem& sm) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float x[R][LB_W];
    int row[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        row[k] = k0 + k * LB_THREADS + tid;
        const bool in = row[k] < s;
#pragma unroll
        for (int c = 0; c < LB_W; ++c)
            x[k][c] = in && c < cw
                ? to_f(__ldcg(o + row[k] * ld + k0 + c)) : 0.f;
    }
    for (int jj = 0; jj < cw; ++jj) {
        const int j = k0 + jj, par = jj & 1;
        // the candidate over this thread's rows >= j (increasing: its
        // own ties keep the lowest row), then over the warp
        float best = -1.f;
        int brow = s;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const float v = fabsf(x[k][0]);
            if (row[k] >= j && row[k] < s && v > best) {
                best = v;
                brow = row[k];
            }
        }
        warp_argmax(best, brow);
        best = __shfl_sync(LB_FULL, best, 0);
        brow = __shfl_sync(LB_FULL, brow, 0);
        // the warp's candidate posts its row beside it, row j's owner
        // row j: one barrier, then every thread reduces the candidates
        // (the same p everywhere) and reads the winner's row
        if (lane == 0) {
            sm.val[par][warp] = best;
            sm.row[par][warp] = brow;
        }
        if (brow < s && tid == (brow - k0) % LB_THREADS)
            post_sm(x, (brow - k0) / LB_THREADS, sm.crow[par][warp]);
        if (tid == jj) post_sm(x, 0, sm.jrow[par]);
        __syncthreads();
        int wb = 0;
        best = sm.val[par][0];
        brow = sm.row[par][0];
#pragma unroll
        for (int i = 1; i < LB_WARPS; ++i) {
            const float ov = sm.val[par][i];
            const int orow = sm.row[par][i];
            if (ov > best || (ov == best && orow < brow)) {
                best = ov;
                brow = orow;
                wb = i;
            }
        }
        // an all-NaN column finds no maximum: keep row j
        const int p = brow < s ? brow : j;
        const int pl = p - k0;
        const float* u = brow < s ? sm.crow[par][wb] : sm.jrow[par];
        if (tid == 0) sm.piv[jj] = p;
        if (p != j) {
            if (tid == jj) get_row(x, 0, u);
            if (tid == pl % LB_THREADS)
                get_row(x, pl / LB_THREADS, sm.jrow[par]);
        }
        const float safe = u[0] == 0.f ? 1.f : u[0];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            if (row[k] > j && row[k] < s) {
                const float mu = rnd<T>(__fdiv_rn(x[k][0], safe));
                x[k][0] = mu;
                rank1_sm<T>(x[k], u, mu, LB_W - jj);
            }
            rotate(x[k]);
        }
    }
    // back to column order: the rows were rotated cw times
    for (int t = cw; t < LB_W; ++t)
#pragma unroll
        for (int k = 0; k < R; ++k) rotate(x[k]);
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (row[k] < s)
#pragma unroll
            for (int c = 0; c < LB_W; ++c)
                if (c < cw) o[row[k] * ld + k0 + c] = from_f<T>(x[k][c]);
    __syncthreads();
    if (tid < cw) piv[k0 + tid] = sm.piv[tid];
}

// The base case at the fewest rows a thread that hold rows [k0, s).
template <typename T>
__device__ void lu_block_factor_any(T* o, int* piv, long ld, int s, int k0,
                                    int cw, LuBlockSmem& sm) {
    const int rows = s - k0;
    if (rows <= LB_THREADS)
        lu_block_factor<T, 1>(o, piv, ld, s, k0, cw, sm);
    else if (rows <= 2 * LB_THREADS)
        lu_block_factor<T, 2>(o, piv, ld, s, k0, cw, sm);
    else
        lu_block_factor<T, 4>(o, piv, ld, s, k0, cw, sm);
}

// The stripe's swaps c0+jj <-> piv[c0+jj] (jj < ncols, in order) as one
// gather, by warp 0: row sm.dst[i] takes the values row sm.src[i] held
// before them (the stripe's rows first, then the rows below it in the
// order of their first swap; ops/kernels.py swap_gather).
__device__ inline void swap_lists(const int* piv, int c0, int ncols,
                                  LuBlockSmem& sm) {
    const int lane = threadIdx.x & 31;
    if (threadIdx.x >= 32) return;
    const int pl = lane < ncols ? __ldcg(piv + c0 + lane) : 0;
    int seg_src = c0 + lane, okey = -1, osrc = -1, cnt = 0;
    for (int jj = 0; jj < ncols; ++jj) {
        const int p = __shfl_sync(LB_FULL, pl, jj);
        if (p == c0 + jj) continue;
        const int cj = __shfl_sync(LB_FULL, seg_src, jj);
        if (p < c0 + ncols) {
            const int q = p - c0;
            const int cq = __shfl_sync(LB_FULL, seg_src, q);
            if (lane == jj) seg_src = cq;
            if (lane == q) seg_src = cj;
        } else {
            const unsigned hit = __ballot_sync(LB_FULL, okey == p);
            const int k = hit ? __ffs(hit) - 1 : cnt;
            if (!hit) {
                if (lane == k) okey = osrc = p;
                ++cnt;
            }
            const int ck = __shfl_sync(LB_FULL, osrc, k);
            if (lane == jj) seg_src = ck;
            if (lane == k) osrc = cj;
        }
    }
    const bool d1 = lane < ncols && seg_src != c0 + lane;
    const bool d2 = lane < cnt && osrc != okey;
    const unsigned m1 = __ballot_sync(LB_FULL, d1);
    const unsigned m2 = __ballot_sync(LB_FULL, d2);
    const unsigned below = (1u << lane) - 1u;
    if (d1) {
        const int i = __popc(m1 & below);
        sm.dst[i] = c0 + lane;
        sm.src[i] = seg_src;
    }
    if (d2) {
        const int i = __popc(m1) + __popc(m2 & below);
        sm.dst[i] = okey;
        sm.src[i] = osrc;
    }
    if (lane == 0) sm.nt = __popc(m1) + __popc(m2);
}

// The gather of columns [c, c + nc), nc <= 32, by the whole block: every
// source read before any destination is written.
template <typename T>
__device__ void gather_cols(T* o, long ld, int c, int nc,
                            const LuBlockSmem& sm) {
    const int tid = threadIdx.x, col = tid & 31, q0 = tid >> 5;
    const int nt = sm.nt;
    T v[2 * LB_W / LB_WARPS];
#pragma unroll
    for (int q = 0; q < 2 * LB_W / LB_WARPS; ++q) {
        const int i = q0 + LB_WARPS * q;
        if (i < nt && col < nc)
            v[q] = __ldcg(o + sm.src[i] * ld + c + col);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2 * LB_W / LB_WARPS; ++q) {
        const int i = q0 + LB_WARPS * q;
        if (i < nt && col < nc) o[sm.dst[i] * ld + c + col] = v[q];
    }
}

}  // namespace slate_torch

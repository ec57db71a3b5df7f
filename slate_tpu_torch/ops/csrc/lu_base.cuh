// Cooperative partial-pivot LU of a column segment: the per-column
// recurrence of the rank-1 panel (lu_panel.cu, one segment over the
// whole width) and of the recursive panel's base case where
// lu_base_grid.cuh does not take the segment (lu_panel_rec.cu: wider
// than 32 columns, or more than 4 x 256 rows a block), and the
// argmax helpers both share.
//
// For each column j of the segment [c0, c0+wseg) of a row-major (m, w)
// panel: argmax of |a| over rows >= j, in f32, the lowest row winning
// ties; a full-row swap (all w columns); the multipliers f32(col) /
// f32(safe) with the pivval == 0 -> 1 safe divide, rounded to the panel
// type; the rank-1 update of the segment's columns right of j. Pivots
// come back as int32 swap targets.
//
// Panel types: f32 and bf16 (T = float / __nv_bfloat16). Arithmetic is
// f32 and every result is rounded to T where the reference rounds it
// (pallas_kernels.py _lu_panel_pallas / _lu_panel_rec_pallas base):
// mu = T(col / safe), then x = T(x - T(mu * u)). Products and
// differences use __fmul_rn/__fsub_rn (no FMA contraction), so f32
// rounds exactly as the plain PyTorch versions do. Shared memory holds
// the values as f32; for bf16 they are bf16-exact.
//
// Bound on an H100: latency, a sequential column recurrence (a pivot
// reduction over all m rows and a row exchange per column). Design:
// ONE cooperative launch of up to one block per SM. Each block owns a
// contiguous slice of rows and keeps its rows' segment in shared
// memory for the whole call, so the rank-1 updates never touch device
// memory. Per column, two grid-wide barriers: after each block posts
// its local argmax candidate, and after the owners of rows j and p
// post those rows; every block then reduces the candidates itself (the
// same p everywhere) and applies the swap and the update to its slice.
// Candidates and posted rows are double-buffered by column parity, so
// no third barrier is needed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace slate_torch {

constexpr int BASE_THREADS = 256;
constexpr int BASE_MAX_BLOCKS = 1024;   // candidate slots per parity

// -- reductions ------------------------------------------------------------

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

// -- the segment factorization -------------------------------------------

// Factors columns [c0, c0 + ncols) of the segment [c0, c0 + wseg)
// (ncols = wseg unless the panel has fewer rows than columns left).
template <typename T>
__global__ void __launch_bounds__(BASE_THREADS)
lu_base_kernel(T* a, int* piv, int m, int w, int c0, int wseg, int ncols,
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
        seg[e] = to_f(a[(long)(r_lo + r) * w + c0 + c]);
    }
    __syncthreads();

    unsigned int epoch = 0;
    for (int jj = 0; jj < ncols; ++jj) {
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
            cand_val[par * BASE_MAX_BLOCKS + b] = best;
            cand_row[par * BASE_MAX_BLOCKS + b] = brow;
        }
        grid_barrier(bar, ++epoch);
        // every block reduces all candidates: the same p everywhere
        if (warp == 0) {
            best = -1.f;
            brow = m;
            for (int i = lane; i < G; i += 32)
                argmax_merge(best, brow,
                             __ldcg(&cand_val[par * BASE_MAX_BLOCKS + i]),
                             __ldcg(&cand_row[par * BASE_MAX_BLOCKS + i]));
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
                    const T t = a[(long)j * w + c];
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
            mults[r - r_lo] =
                rnd<T>(__fdiv_rn(seg[(r - r_lo) * wseg + jj], safe));
        __syncthreads();
        const int ncol = wseg - jj;
        for (int e = tid; e < (r_hi - u_lo) * ncol; e += BASE_THREADS) {
            const int rl = u_lo - r_lo + e / ncol, c = jj + e % ncol;
            const float mu = mults[rl];
            float* t = &seg[rl * wseg + c];
            *t = c == jj ? mu
                         : rnd<T>(__fsub_rn(*t, rnd<T>(__fmul_rn(mu, urow[c]))));
        }
        __syncthreads();
    }

    for (int e = tid; e < nr * wseg; e += BASE_THREADS) {
        const int r = e / wseg, c = e % wseg;
        a[(long)(r_lo + r) * w + c0 + c] = from_f<T>(seg[e]);
    }
}

// Launch the segment factorization of columns [c0, c0+wseg) on
// `stream`. scratch_f holds 2*BASE_MAX_BLOCKS candidate values plus
// 4*wseg posted-row values; scratch_i holds one barrier counter plus
// 2*BASE_MAX_BLOCKS candidate rows. Returns a cudaError_t.
template <typename T>
int launch_lu_base(T* a, int* piv, int m, int w, int c0, int wseg,
                   float* scratch_f, int* scratch_i, cudaStream_t s) {
    // at least 16 rows per block, at most one block per SM
    const int blocks = coop_blocks(m, 16, BASE_MAX_BLOCKS);
    const int rows = (m + blocks - 1) / blocks;
    const int ncols = max(0, min(wseg, m - c0));
    const size_t smem = sizeof(float) * ((size_t)rows * wseg + wseg + rows);
    unsigned int* bar = (unsigned int*)scratch_i;
    float* cand_val = scratch_f;
    float* xrow = scratch_f + 2 * BASE_MAX_BLOCKS;
    int* cand_row = scratch_i + 1;
    void* args[] = {&a, &piv, &m, &w, &c0, &wseg, (void*)&ncols,
                    (void*)&rows, &cand_val, &cand_row, &xrow, &bar};
    return coop_launch(lu_base_kernel<T>, blocks, BASE_THREADS, smem, args,
                       bar, s);
}

}  // namespace slate_torch

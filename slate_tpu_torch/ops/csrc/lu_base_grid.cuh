// The recursive panel's base case for segments of at most 32 columns
// (lu_panel_rec.cu lu_rec_base; wider segments, panels of more than
// 4 x 256 rows a block, and the rank-1 panel keep lu_base.cuh's
// kernel). The same function as lu_base.cuh: for each column j of the
// segment [c0, c0+wseg) of a row-major (m, w) panel, the argmax of |a|
// over rows >= j in f32 (the lowest row wins ties), a full-row swap,
// the multipliers T(f32(col) / f32(safe)) with the pivval == 0 -> 1
// safe divide, and the rank-1 update x = T(x - T(mu * u)) of the
// segment's columns right of j (products and differences by
// __fmul_rn / __fsub_rn); int32 swap targets.
//
// Bound on an H100: latency. Each column needs one reduction over
// every SM that holds rows before the next column can start, so the
// least time is ib exchanges between SMs (~1.1k cycles for a round
// trip through L2 that finds its data ready, by clock64 marks on the
// card), not the segment's bytes. lu_base.cuh takes ~11k cycles a
// column: two grid barriers (~3k and ~2.3k), every block reading all
// candidates from L2, the row swaps in device memory, and the update
// in shared memory.
//
// Design:
//  - one cooperative launch over rows [c0, m) only (the rows above the
//    segment take no part), at least LG_MIN_ROWS rows a block, at most
//    one block per SM; block 0 holds rows c0 .. c0+wseg-1, so it holds
//    every row j;
//  - each thread keeps R rows' segments (R = 1, 2 or 4: as few as a
//    block of LG_THREADS threads allows) in registers for the launch,
//    rotated by one column a step, so the current column is always
//    x[k][0], every register index is known at compile time and the
//    update is branch-free (indexing the current column at run time
//    took a select chain a row and compiled the update to ~100
//    branches: ~3.6k cycles a column);
//  - ONE exchange a column, with no barrier: the owner of each block's
//    candidate posts the candidate (value, row) and its row, and block
//    0 posts row j, as 64-bit words that carry the column's epoch in
//    their high half beside the payload, so a reader polls each word
//    until its epoch appears and needs no fence or counter; warp 0 of
//    every block polls all candidates (its loads batched), reduces them
//    (the same p everywhere), then reads the winner's row and row j;
//    slots alternate by column parity, safe because a block writes
//    column jj+1's slots only after it has read every block's column-jj
//    candidate, posted after that block finished reading column jj-1's;
//    (reading candidates' rows while polling costs more than the round
//    trip it saves: ~18k cycles a column when every thread read every
//    candidate's row, +25% a panel when warp 0 read only its lanes'
//    best ones; a 16-block cluster exchanging through shared memory paid
//    ~1k for its barrier and ~1.7k for the reads, and its 1024 rows an
//    SM made the update 3-4k at 16384 rows);
//  - the epoch is gen * 64 + jj + 1, gen a counter in the scratch that
//    block 0 bumps at the end of the launch (the wrapper zeroes the
//    scratch once a panel), so a launch never reads an earlier one's
//    words, replayed from a CUDA graph or not;
//  - the swaps of the columns outside the segment leave the column
//    loop: after the last column, warp 0 of every block composes the
//    ncols swaps into a permutation of the rows they touch (shuffles
//    and ballots, the order of the swaps kept), and the blocks gather
//    those rows, each thread a column; the pivots go to device memory
//    once, at the end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"
#include "lu_base.cuh"

namespace slate_torch {

constexpr int LG_WMAX = 32;             // widest segment
constexpr int LG_THREADS = 256;         // (512 caps a thread at 128
                                        // registers: the rows spill)
constexpr int LG_MAX_R = 4;             // rows a thread, at most
constexpr int LG_MIN_ROWS = 256;        // rows a block, at least
constexpr int LG_MAX_BLOCKS = 160;      // 5 candidates a lane of warp 0
constexpr int LG_SLOT = 2 + LG_WMAX;    // words: value, row, the row

typedef unsigned long long u64;

__device__ __forceinline__ u64 tagged(unsigned int epoch, unsigned int v) {
    return ((u64)epoch << 32) | v;
}

// Post the 16-byte word pair (x, y) tagged with `epoch`.
__device__ __forceinline__ void post_pair(u64* p, unsigned int epoch,
                                          unsigned int x, unsigned int y) {
    asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};\n"
                 :: "l"(p), "l"(tagged(epoch, x)), "l"(tagged(epoch, y))
                 : "memory");
}

// Load the pair at p; true when both words carry `epoch`.
__device__ __forceinline__ bool peek_pair(const u64* p, unsigned int epoch,
                                          unsigned int& x, unsigned int& y) {
    u64 a, b;
    asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n"
                 : "=l"(a), "=l"(b) : "l"(p) : "memory");
    x = (unsigned int)a;
    y = (unsigned int)b;
    return (unsigned int)(a >> 32) == epoch && (unsigned int)(b >> 32) == epoch;
}

// Words of the scratch: 2 (the generation counter, padding), then per
// column parity `max_blocks` candidate slots and row j's segment.
inline size_t lu_grid_scratch_words(int max_blocks) {
    return 2 + 2 * ((size_t)max_blocks * LG_SLOT + LG_WMAX);
}

// Rotate left by one: x[c] <- x[c + 1], x[W-1] <- x[0].
template <int W>
__device__ __forceinline__ void rotate(float (&x)[W]) {
    const float x0 = x[0];
#pragma unroll
    for (int c = 0; c + 1 < W; ++c) x[c] = x[c + 1];
    x[W - 1] = x0;
}

// x[c] = T(x[c] - T(mu * u[c])) for 1 <= c < end, in groups of 8 that
// are skipped (a uniform branch) when wholly right of `end`.
template <typename T, int W>
__device__ __forceinline__ void rank1(float (&x)[W], const float (&u)[W],
                                      float mu, int end) {
#pragma unroll
    for (int g = 0; g < W / 8; ++g) {
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

// The registers of a thread's rows are rotated by one column a step:
// before column jj's pivot, x[k][c] holds column c0 + (jj + c) % W of
// the segment, so the current column is always x[k][0] and every index
// is known at compile time (rows are posted and read in that order).
// Post row x[kk] (kk < R a runtime index: one branch a row) as W / 2
// tagged word pairs at dst.
template <int R, int W>
__device__ __forceinline__ void post_row(const float (&x)[R][W], int kk,
                                         u64* dst, unsigned int epoch) {
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (k == kk)
#pragma unroll
            for (int q = 0; q < W / 2; ++q)
                post_pair(dst + 2 * q, epoch, __float_as_uint(x[k][2 * q]),
                          __float_as_uint(x[k][2 * q + 1]));
}

// src[c] -> x[kk][c].
template <int R, int W, typename S>
__device__ __forceinline__ void get_row(float (&x)[R][W], int kk,
                                        const S& src) {
#pragma unroll
    for (int k = 0; k < R; ++k)
        if (k == kk)
#pragma unroll
            for (int c = 0; c < W; ++c) x[k][c] = src[c];
}

template <typename T, int R>
__global__ void __launch_bounds__(LG_THREADS)
lu_base_grid_kernel(T* a, int* piv, int m, int w, int c0, int wseg,
                    int ncols, int rpb, u64* scratch) {
    constexpr int W = LG_WMAX;
    constexpr int NP = (LG_MAX_BLOCKS + 31) / 32;
    constexpr unsigned FULL = 0xffffffffu;
    __shared__ float s_val[2][LG_THREADS / 32];
    __shared__ int s_row[2][LG_THREADS / 32];
    __shared__ __align__(16) float s_u[W];
    __shared__ __align__(16) float s_jr[W];
    __shared__ int s_p, s_piv[W], s_nt;
    __shared__ int s_src[2 * W], s_dst[2 * W];
    __shared__ unsigned int s_gen;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nth = blockDim.x, nwarps = nth >> 5;
    const int G = gridDim.x, b = blockIdx.x;
    const int lo = c0 + b * rpb, hi = min(m, lo + rpb);
    const int per_par = G * LG_SLOT + W;

    float x[R][W], u[W];
    int row[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        row[k] = lo + k * nth + tid;
        const bool in = row[k] < hi;
#pragma unroll
        for (int c = 0; c < W; ++c)
            x[k][c] = in && c < wseg ? to_f(a[(long)row[k] * w + c0 + c])
                                     : 0.f;
    }
    if (tid == 0) s_gen = (unsigned int)*(volatile u64*)scratch;
    __syncthreads();
    const unsigned int gen = s_gen;

    for (int jj = 0; jj < ncols; ++jj) {
        const int j = c0 + jj, par = jj & 1;
        const unsigned int ep = gen * 64u + (unsigned int)jj + 1u;
        u64* sl = scratch + 2 + par * per_par;
        u64* jslot = sl + G * LG_SLOT;
        // this block's candidate: the argmax over its rows >= j of
        // x[k][0] (a thread's rows increase with k, so its own ties keep
        // the lowest row)
        float best = -1.f;
        int brow = m;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const float v = fabsf(x[k][0]);
            if (row[k] >= j && row[k] < hi && v > best) {
                best = v;
                brow = row[k];
            }
        }
        warp_argmax(best, brow);
        if (lane == 0) {
            s_val[par][warp] = best;
            s_row[par][warp] = brow;
        }
        __syncthreads();
        best = s_val[par][0];
        brow = s_row[par][0];
        for (int i = 1; i < nwarps; ++i)
            argmax_merge(best, brow, s_val[par][i], s_row[par][i]);
        // post the candidate's row, then the candidate; row j (block 0)
        u64* mine = sl + b * LG_SLOT;
        if (brow < m && tid == (brow - lo) % nth)
            post_row(x, (brow - lo) / nth, mine + 2, ep);
        if (b == 0 && tid == jj % nth) post_row(x, jj / nth, jslot, ep);
        if (tid == (brow < m ? (brow - lo) % nth : 0))
            post_pair(mine, ep, __float_as_uint(best), (unsigned int)brow);
        if (warp == 0) {
            // every block reduces all candidates: the same p everywhere
            float gv = -1.f;
            int gr = m;
            bool got[NP];
#pragma unroll
            for (int t = 0; t < NP; ++t) got[t] = lane + 32 * t >= G;
            bool all;
            do {
                all = true;
#pragma unroll
                for (int t = 0; t < NP; ++t) {
                    if (got[t]) continue;
                    unsigned int v, r;
                    got[t] = peek_pair(sl + (lane + 32 * t) * LG_SLOT, ep, v,
                                       r);
                    if (got[t])
                        argmax_merge(gv, gr, __uint_as_float(v), (int)r);
                    all &= got[t];
                }
            } while (!all);
            warp_argmax(gv, gr);
            gr = __shfl_sync(FULL, gr, 0);
            // an all-NaN column finds no maximum: keep row j
            const int p = gr < m ? gr : j;
            // lanes 0-15 read row p's pairs, lanes 16-31 row j's: every
            // pair, as the rows are rotated (the columns left of the
            // segment's current one, at the end, move with a swap)
            const u64* src = lane < 16
                ? (gr < m ? sl + ((p - c0) / rpb) * LG_SLOT + 2 : jslot)
                : jslot;
            const int q = lane & 15;
            unsigned int v0, v1;
            while (!peek_pair(src + 2 * q, ep, v0, v1)) {
            }
            float* dst = lane < 16 ? s_u : s_jr;
            dst[2 * q] = __uint_as_float(v0);
            dst[2 * q + 1] = __uint_as_float(v1);
            if (lane == 0) {
                s_p = p;
                s_piv[jj] = p;
            }
        }
        __syncthreads();
        const int p = s_p;
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(s_u)[q];
            u[4 * q] = v.x; u[4 * q + 1] = v.y;
            u[4 * q + 2] = v.z; u[4 * q + 3] = v.w;
        }
        if (p != j) {
            // the row swap: block 0's thread of row j takes row p, the
            // owner of row p takes row j
            if (b == 0 && tid == jj % nth) get_row(x, jj / nth, u);
            if (p >= lo && p < hi && tid == (p - lo) % nth)
                get_row(x, (p - lo) / nth, s_jr);
        }
        const float safe = u[0] == 0.f ? 1.f : u[0];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            if (row[k] > j && row[k] < hi) {
                const float mu = rnd<T>(__fdiv_rn(x[k][0], safe));
                x[k][0] = mu;
                rank1<T>(x[k], u, mu, W - jj);
            }
            rotate(x[k]);
        }
    }
    // back to column order: the rows were rotated ncols times
    for (int t = ncols; t < W; ++t)
#pragma unroll
        for (int k = 0; k < R; ++k) rotate(x[k]);
    if (b == 0 && tid < ncols) piv[c0 + tid] = s_piv[tid];

#pragma unroll
    for (int k = 0; k < R; ++k)
        if (row[k] < hi)
#pragma unroll
            for (int c = 0; c < W; ++c)
                if (c < wseg)
                    a[(long)row[k] * w + c0 + c] = from_f<T>(x[k][c]);

    // the swaps outside the segment: content[r], the row whose values
    // row r holds after the swaps, for the rows they touch (lane i:
    // segment row c0+i; lane k < cnt: the k-th row below the segment)
    if (warp == 0) {
        int seg_src = c0 + lane, okey = -1, osrc = -1, cnt = 0;
        for (int jj = 0; jj < ncols; ++jj) {
            const int p = s_piv[jj];
            if (p == c0 + jj) continue;
            const int cj = __shfl_sync(FULL, seg_src, jj);
            if (p < c0 + ncols) {
                const int q = p - c0;
                const int cq = __shfl_sync(FULL, seg_src, q);
                if (lane == jj) seg_src = cq;
                if (lane == q) seg_src = cj;
            } else {
                const unsigned hit = __ballot_sync(FULL, okey == p);
                const int k = hit ? __ffs(hit) - 1 : cnt;
                if (!hit) {
                    if (lane == k) okey = osrc = p;
                    ++cnt;
                }
                const int ck = __shfl_sync(FULL, osrc, k);
                if (lane == jj) seg_src = ck;
                if (lane == k) osrc = cj;
            }
        }
        const bool d1 = lane < ncols && seg_src != c0 + lane;
        const bool d2 = lane < cnt && osrc != okey;
        const unsigned m1 = __ballot_sync(FULL, d1);
        const unsigned m2 = __ballot_sync(FULL, d2);
        const unsigned below = (1u << lane) - 1u;
        if (d1) {
            const int i = __popc(m1 & below);
            s_dst[i] = c0 + lane;
            s_src[i] = seg_src;
        }
        if (d2) {
            const int i = __popc(m1) + __popc(m2 & below);
            s_dst[i] = okey;
            s_src[i] = osrc;
        }
        if (lane == 0) s_nt = __popc(m1) + __popc(m2);
    }
    __syncthreads();
    const int nt = s_nt;
    const int noff = w - wseg;
    for (int oc = b * nth + tid; nt > 0 && oc < noff; oc += G * nth) {
        const int col = oc < c0 ? oc : oc + wseg;
        T v[2 * W];
#pragma unroll
        for (int i = 0; i < 2 * W; ++i)
            if (i < nt) v[i] = a[(long)s_src[i] * w + col];
#pragma unroll
        for (int i = 0; i < 2 * W; ++i)
            if (i < nt) a[(long)s_dst[i] * w + col] = v[i];
    }
    if (b == 0 && tid == 0)
        *(volatile u64*)scratch = (u64)gen + 1u;
}

// Blocks and rows a block of the launch over rows [c0, m).
inline void lu_grid_geometry(int m, int c0, int max_blocks, int& G,
                             int& rpb) {
    const int rows = m - c0 > 1 ? m - c0 : 1;
    G = (rows + LG_MIN_ROWS - 1) / LG_MIN_ROWS;
    max_blocks = max_blocks < LG_MAX_BLOCKS ? max_blocks : LG_MAX_BLOCKS;
    G = G < max_blocks ? G : max_blocks;
    G = G > 1 ? G : 1;
    rpb = (rows + G - 1) / G;
}

// Whether the kernel takes the segment: at most LG_WMAX columns and at
// most LG_MAX_R rows a thread.
inline bool lu_base_grid_takes(int m, int c0, int wseg, int max_blocks) {
    int G, rpb;
    lu_grid_geometry(m, c0, max_blocks, G, rpb);
    return wseg <= LG_WMAX && rpb <= LG_MAX_R * LG_THREADS;
}

template <typename T, int R>
cudaError_t launch_grid_r(T* a, int* piv, int m, int w, int c0, int wseg,
                          int ncols, int G, int rpb, u64* scratch,
                          cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(((rpb + R - 1) / R + 31) / 32 * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, lu_base_grid_kernel<T, R>, a, piv, m, w,
                              c0, wseg, ncols, rpb, scratch);
}

// Launch the base case of columns [c0, c0+wseg) (lu_base_grid_takes)
// over at most `max_blocks` blocks (at most one a SM), `scratch` holding
// lu_grid_scratch_words(max_blocks) words zeroed before the panel's
// first launch. Returns a cudaError_t.
template <typename T>
int launch_lu_base_grid(T* a, int* piv, int m, int w, int c0, int wseg,
                        int max_blocks, u64* scratch, cudaStream_t s) {
    const int ncols = max(0, min(wseg, m - c0));
    if (ncols == 0) return (int)cudaGetLastError();
    int G, rpb;
    lu_grid_geometry(m, c0, max_blocks, G, rpb);
    const cudaError_t e =
        rpb <= LG_THREADS
            ? launch_grid_r<T, 1>(a, piv, m, w, c0, wseg, ncols, G, rpb,
                                  scratch, s)
        : rpb <= 2 * LG_THREADS
            ? launch_grid_r<T, 2>(a, piv, m, w, c0, wseg, ncols, G, rpb,
                                  scratch, s)
            : launch_grid_r<T, 4>(a, piv, m, w, c0, wseg, ncols, G, rpb,
                                  scratch, s);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

}  // namespace slate_torch

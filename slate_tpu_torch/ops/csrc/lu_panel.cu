// Rank-1-per-column partial-pivot LU panel: the device work of
// ops/kernels.py lu_panel.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_lu_panel_pallas (the
// reference's cold bf16 panel route, the lo-precision factor of
// gesv_mixed). Per column j of an (m, w) panel, w <= 256: argmax of |a|
// over rows >= j in f32 (first maximum wins), full-row swap,
// pivval == 0 -> 1 safe divide in f32 with the multiplier rounded to
// the panel type, rank-1 update of every column > j in the panel type
// (for bf16: x = bf16(x - bf16(mu * u)), one rounding per op), the
// multipliers written below the diagonal, pivots as int32 swap targets.
// f32 and bf16 panels (the `bf16` argument).
//
// Bound on an H100: m w^2 - w^3/3 FLOPs; at 4096 x 256 that is 263
// MFLOP, about 4 us at the 67 TFLOP/s f32 rate (the panel read once and
// written once is 4 MB in bf16, 8 MB in f32: 1.3-2.5 us). It is
// latency-bound on the w-column recurrence instead: every column needs
// a reduction over all m rows and a row exchange between SMs before the
// next can start (~1.1k cycles a round trip through L2: 0.142 ms at
// w = 256).
//
// Design: the rank-1 recurrence taken as a right-looking sweep of
// 32-column segments, each entry receiving the same operations in the
// same order, so the packed LU and the pivots are bitwise those of the
// column-by-column recurrence (lu_panel_plain). Per segment [c0, c1):
//  1. the base case factors the segment's columns: where its rows
//     [c0, m) are at most BLOCK_MAX_ROWS (768), lu_base_block.cuh's in
//     one block, whose exchange of a column stays inside one SM (~1.9k
//     and ~3.2k cycles a column at 1 and 2 rows a thread); else
//     lu_base_grid.cuh's (rows in registers over up to one block a SM,
//     one epoch-tagged exchange through L2 a column, ~6.5-6.9k cycles:
//     a single block exchanging with itself through L2 took 5.6k a
//     column at 256 rows). Either
//     closes with a gather of the segment's row swaps into every column
//     outside it, so the trailing columns hold the rows in their final
//     places before step 2;
//  2. one launch (lu_trail_kernel) applies the segment's 32 rank-1
//     updates to the trailing columns [c1, w), c1 = c0 + 32 (a segment
//     that runs past the last row, m - c0 < 32, has updated all of its
//     own columns already and takes only those right of it, with no
//     rows below it): for rows [c0, c1) the
//     unit-lower substitution x_i = T(x_i - T(l_ir x_r)), r < i in
//     order (the values those rows have when the recurrence uses them
//     as pivot rows), for rows >= c1 x = T(x - T(l_rj u_jc)), j = c0 ...
//     c1 - 1 in order. Every block solves the 32-row substitution of
//     its 32 columns itself in shared memory (one warp four columns,
//     one lane a row, ~1.2k cycles), so the launch needs no exchange;
//     the blocks of the first row tile write those rows back.
// The segments' updates reach every entry in column order because a
// segment's base case starts only after the previous segment's trail
// launch (one stream). One C call: the exchange scratch is zeroed once
// (the epochs of the base case restart above every word), then the
// 2 ceil(w / 32) - 1 launches, so the wrapper counts one launch a panel
// and the call replays from a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lu_base_block.cuh"
#include "lu_base_grid.cuh"

namespace {

using slate_torch::from_f;
using slate_torch::rnd;
using slate_torch::to_f;

constexpr int TR_THREADS = 256;
constexpr int SEG = slate_torch::LG_WMAX;   // segment width (32)
constexpr int TC = 32;                      // trailing columns a block
constexpr int TM = 128;                     // trailing rows a block
constexpr int PAD = SEG + 1;                // conflict-free row pitch
// most rows of a segment whose base case runs in one block: at four rows
// a thread (1024 rows) the block (~5-7k cycles a column) loses to the
// grid (measured at 1024 x 256 on an H100: 0.95 / 1.24 ms f32 / bf16
// in one block, 0.91 / 1.04 over the grid); at 768 rows f32 gains
// (0.80 against 0.90 ms) and bf16 breaks even
constexpr int BLOCK_MAX_ROWS = 768;

// The ws factored columns of segment [c0, cb) of the row-major (m, w)
// panel `a` applied to the trailing columns [cb, w): block (x, y) takes
// columns cb + TC x ... and, with rows [c0, c0 + ws) solved in shared
// memory, rows c0 + ws + TM y ... below them (ws < cb - c0 only where
// the segment runs past the last row, and then there are none).
template <typename T>
__global__ void __launch_bounds__(TR_THREADS)
lu_trail_kernel(T* a, int m, int w, int c0, int ws, int cb) {
    __shared__ float L11[SEG][PAD];     // unit-lower block, by rows
    __shared__ float U[SEG][PAD];       // the segment rows' tile
    __shared__ float L21[TM][PAD];      // multipliers of the row tile
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int c1 = c0 + ws;
    const int col0 = cb + TC * blockIdx.x;
    const int ncol = min(TC, w - col0);
    const int r0 = c1 + TM * blockIdx.y;
    const int nrow = max(0, min(TM, m - r0));

    for (int e = tid; e < SEG * SEG; e += TR_THREADS) {
        const int r = e / SEG, c = e % SEG;
        L11[r][c] = r < ws && c < ws ? to_f(a[(long)(c0 + r) * w + c0 + c])
                                     : 0.f;
        U[r][c] = r < ws && c < ncol
            ? to_f(a[(long)(c0 + r) * w + col0 + c]) : 0.f;
    }
    for (int e = tid; e < TM * SEG; e += TR_THREADS) {
        const int r = e / SEG, c = e % SEG;
        L21[r][c] = r < nrow && c < ws
            ? to_f(a[(long)(r0 + r) * w + c0 + c]) : 0.f;
    }
    __syncthreads();
    // the substitution: warp `warp` columns 4 warp ... 4 warp + 3,
    // lane i row c0 + i; row r is final when step r reads it
    {
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = U[lane][4 * warp + q];
        for (int r = 0; r + 1 < ws; ++r) {
            const float l = L11[lane][r];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float xr = __shfl_sync(0xffffffffu, x[q], r);
                if (lane > r)
                    x[q] = rnd<T>(__fsub_rn(x[q], rnd<T>(__fmul_rn(l, xr))));
            }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 4; ++q) U[lane][4 * warp + q] = x[q];
    }
    __syncthreads();
    if (blockIdx.y == 0)
        for (int e = tid; e < ws * TC; e += TR_THREADS) {
            const int r = e / TC, c = e % TC;
            if (c < ncol)
                a[(long)(c0 + r) * w + col0 + c] = from_f<T>(U[r][c]);
        }
    // the rows below: lane a column, warp `warp` rows warp + 8 i
    constexpr int RPT = TM / (TR_THREADS / 32);
    if (lane >= ncol) return;
    float x[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = warp + 8 * i;
        x[i] = r < nrow ? to_f(a[(long)(r0 + r) * w + col0 + lane]) : 0.f;
    }
    for (int j = 0; j < ws; ++j) {
        const float u = U[j][lane];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
            x[i] = rnd<T>(__fsub_rn(
                x[i], rnd<T>(__fmul_rn(L21[warp + 8 * i][j], u))));
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = warp + 8 * i;
        if (r < nrow) a[(long)(r0 + r) * w + col0 + lane] = from_f<T>(x[i]);
    }
}

// The base case of a segment whose rows fit one block (lu_base_block.cuh:
// no exchange between SMs), then the segment's swaps gathered into every
// other column, as lu_base_grid.cuh's closing gather.
template <typename T>
__global__ void __launch_bounds__(slate_torch::LB_THREADS, 1)
lu_block_kernel(T* a, int* piv, int m, int w, int c0, int wseg) {
    __shared__ slate_torch::LuBlockSmem sm;
    slate_torch::lu_block_factor_any<T>(a, piv, w, m, c0, wseg, sm);
    __syncthreads();
    slate_torch::swap_lists(piv, c0, wseg, sm);
    __syncthreads();
    for (int c = 0; c < c0; c += TC)
        slate_torch::gather_cols(a, w, c, min(TC, c0 - c), sm);
    for (int c = c0 + wseg; c < w; c += TC)
        slate_torch::gather_cols(a, w, c, min(TC, w - c), sm);
}

// Whether a segment's base case runs in one block: at most
// BLOCK_MAX_ROWS rows, and every column of it has a pivot row.
inline bool block_takes(int m, int c0, int wseg) {
    return m - c0 <= BLOCK_MAX_ROWS && m - c0 >= wseg;
}

template <typename T>
int panel(T* a, int* piv, int m, int w, unsigned long long* scratch,
          cudaStream_t s) {
    int max_blocks = slate_torch::sm_count();
    max_blocks = max_blocks < slate_torch::LG_MAX_BLOCKS
        ? max_blocks : slate_torch::LG_MAX_BLOCKS;
    const int last = m < w ? m : w;
    for (int c0 = 0; c0 < last; c0 += SEG) {
        const int wseg = min(SEG, w - c0);
        if (!block_takes(m, c0, wseg)
            && !slate_torch::lu_base_grid_takes(m, c0, wseg, max_blocks))
            return (int)cudaErrorInvalidValue;
    }
    cudaError_t e = cudaMemsetAsync(
        scratch, 0, 8 * slate_torch::lu_grid_scratch_words(max_blocks), s);
    if (e != cudaSuccess) return (int)e;
    for (int c0 = 0; c0 < last; c0 += SEG) {
        const int wseg = min(SEG, w - c0);
        if (block_takes(m, c0, wseg)) {
            lu_block_kernel<T><<<1, slate_torch::LB_THREADS, 0, s>>>(
                a, piv, m, w, c0, wseg);
            e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        } else {
            const int rc = slate_torch::launch_lu_base_grid(
                a, piv, m, w, c0, wseg, max_blocks, scratch, s);
            if (rc != 0) return rc;
        }
        // the base case has updated the segment's own columns
        const int ws = min(wseg, m - c0), c1 = c0 + ws, cb = c0 + wseg;
        if (cb >= w) continue;
        const dim3 grid((w - cb + TC - 1) / TC,
                        m > c1 ? (m - c1 + TM - 1) / TM : 1);
        lu_trail_kernel<T><<<grid, TR_THREADS, 0, s>>>(a, m, w, c0, ws, cb);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The whole (m, w) panel `a`, in place, int32 swap targets into `piv`.
// scratch_f: the base case's exchange, lu_grid_scratch_words(
// LG_MAX_BLOCKS) 64-bit words (zeroed here); scratch_i is not read (the
// first design's barrier word, kept so the entry's arguments stay
// those of the parent).
int lu_panel(void* a, int* piv, int m, int w, float* scratch_f,
             int* scratch_i, int bf16, void* stream) {
    (void)scratch_i;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned long long* g = (unsigned long long*)scratch_f;
    if (bf16) return panel((__nv_bfloat16*)a, piv, m, w, g, s);
    return panel((float*)a, piv, m, w, g, s);
}

// Whether the segment of an (m, w) panel that starts at column c0 runs
// its base case in one block (else over the grid): what a report needs
// for the segment's latency floor.
int lu_panel_block_takes(int m, int w, int c0) {
    return block_takes(m, c0, min(SEG, w - c0));
}

}  // extern "C"

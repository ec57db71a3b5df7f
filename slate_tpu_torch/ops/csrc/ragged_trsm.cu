// Ragged batched triangular solve: the device work of ops/kernels.py
// ragged_trsm.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_trsm_pallas (a grid
// over the batch; per element a blocked substitution over ceil(s/blk)
// blocks of the effective system, backward when upper != trans). Per
// block, as the reference: the rows in order, each
//   x_r = T((x_r - w . x_solved) / d)
// over the block's rows already solved (w is row r of the packed
// factor, or its column r when trans; d = 1 with a unit diagonal, a
// zero d divides by 1; the sum in f32), then the update of the rows
// still to solve, x_t = T(x_t - T(sum_i t_ti x_i)) (t_it when trans),
// one block at a time, in block order. All eight (upper, trans, unit)
// combinations. Only the live s x s block of the factors and the first
// s rows of the right-hand side are read; rows past s come back zero.
// T is f32 or bf16, arithmetic f32.
//
// Bound on an H100: at the serving shape (K = 1) the bytes of the live
// triangles, the right-hand sides and the solutions (~8 MB at the first
// flush, 2.4 us at 3.35 TB/s) or the latency of the largest element's
// s dependent rows, each a product-add, a subtract, a divide and a
// broadcast (~5 us at s = 608), whichever is larger. The first version
// (one warp an element, 64 one-warp blocks at the first flush) took
// ~1500 cycles a row: every substitution row loaded the factor's row
// (or, transposed, a column strided by n) from device memory on the
// chain, reduced it by a 5-step shuffle tree and synchronised the warp.
//
// Design: one block of 16 warps per (element, group of KC right-hand
// sides; KC = 1 for one, else 4), the solution in shared memory, a
// block barrier a blk-row block ("phase"):
//  - warp 0 walks the chain: lane l holds row k0 + l of the current
//    block and that row's blk coefficients of the block, in registers,
//    read from a 32 x 33 tile staged in shared memory one phase ahead
//    (so a transposed read costs what a plain one does). Per row the
//    solving lane divides, the value is broadcast by one shuffle and
//    every lane adds its product; there is no reduction on the chain.
//    The divide is a multiply by the reciprocal (taken off the chain)
//    and two FMAs, exact while the quotient stays inside [2^-120,
//    2^120] (band_gemm.cuh div_rn); the range check is off the chain
//    too: should any row leave it, the block is solved again with
//    __fdiv_rn (div_rn's check on the chain cost ~60 of ~130 cycles a
//    row, by clock64 marks).
//    The same broadcast feeds the next block's rows (a second staged
//    tile), so the next block's update by this one is ready when the
//    barrier falls, and the next solve starts at once;
//  - warps 1-15 do everything else, off the chain: they stage the next
//    phase's two tiles, and apply the previous block's update to every
//    row past the current block, a 32-row tile a warp (the factor read
//    coalesced in either orientation, through the warp's own padded
//    tile in shared memory). Each target row thus receives the per-block
//    rounded updates T(x - T(sum)) one block at a time, in block order,
//    as the reference applies them, and the factor is read once.
// clock64 marks (H100, the largest element's block, a 32-row phase):
// warp 0 takes ~1.0k cycles to set up and ~3.0k to solve (~97 a row);
// the helpers keep up in f32 at the first flush (2.6-3.5k), not at the
// order-1024 flush (4.2-5.3k, ~1.5k of waiting a phase), nor in bf16
// (5.6-6.3k and 8.4-9.3k: their tile loads take ~2.8x the f32 time,
// also with every load issued first, not understood yet). Not done:
// several right-hand-side columns a warp beyond KC, the elements
// ordered largest first (64 blocks of a flush fit the card at once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "band_gemm.cuh"
#include "ragged.cuh"

namespace {

using namespace slate_torch;

constexpr int TR_THREADS = 512;
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int TR_HELPERS = TR_WARPS - 1;
constexpr int TR_TS = 33;                  // padded tile row
constexpr int TR_TILE = 32 * TR_TS;        // floats of a tile
constexpr int TR_MAX_KC = 4;

// coef(r0 + lt, c0 + i) of the effective system (t[r][i], or t[i][r]
// when trans) for lt < nr, i < nc into registers: lane l holds the q-th
// entry of its coalesced line in v[q] (trans: lt = l, i = q; else
// lt = q, i = l); zero outside.
template <typename T>
__device__ __forceinline__ void load_tile(float (&v)[32], const T* t, int n,
                                          int trans, int r0, int nr, int c0,
                                          int nc, int lane) {
    const int nq = trans ? nc : nr, nl = trans ? nr : nc;
    const T* base = trans ? t + (long)c0 * n + r0 : t + (long)r0 * n + c0;
#pragma unroll
    for (int q = 0; q < 32; ++q)
        v[q] = q < nq && lane < nl ? to_f(base[(long)q * n + lane]) : 0.f;
}

// The registers of load_tile into tile[lt * TR_TS + i].
__device__ __forceinline__ void store_tile(float* tile, const float (&v)[32],
                                           int trans, int lane) {
#pragma unroll
    for (int q = 0; q < 32; ++q)
        tile[trans ? lane * TR_TS + q : q * TR_TS + lane] = v[q];
    __syncwarp();
}

// Warp 0's solve of one block (lane l <-> row k0 + l, the ri-th row
// solved is lane r = ri, or nb - 1 - ri backward): x in, the solution
// out, accn the next block's sums. EXACT divides by __fdiv_rn; else by
// the reciprocal (band_gemm.cuh div_rn without its check), returning
// whether a solving lane's quotient left the range where that is exact
// (div_rn's check, taken off the chain: the caller then solves again).
template <typename T, int KC, bool EXACT>
__device__ __forceinline__ bool solve_block(float (&x)[KC],
                                            float (&accn)[KC],
                                            const float (&cd)[32],
                                            const float (&cs)[32], float d,
                                            float rc, int nb, bool back,
                                            int lane) {
    float acc[KC];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) acc[kc] = accn[kc] = 0.f;
    bool bad = false;
#pragma unroll
    for (int ri = 0; ri < 32; ++ri) {
        if (ri >= nb) break;
        const int r = back ? nb - 1 - ri : ri;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
            const float a = __fsub_rn(x[kc], acc[kc]);
            float q;
            if (EXACT) {
                q = __fdiv_rn(a, d);
            } else {
                q = __fmul_rn(a, rc);
                q = fmaf(fmaf(-q, d, a), rc, q);
                bad |= lane == r && a != 0.f
                    && !(fabsf(q) >= 0x1p-120f && fabsf(q) <= 0x1p120f);
            }
            q = rnd<T>(q);
            x[kc] = lane == r ? q : x[kc];
            const float xi = __shfl_sync(0xffffffffu, x[kc], r);
            acc[kc] = fmaf(cd[ri], xi, acc[kc]);
            accn[kc] = fmaf(cs[ri], xi, accn[kc]);
        }
    }
    return bad;
}

// First row and row count of the block at processing index p.
__device__ __forceinline__ void block_rows(int p, int nblk, bool back,
                                           int blk, int s, int& k0,
                                           int& nb) {
    const int kb = back ? nblk - 1 - p : p;
    k0 = kb * blk;
    nb = min(blk, s - k0);
}

template <typename T, int KC>
__global__ void __launch_bounds__(TR_THREADS, 1)
ragged_trsm_kernel(const T* t_all, const T* b_all, T* o_all,
                   const int* sizes, int n, int K, int blk, int upper,
                   int trans, int unit) {
    extern __shared__ float smem[];
    float* xs = smem;                                 // KC x n
    float* dtile = xs + KC * n;                       // 2 tiles
    float* stile = dtile + 2 * TR_TILE;               // 2 tiles
    float* htile = stile + 2 * TR_TILE;               // one a helper
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x, kq = blockIdx.y * KC;
    const int s = ragged_order(sizes, e, n);
    const T* t = t_all + (long)e * n * n;
    const T* rhs = b_all + (long)e * n * K;
    T* o = o_all + (long)e * n * K;
    const bool back = (upper != 0) != (trans != 0);
    const int nblk = (s + blk - 1) / blk;

    for (int i = threadIdx.x; i < KC * s; i += TR_THREADS) {
        const int kc = i / s, r = i - kc * s;
        xs[kc * n + r] = kq + kc < K ? to_f(rhs[(long)r * K + kq + kc]) : 0.f;
    }
    if (warp == 1 && nblk > 0) {
        float v[32];
        int k0, nb, q0, nq;
        block_rows(0, nblk, back, blk, s, k0, nb);
        load_tile(v, t, n, trans, k0, nb, k0, nb, lane);
        store_tile(dtile, v, trans, lane);
        if (nblk > 1) {
            block_rows(1, nblk, back, blk, s, q0, nq);
            load_tile(v, t, n, trans, q0, nq, k0, nb, lane);
            store_tile(stile, v, trans, lane);
        }
    }
    __syncthreads();

    float accp[KC];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) accp[kc] = 0.f;
    for (int p = 0; p < nblk; ++p) {
        int k0, nb;
        block_rows(p, nblk, back, blk, s, k0, nb);
        if (warp == 0) {
            // the chain: lane l <-> row k0 + l; the ri-th row solved is
            // lane r = ri (forward) or nb - 1 - ri, its coefficients
            // cd[ri] (this block's column) and cs[ri] (the next block's)
            const float* dt = dtile + (p & 1) * TR_TILE + lane * TR_TS;
            const float* st = stile + (p & 1) * TR_TILE + lane * TR_TS;
            float cd[32], cs[32];
#pragma unroll
            for (int c = 0; c < 32; ++c) {
                const int col = back ? nb - 1 - c : c;
                cd[c] = c < nb ? dt[col] : 0.f;
                cs[c] = c < nb ? st[col] : 0.f;
            }
            float d = unit ? 1.f : dt[lane];
            if (d == 0.f) d = 1.f;
            const float rc = rcp_rn(d);
            float x[KC], x0[KC], accn[KC];
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                x[kc] = lane < nb ? xs[kc * n + k0 + lane] : 0.f;
                if (p > 0) x[kc] = rnd<T>(__fsub_rn(x[kc], rnd<T>(accp[kc])));
                x0[kc] = x[kc];
            }
            if (__any_sync(0xffffffffu, solve_block<T, KC, false>(
                    x, accn, cd, cs, d, rc, nb, back, lane))) {
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) x[kc] = x0[kc];
                solve_block<T, KC, true>(x, accn, cd, cs, d, rc, nb, back,
                                         lane);
            }
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                if (lane < nb) xs[kc * n + k0 + lane] = x[kc];
                accp[kc] = accn[kc];
            }
        } else {
            // jobs: the next phase's two tiles, then the previous block's
            // update of every row past this block (this block's rows had
            // it from warp 0), a tile a job
            const int h = warp - 1;
            int p0 = 0, np = 0;
            if (p > 0) block_rows(p - 1, nblk, back, blk, s, p0, np);
            const int nstage = p + 1 < nblk ? (p + 2 < nblk ? 2 : 1) : 0;
            const int nupd = p > 0 ? nblk - p - 1 : 0;
            float* mine = htile + h * TR_TILE;
            for (int job = h; job < nstage + nupd; job += TR_HELPERS) {
                float v[32];
                if (job < nstage) {
                    int c0, nc, r0, nr;
                    block_rows(p + 1, nblk, back, blk, s, c0, nc);
                    block_rows(p + 1 + job, nblk, back, blk, s, r0, nr);
                    load_tile(v, t, n, trans, r0, nr, c0, nc, lane);
                    store_tile((job ? stile : dtile) + ((p + 1) & 1) * TR_TILE,
                               v, trans, lane);
                    continue;
                }
                int r0, nr;
                block_rows(p + 1 + job - nstage, nblk, back, blk, s, r0, nr);
                load_tile(v, t, n, trans, r0, nr, p0, np, lane);
                store_tile(mine, v, trans, lane);
                float acc[KC];
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) acc[kc] = 0.f;
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                    if (i >= np) break;
                    const float c = mine[lane * TR_TS + i];
#pragma unroll
                    for (int kc = 0; kc < KC; ++kc)
                        acc[kc] = fmaf(c, xs[kc * n + p0 + i], acc[kc]);
                }
                if (lane < nr)
#pragma unroll
                    for (int kc = 0; kc < KC; ++kc) {
                        float* xt = &xs[kc * n + r0 + lane];
                        *xt = rnd<T>(__fsub_rn(*xt, rnd<T>(acc[kc])));
                    }
                __syncwarp();
            }
        }
        __syncthreads();
    }

    for (int i = threadIdx.x; i < KC * n; i += TR_THREADS) {
        const int kc = i / n, r = i - kc * n;
        if (kq + kc < K)
            o[(long)r * K + kq + kc] = from_f<T>(r < s ? xs[kc * n + r] : 0.f);
    }
}

size_t smem_bytes(int n, int kc) {
    return sizeof(float) * ((size_t)kc * n + (4 + TR_HELPERS) * TR_TILE);
}

template <typename T, int KC>
int launch(const void* t, const void* b, void* o, const int* sizes,
           int batch, int n, int K, int blk, int upper, int trans, int unit,
           cudaStream_t stream) {
    // the attribute once, at the largest ceiling the gate lets through
    static bool attr_set = false;
    if (!attr_set) {
        const int rc = ragged_smem(ragged_trsm_kernel<T, KC>,
                                   smem_bytes(1024, KC));
        if (rc != 0) return rc;
        attr_set = true;
    }
    const dim3 grid(batch, (K + KC - 1) / KC);
    ragged_trsm_kernel<T, KC><<<grid, TR_THREADS, smem_bytes(n, KC),
                                stream>>>(
        (const T*)t, (const T*)b, (T*)o, sizes, n, K, blk, upper, trans,
        unit);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_kc(const void* t, const void* b, void* o, const int* sizes,
              int batch, int n, int K, int blk, int upper, int trans,
              int unit, cudaStream_t stream) {
    if (batch <= 0 || n <= 0 || K <= 0) return (int)cudaGetLastError();
    if (blk < 1 || blk > RG_MAX_BLK || n > 1024)
        return (int)cudaErrorInvalidValue;
    return K == 1 ? launch<T, 1>(t, b, o, sizes, batch, n, K, blk, upper,
                                 trans, unit, stream)
                  : launch<T, TR_MAX_KC>(t, b, o, sizes, batch, n, K, blk,
                                         upper, trans, unit, stream);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Solve the (batch, n, n) row-major factors `t` against the (batch, n, K)
// right-hand sides `b` into `o` (which may be `b`), per-element orders
// `sizes` (int32, device), blocks of `blk` <= 32 rows, n <= 1024, the
// upper / transposed / unit-diagonal system as flagged, f32 or bf16
// (bf16 != 0), on `stream`. Returns a cudaError_t.
int ragged_trsm(const void* t, const void* b, void* o, const int* sizes,
                int batch, int n, int K, int blk, int upper, int trans,
                int unit, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch_kc<__nv_bfloat16>(t, b, o, sizes, batch, n, K, blk,
                                           upper, trans, unit, s)
                : launch_kc<float>(t, b, o, sizes, batch, n, K, blk, upper,
                                   trans, unit, s);
}

}  // extern "C"

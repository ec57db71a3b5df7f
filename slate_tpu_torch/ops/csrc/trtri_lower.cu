// Inverse of a lower-triangular block by blocked forward substitution:
// the device work of ops/kernels.py trtri_lower.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_trtri_lower_pallas (n <=
// 512, n % 128 == 0, f32). Row j of X = inv(L) is
//   x_j = (e_j - L[j, :j] X[:j, :]) / L[j, j],
// the products accumulated in f32, a zero diagonal entry taken as 1,
// and no divide at all with a unit diagonal. Entries above the diagonal
// are 0. No product of two inverses: the reference keeps substitution
// numerics because product forms overflow for unit-lower LU blocks.
//
// Bound on an H100: n^3 / 3 FLOPs, 44.7 MFLOP at n = 512, 0.67 us at
// the f32 rate (1 MB read, 1 MB written: 0.6 us). What holds it back
// is the substitution's chain: column c of X depends on every row
// above it, n - c dependent divides, so one column cannot be spread
// over the card. The first version gave each column one warp and
// walked 512 rows of shuffle-reduced dot products, ~0.9 us a row.
//
// Design: the columns of X are independent, so each block of 256
// threads takes 32 of them, X[:, c0:c0+32], and walks its 32-row blocks
// j0 = c0, c0 + 32, ... in order. For each:
//  1. B = L[j0:j0+32, c0:j0] X[c0:j0, c0:c0+32], the split-K product of
//     band_gemm.cuh on the row band L[j0:j0+32, c0:j0+32] (in shared
//     memory) and the block's finished rows of X (in shared memory,
//     transposed: 32 x n, 66 KB at n = 512, so both operands are
//     k-contiguous). All of it but the last 32 of K was computed ahead
//     (3.), so the eight warps take the last 32, four each;
//  2. warp 0 solves the 32 x 32 diagonal block against B, one lane a
//     column (no shuffle, no reduction): for k ascending,
//     x_k = (delta - b_k) / L_kk, then b_r += L_rk x_k for the rows
//     below. The loop over k stays rolled: the b_r rotate down one
//     register a step (b_r <- b_{r+1} + L x_k), from row 8 q on only the
//     31 - 8 q still in the block, and the diagonal block's columns are
//     stored shifted (lsh[k][i] = L[k + 1 + i][k]), read with aligned
//     16-byte loads that are issued for row k + 1 before row k's value
//     is stored, two rows a turn. The divide goes through the divisors'
//     reciprocals, taken beforehand (div_rn, exact). The solved rows
//     stay in shared memory only;
//  3. meanwhile six warps (not warp 4, which shares warp 0's scheduler)
//     write the previous block's rows of X out, fetch the next row band
//     (cp.async) and compute the next block's product over the rows
//     solved before this block.
// The solve is the chain: with the look-ahead a block costs about one
// solve of 32 rows (one warp, ~200 cycles a row on an H100) plus a
// 32-deep product and two barriers.
// Each b_r sums the products of the finished row blocks (in the split-K
// order) and then those of its own block in k order: the order of the
// sum differs from the plain version's, its terms do not. A block whose
// products are all exact (a diagonal L, the lower triangle of ones)
// gives bitwise the plain version's X.

#include <cuda_runtime.h>

#include "band_gemm.cuh"

namespace {

using namespace slate_torch;

constexpr int TR_MAX_N = 512;
constexpr int TB = 32;                 // columns a block, rows a step
constexpr int PT_LD = TB + 1;
// The look-ahead's warps: all but warp 0 (the solve) and warp 4, which
// shares warp 0's scheduler.
constexpr int PRODUCERS = BG_WARPS - 2;

// Row pitch of the band and of X^T: 4 words mod 32 (band_gemm.cuh).
__host__ __device__ inline int tr_ld(int n) { return ((n + 31) & ~31) + 4; }

inline size_t tr_smem_bytes(int n) {
    return sizeof(float) * ((size_t)2 * TB * tr_ld(n) + BG_RED_FLOATS
                            + PRODUCERS * 32 * BG_RED_LD
                            + 2 * TB * PT_LD + TB * TB + 2 * TB);
}

__device__ __forceinline__ int producer_index(int warp) {
    return warp == 0 || warp == 4 ? -1 : warp - 1 - (warp > 4);
}

// Rows j0 .. j0 + 31 of L, columns [c0, c0 + w), into band[r][col - c0]
// (zero past n), by producer p of PRODUCERS (their own copies: they wait
// for them themselves). VEC: 16-byte copies (n % 4 == 0).
template <bool VEC>
__device__ __forceinline__ void load_band(float* band, int ld,
                                          const float* L, int n, int j0,
                                          int c0, int w, int p) {
    const int lane = threadIdx.x & 31;
    for (int r = p; r < TB; r += PRODUCERS) {
        const int row = j0 + r;
        const bool rin = row < n;
        const float* src = L + (long)(rin ? row : 0) * n + c0;
        float* dst = band + r * ld;
        if (VEC) {
            for (int q = lane * 4; q < w; q += 128) {
                const bool in = rin && c0 + q < n;
                bg_cp16(dst + q, in ? src + q : L, in ? 16 : 0);
            }
        } else {
            for (int q = lane; q < w; q += 32)
                bg_cp4(dst + q, rin && c0 + q < n ? src + q : L,
                       rin && c0 + q < n);
        }
    }
}

// What a lane's solve of the diagonal block reads and writes.
struct Solve {
    int j0, K, col, ld;
    bool unit;
    float* xt;
    const float* lsh;
    const float* dg;
    const float* rg;
};

// Row k of the diagonal block's solve, one lane a column: b holds the
// rows' sums, rotated (b[0] is row k's); l, d and r row k's shifted
// column, divisor and reciprocal. Row k + 1's are fetched into ln (and
// d, r) before row k's value is stored, so no shared load waits on a
// store. Only the first W = 31 - 8 q sums are still rows of the block
// from row 8 q on.
template <int W>
__device__ __forceinline__ void solve_step(float (&b)[TB],
                                           const float4 (&l)[8],
                                           float4 (&ln)[8], float& d,
                                           float& r, int k, const Solve& sv) {
    const int lane = threadIdx.x & 31;
    const int row = sv.j0 + k;
    float x = __fsub_rn(row == sv.col ? 1.f : 0.f, b[0]);
    if (!sv.unit) x = div_rn(x, d, r);
    if (row < sv.col) x = 0.f;
    const int kn = k + 1 < TB ? k + 1 : k;
#pragma unroll
    for (int q = 0; q < (W + 1) / 4; ++q)
        ln[q] = reinterpret_cast<const float4*>(sv.lsh + TB * kn)[q];
    d = sv.dg[kn];
    r = sv.rg[kn];
    sv.xt[lane * sv.ld + sv.K + k] = x;
#pragma unroll
    for (int q = 0; q < (W + 1) / 4; ++q) {
        const float lv[4] = {l[q].x, l[q].y, l[q].z, l[q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (4 * q + e < W) b[4 * q + e] = fmaf(lv[e], x, b[4 * q + e + 1]);
    }
}

// Rows [k, end) of the solve, two at a time (the entries alternate
// between l and ln: no register copies); end - k is even.
template <int W>
__device__ __forceinline__ void solve_run(float (&b)[TB], float4 (&l)[8],
                                          float& d, float& r, int& k,
                                          int end, const Solve& sv) {
    float4 ln[8];
#pragma unroll 1
    for (; k < end; k += 2) {
        solve_step<W>(b, l, ln, d, r, k, sv);
        solve_step<W>(b, ln, l, d, r, k + 1, sv);
    }
}

// Named barrier of the look-ahead's warps.
__device__ __forceinline__ void producers_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(PRODUCERS * 32) : "memory");
}

// Rows [j0, j0 + 32) of X from their transposed copy (rows past n and
// columns past n skipped), by `threads` threads from `first`.
__device__ __forceinline__ void store_rows(float* X, const float* xt, int n,
                                           int ld, int c0, int j0, int K,
                                           int first, int threads) {
    for (int e = first; e < TB * TB; e += threads) {
        const int r = e >> 5, c = e & 31;
        if (j0 + r < n && c0 + c < n)
            X[(long)(j0 + r) * n + c0 + c] = xt[c * ld + K + r];
    }
}

template <bool VEC>
__global__ void __launch_bounds__(BG_THREADS, 1)
trtri_lower_kernel(const float* __restrict__ L, float* __restrict__ X,
                   int n, int unit) {
    extern __shared__ __align__(16) float sm[];
    const int ld = tr_ld(n);
    float* band = sm;                   // 32 x ld: L's row band
    float* xt = band + TB * ld;         // 32 x ld: X^T, this block's columns
    float* red = xt + TB * ld;          // split-K partials, 8 warps
    float* lred = red + BG_RED_FLOATS;  // the look-ahead's partials
    float* pre = lred + PRODUCERS * 32 * BG_RED_LD;   // 2 x 32 x 33
    float* lsh = pre + 2 * TB * PT_LD;  // 32 x 32: shifted diagonal block
    float* dg = lsh + TB * TB;          // 32 divisors
    float* rg = dg + TB;                // their reciprocals
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int c0 = blockIdx.x * TB, col = c0 + lane;
    const int p = producer_index(warp);

    for (int e = tid; e < TB * PT_LD; e += BG_THREADS) pre[e] = 0.f;
    if (p >= 0) {
        load_band<VEC>(band, ld, L, n, c0, c0, TB, p);
        bg_commit();
        bg_wait<0>();
    }
    __syncthreads();
    for (int j0 = c0, par = 0; j0 < n; j0 += TB, par ^= 1) {
        const int K = j0 - c0;
        for (int e = tid; e < TB * TB; e += BG_THREADS) {
            const int k = e >> 5, r = k + 1 + (e & 31);
            lsh[e] = r < TB ? band[r * ld + K + k] : 0.f;
        }
        if (tid < TB) {
            const float d = band[tid * ld + K + tid];
            dg[tid] = d == 0.f ? 1.f : d;
            rg[tid] = rcp_rn(dg[tid]);
        }
        // the product's last 32 (the rows solved last), 4 a warp; the
        // rest of it is in pre (the look-ahead below)
        float acc[8][4] = {};
        if (K > 0)
            bg_mac<float>(acc, band, ld, xt, ld, K - TB + 4 * warp,
                          K - TB + 4 * warp + 4);
        bg_store_partial(acc, red);
        __syncthreads();
        if (warp == 0) {
            float b[TB];
#pragma unroll
            for (int i = 0; i < TB; ++i)
                b[i] = pre[par * TB * PT_LD + i * PT_LD + lane]
                    + bg_sum(red, i, lane);
            float4 l[8];
#pragma unroll
            for (int q = 0; q < 8; ++q)
                l[q] = reinterpret_cast<const float4*>(lsh)[q];
            float d = dg[0], r = rg[0];
            const Solve sv = {j0, K, col, ld, unit != 0, xt, lsh, dg, rg};
            int k = 0;
            solve_run<31>(b, l, d, r, k, 8, sv);
            solve_run<23>(b, l, d, r, k, 16, sv);
            solve_run<15>(b, l, d, r, k, 24, sv);
            solve_run<7>(b, l, d, r, k, 32, sv);
        } else if (p >= 0) {
            // look-ahead, under the solve: the previous block's rows of X
            // out, the next band in, and the next block's product over
            // the rows solved before this block
            if (K > 0)
                store_rows(X, xt, n, ld, c0, j0 - TB, K - TB,
                           p * 32 + lane, PRODUCERS * 32);
            if (j0 + TB < n) {
                load_band<VEC>(band, ld, L, n, j0 + TB, c0, K + 2 * TB, p);
                bg_commit();
                bg_wait<0>();
                producers_sync();
                const int u = K / 4;
                float lacc[8][4] = {};
                bg_mac<float>(lacc, band, ld, xt, ld, 4 * (p * u / PRODUCERS),
                              4 * ((p + 1) * u / PRODUCERS));
                bg_store_partial(lacc, lred, p);
                producers_sync();
                float* next = pre + (par ^ 1) * TB * PT_LD;
                for (int e = p * 32 + lane; e < TB * TB; e += PRODUCERS * 32)
                    next[(e >> 5) * PT_LD + (e & 31)] =
                        bg_sum(lred, e >> 5, e & 31, PRODUCERS);
            }
        }
        __syncthreads();
    }
    // the last block's rows
    store_rows(X, xt, n, ld, c0, c0 + ((n - c0 - 1) / TB) * TB,
               ((n - c0 - 1) / TB) * TB, tid, BG_THREADS);
}

template <bool VEC>
int launch(const float* L, float* X, int n, int unit, cudaStream_t stream) {
    const size_t smem = tr_smem_bytes(n);
    const cudaError_t e = cudaFuncSetAttribute(
        trtri_lower_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    trtri_lower_kernel<VEC><<<(n + TB - 1) / TB, BG_THREADS, smem, stream>>>(
        L, X, n, unit);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// X = inv(L) for the (n, n) row-major f32 lower triangle L, n <= 512;
// X must hold zeros (the entries above the diagonal blocks are not
// written).
int trtri_lower(const float* L, float* X, int n, int unit, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    if (n > TR_MAX_N) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return n % 4 == 0 ? launch<true>(L, X, n, unit, s)
                      : launch<false>(L, X, n, unit, s);
}

}  // extern "C"

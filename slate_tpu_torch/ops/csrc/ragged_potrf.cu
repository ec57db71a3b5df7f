// Ragged batched lower Cholesky: the device work of ops/kernels.py
// ragged_potrf.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_potrf_pallas (a grid
// over the batch, each element rebuilt as blkdiag(A[:s, :s], I) and
// factored by ceil(s/blk) left-looking stripes). The same stripes here,
// over the live block only: for k0 = 0, blk, ... < s, with cw =
// min(blk, s - k0),
//   S = A[k0:s, k0:k0+cw] - T(L[k0:s, :k0] L[k0:k0+cw, :k0]^T)
// (products summed in f32, the sum rounded to the storage type T, the
// subtract rounded to T), then the column recurrence inside the stripe:
// d = sqrt(s_jj) (d == 0 divides by 1), v = T(s_j / d) below the
// diagonal, s_jj = T(d), s_rc = T(s_rc - T(v_r v_c)) for the stripe's
// columns c > j. The live block comes back lower-triangular; the pad
// comes back as the identity (the reference's tril of the identity)
// and is never read, whatever the stacker left there. T is f32 or
// bf16; arithmetic is f32 with __fmul_rn/__fsub_rn/__fdiv_rn, so it
// rounds as the plain PyTorch version does.
//
// Bound on an H100: sum s^3/3 f32 operations over the batch (67
// TFLOP/s on CUDA cores), or the live bytes read and written, whichever
// is larger: 7 us for the serving stream's first flush (64 elements,
// orders 64-584). What holds a flush back is its largest element: the
// first version gave each element one block, so an order-1024 element
// was 358 MFLOP on one SM (>= 0.8 ms), its update a 64 x 64 tile
// walker masked half idle on the 32-wide stripe, and its column
// recurrence two block barriers a column.
//
// Design: a thread-block cluster of C blocks per element (C = 8 from a
// ceiling of 512 up), the clusters ordered by decreasing order so the
// largest elements start first. Each stripe's rows are cut into 32-row
// tiles: the diagonal tile goes to block k mod C alone, the next tile
// (the next stripe's diagonal block) to the next block alone, the rest
// round-robin to the others. Each stripe takes three steps:
//  1. every block computes S for its tiles: the split-K product of
//     band_gemm.cuh over K = k0, both operands (the tile's finished
//     rows and the stripe's finished rows of L) streamed from L2
//     through a ring of three 64-deep cp.async slabs, the tile's input
//     block with the first slab;
//  2. one warp factors the cw x cw diagonal block in registers, lane r
//     holding row r: the pivot by shuffle, the multipliers through
//     shared memory, where the columns are kept shifted (lsh[j][i] =
//     L[j + 1 + i][j]) beside the f32 divisors and their reciprocals
//     (~500 cycles a column on an H100, which no reordering of the loop
//     shortened). With blk = 32 this happens one stripe ahead:
//     the next stripe's owner factors it as soon as its own rows of this
//     stripe are solved, while the other blocks finish the stripe and
//     start the next one's products. A cluster barrier, then every block
//     copies those 4.3 KB from the factoring block's shared memory
//     (distributed shared memory);
//  3. every block solves its rows below the diagonal block, one thread
//     a row: for c ascending, v_rc = T(s_rc / d_c), then
//     s_rj = T(s_rj - T(v_rc L_jc)) for j > c. This applies to every
//     entry the operations of the column recurrence in its order, so
//     the factor's recurrence is bitwise the plain version's; only the
//     product's summation order differs. The divide goes through the
//     reciprocal (band_gemm.cuh div_rn, exact), the next column's
//     entries are fetched before this column's value is stored, and the
//     loop runs two columns a turn so the fetched entries need no
//     copies. The tiles go out to the factor with coalesced stores, then
//     a cluster barrier (release / acquire) publishes them.
// Loops over a stripe's columns stay rolled: the row rotates down one
// register a column, and from column 8 q on only the 31 - 8 q entries
// still in the stripe are updated. bf16 rows are held as packed pairs
// and updated by mul.rn / sub.rn on bf16x2 (each rounds once, as the
// f32 product and difference rounded to bf16 do; explicit PTX, which is
// never contracted into an FMA). The pad rows and the zeros above each
// row's stripe are written by rows, split over the cluster (no division
// an entry); neither is read.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "band_gemm.cuh"
#include "ragged.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slate_torch;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TR = 32;                // rows of a tile
constexpr int SLD = TR + 1;           // padded row of a tile's stripe
constexpr int KS = 64;                // depth of a product slab
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 8;
// batches up to this size are ordered by decreasing order
constexpr int ORDER_MAX = 1024;

// row pitch (elements) of a slab: 4 words mod 32 (band_gemm.cuh)
template <typename T>
__host__ __device__ constexpr int slab_ld() { return KS + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr int ring_floats() {
    const int ring = STAGES * 2 * TR * slab_ld<T>() * (int)sizeof(T) / 4;
    return ring > BG_RED_FLOATS ? ring : BG_RED_FLOATS;
}

// Slab t (k in [t KS, t KS + KS), below ke) of the tile's rows r0 ...
// (A, rows < s) and of the rows b0 ... (B, the first nb) of L.
template <typename T>
__device__ __forceinline__ void load_slab(T* st, const T* o, int n, int s,
                                          int b0, int nb, int r0, int ke,
                                          int t) {
    constexpr int EPC = 16 / (int)sizeof(T);       // elements a chunk
    constexpr int CPR = KS / EPC;                  // chunks a slab row
    constexpr int LDR = slab_ld<T>();
    for (int e = threadIdx.x; e < 2 * TR * CPR; e += BG_THREADS) {
        const int opnd = e / (TR * CPR), r = (e / CPR) % TR, q = e % CPR;
        const int kk = t * KS + q * EPC;
        const int row = opnd ? b0 + r : r0 + r;
        const bool in = (opnd ? r < nb : row < s) && kk < ke;
        bg_cp16(st + (opnd * TR + r) * LDR + q * EPC,
                in ? o + (long)row * n + kk : o, in ? 16 : 0);
    }
}

// The split-K product L[r0:r0+32, :ke] L[b0:b0+nb, :ke]^T (rows past s
// zero) by the block's eight warps, through the slab ring; on return the
// warps' partials are in `ring` (bg_sum) and the slabs are free.
template <typename T>
__device__ void stripe_product(const T* o, int n, int s, int b0, int nb,
                               int r0, int ke, float* ring) {
    constexpr int LDR = slab_ld<T>();
    constexpr int STAGE = 2 * TR * LDR;
    const int warp = threadIdx.x >> 5;
    T* slabs = reinterpret_cast<T*>(ring);
    const int ns = (ke + KS - 1) / KS;
    float acc[8][4] = {};
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < ns)
            load_slab<T>(slabs + t * STAGE, o, n, s, b0, nb, r0, ke, t);
        bg_commit();
    }
    for (int t = 0; t < ns; ++t) {
        bg_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = t + STAGES - 1;
        if (nxt < ns)
            load_slab<T>(slabs + (nxt % STAGES) * STAGE, o, n, s, b0, nb, r0,
                         ke, nxt);
        bg_commit();
        const T* st = slabs + (t % STAGES) * STAGE;
        bg_mac<T>(acc, st, LDR, st + TR * LDR, LDR, warp * (KS / BG_WARPS),
                  (warp + 1) * (KS / BG_WARPS));
    }
    bg_wait<0>();
    __syncthreads();
    bg_store_partial(acc, ring);
    __syncthreads();
}

// The tile's input block A[r0:r0+32, k0:k0+cw] into ain (32 x 32, zero
// past s and cw; the pad is never read).
template <typename T>
__device__ __forceinline__ void load_input(T* ain, const T* a, int n, int s,
                                           int k0, int cw, int r0) {
    constexpr int EPC = 16 / (int)sizeof(T);
    constexpr int CPR = TR / EPC;
    for (int e = threadIdx.x; e < TR * CPR; e += BG_THREADS) {
        const int r = e / CPR, c = (e % CPR) * EPC, row = r0 + r;
        const int live = row < s ? max(0, min(EPC, cw - c)) : 0;
        bg_cp16(ain + r * TR + c, live ? a + (long)row * n + k0 + c : a,
                live * (int)sizeof(T));
    }
}

// Step 1 for the tile of rows r0 ...: S[r][c] = T(A - T(P)) for the
// live entries (c < cw, r0 + r < s), zero elsewhere, P = L[r0:, :k0]
// L[k0:k0+cw, :k0]^T. The input block comes in with the first slab.
// The block's threads all call it; on return the ring and ain may be
// reused.
template <typename T>
__device__ void stripe_update(float* S, const T* a, const T* o, int n,
                              int s, int k0, int cw, int r0, float* ring,
                              T* ain) {
    const int tid = threadIdx.x;
    load_input<T>(ain, a, n, s, k0, cw, r0);
    if (k0 == 0) {
        bg_commit();
        bg_wait<0>();
        __syncthreads();
        for (int e = tid; e < TR * TR; e += BG_THREADS)
            S[(e >> 5) * SLD + (e & 31)] = to_f(ain[e]);
        __syncthreads();
        return;
    }
    stripe_product<T>(o, n, s, k0, cw, r0, k0, ring);
    for (int e = tid; e < TR * TR; e += BG_THREADS) {
        const int r = e >> 5, c = e & 31;
        S[r * SLD + c] = r0 + r < s && c < cw
            ? rnd<T>(__fsub_rn(to_f(ain[e]), rnd<T>(bg_sum(ring, r, c))))
            : 0.f;
    }
    __syncthreads();
}

// bf16x2 multiply and subtract, each rounded once (explicit .rn: never
// contracted into an FMA)
__device__ __forceinline__ uint32_t mul_bf2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t sub_bf2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

// A row of a stripe, held by one thread and rotated: entry 0 is the
// next column. apply<W>(v, l) takes one column of the recurrence,
// t[i] <- T(t[i + 1] - T(v l[i])) for i < W, l the column's shifted
// entries (fetched by fetch<W>); from column 8 q on only the first
// W = 31 - 8 q entries still lie in the stripe.
template <typename T>
struct Row;

template <>
struct Row<float> {
    using L = float4;
    static constexpr int NL = TR / 4;
    float t[TR];
    __device__ __forceinline__ void load(const float* s) {
#pragma unroll
        for (int i = 0; i < TR; ++i) t[i] = s[i];
    }
    __device__ __forceinline__ float head() const { return t[0]; }
    template <int W>
    __device__ __forceinline__ static void fetch(L (&l)[NL], const float* c) {
#pragma unroll
        for (int q = 0; q < (W + 1) / 4; ++q)
            l[q] = reinterpret_cast<const float4*>(c)[q];
    }
    template <int W>
    __device__ __forceinline__ void apply(float v, const L (&l)[NL]) {
#pragma unroll
        for (int q = 0; q < (W + 1) / 4; ++q) {
            const float lv[4] = {l[q].x, l[q].y, l[q].z, l[q].w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (4 * q + e < W)
                    t[4 * q + e] =
                        __fsub_rn(t[4 * q + e + 1], __fmul_rn(v, lv[e]));
        }
    }
};

// bf16: the row in 16 packed pairs, the update by mul.rn / sub.rn on
// bf16x2, which round once, as T(v l) and T(s - p) do: the product of
// two bf16 values is exact in f32, and the difference of two is exact in
// f32 or, when their exponents lie 16 or more apart, rounds to the
// larger in both.
template <>
struct Row<__nv_bfloat16> {
    using L = uint4;
    static constexpr int NL = TR / 8;
    uint32_t p[TR / 2];
    __device__ __forceinline__ void load(const float* s) {
#pragma unroll
        for (int m = 0; m < TR / 2; ++m) p[m] = pack_bf2(s[2 * m], s[2 * m + 1]);
    }
    __device__ __forceinline__ float head() const {
        return __uint_as_float(p[0] << 16);
    }
    template <int W>
    __device__ __forceinline__ static void fetch(L (&l)[NL],
                                                 const __nv_bfloat16* c) {
#pragma unroll
        for (int q = 0; q < (W + 1) / 8; ++q)
            l[q] = reinterpret_cast<const uint4*>(c)[q];
    }
    template <int W>
    __device__ __forceinline__ void apply(float v, const L (&l)[NL]) {
        const uint32_t v2 = pack_bf2(v, v);
#pragma unroll
        for (int m = 0; m < (W + 1) / 2; ++m) {
            const uint4 q = l[m / 4];
            const uint32_t lw = m % 4 == 0 ? q.x : m % 4 == 1 ? q.y
                : m % 4 == 2 ? q.z : q.w;
            const uint32_t next = m + 1 < TR / 2 ? p[m + 1] : 0u;
            p[m] = sub_bf2(__byte_perm(p[m], next, 0x5432), mul_bf2(v2, lw));
        }
    }
};

// Step 2, by one warp: the cw x cw diagonal block (rows 0 .. cw - 1 of
// the tile S) factored in place, lane r holding row r; its columns below
// the diagonal go to lsh (zeroed by the caller) shifted, its f32
// divisors to dg.
template <typename T>
__device__ void factor_diagonal(float* S, T* lsh, float* dg, int cw) {
    const int lane = threadIdx.x & 31;
    Row<T> row;
    row.load(S + lane * SLD);
#pragma unroll 1
    for (int j = 0; j < cw; ++j) {
        const float h = row.head();
        const float d = __fsqrt_rn(__shfl_sync(FULL, h, j));
        const float ds = d == 0.f ? 1.f : d;
        const float v = lane == j ? rnd<T>(d)
            : lane > j ? rnd<T>(__fdiv_rn(h, ds)) : 0.f;
        if (lane < cw) {
            S[lane * SLD + j] = v;
            if (lane > j) lsh[j * TR + lane - j - 1] = from_f<T>(v);
        }
        if (lane == 0) dg[j] = ds;
        __syncwarp();
        typename Row<T>::L l[Row<T>::NL];
        Row<T>::template fetch<TR - 1>(l, lsh + j * TR);
        row.template apply<TR - 1>(v, l);
    }
}

// One column j of step 3: the row's value, then the next column's
// entries (ln) and divisor fetched before that value is stored, so no
// shared load waits on the store; then the update with this column's
// entries (l).
template <typename T, int W>
__device__ __forceinline__ void solve_step(Row<T>& row,
                                           const typename Row<T>::L (&l)[Row<T>::NL],
                                           typename Row<T>::L (&ln)[Row<T>::NL],
                                           float& d, float& r, float* srow,
                                           const T* lsh, const float* dg,
                                           const float* rg, int j) {
    const float v = rnd<T>(div_rn(row.head(), d, r));
    const int jn = j + 1 < TR ? j + 1 : j;
    Row<T>::template fetch<W>(ln, lsh + jn * TR);
    d = dg[jn];
    r = rg[jn];
    srow[j] = v;
    row.template apply<W>(v, l);
}

// Step 3, columns [j, end) of one row, two at a time (the entries
// alternate between l and ln: no register copies).
template <typename T, int W>
__device__ __forceinline__ void solve_run(Row<T>& row,
                                          typename Row<T>::L (&l)[Row<T>::NL],
                                          float& d, float& r, float* srow,
                                          const T* lsh, const float* dg,
                                          const float* rg, int& j, int end) {
    typename Row<T>::L ln[Row<T>::NL];
#pragma unroll 1
    for (; j + 1 < end; j += 2) {
        solve_step<T, W>(row, l, ln, d, r, srow, lsh, dg, rg, j);
        solve_step<T, W>(row, ln, l, d, r, srow, lsh, dg, rg, j + 1);
    }
    if (j < end) {
        solve_step<T, W>(row, l, ln, d, r, srow, lsh, dg, rg, j);
#pragma unroll
        for (int q = 0; q < Row<T>::NL; ++q) l[q] = ln[q];
        ++j;
    }
}

// Step 3 for one row (srow, its stripe's 32 entries), in place.
template <typename T>
__device__ void solve_row(float* srow, const T* lsh, const float* dg,
                          const float* rg, int cw) {
    Row<T> row;
    row.load(srow);
    typename Row<T>::L l[Row<T>::NL];
    Row<T>::template fetch<31>(l, lsh);
    float d = dg[0], r = rg[0];
    int j = 0;
    solve_run<T, 31>(row, l, d, r, srow, lsh, dg, rg, j, min(cw, 8));
    solve_run<T, 23>(row, l, d, r, srow, lsh, dg, rg, j, min(cw, 16));
    solve_run<T, 15>(row, l, d, r, srow, lsh, dg, rg, j, min(cw, 24));
    solve_run<T, 7>(row, l, d, r, srow, lsh, dg, rg, j, cw);
}

// Step 2 by the block that owns the diagonal tile S (updated): lsh
// zeroed, the factor, then the divisors' reciprocals for step 3.
template <typename T>
__device__ void factor_tile(float* S, T* lsh, float* dg, float* rg, int cw) {
    for (int e = threadIdx.x; e < TR * TR; e += BG_THREADS)
        lsh[e] = from_f<T>(0.f);
    __syncthreads();
    if (threadIdx.x < 32) factor_diagonal<T>(S, lsh, dg, cw);
    __syncthreads();
    if (threadIdx.x < TR) rg[threadIdx.x] = rcp_rn(dg[threadIdx.x]);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The tiles of a stripe (ntiles of them) a block owns: the owner (block
// k mod C) takes the diagonal tile 0 alone; with look-ahead the next
// stripe's owner takes tile 1 alone (its rows are that stripe's
// diagonal block); the other blocks deal the rest round-robin.
struct Deal {
    int first, step;
    __device__ Deal(int rank, int C, int k, int ntiles, bool ahead) {
        const int owner = k % C, rel = (rank - owner + C) % C;
        if (C == 1) { first = 0; step = 1; }
        else if (rel == 0) { first = 0; step = ntiles; }
        else if (ahead && rel == 1) { first = 1; step = ntiles; }
        else { first = rel; step = C - (ahead ? 2 : 1); }
    }
};

template <typename T>
__global__ void __launch_bounds__(BG_THREADS, 2)
ragged_potrf_kernel(const T* a_all, T* o_all, const int* sizes, int batch,
                    int n, int blk) {
    extern __shared__ __align__(16) float sm[];
    __shared__ int elem;
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    float* ring = sm;                        // slabs, then the partials
    // 32 x 32 shifted columns (in T), their 32 divisors and reciprocals
    // (f32): what the other blocks copy from the factoring block
    T* lsh = reinterpret_cast<T*>(ring + ring_floats<T>());
    float* dg = ring + ring_floats<T>() + TR * TR;
    float* rg = dg + TR;
    T* ain = reinterpret_cast<T*>(rg + TR);  // a tile's input block
    float* sbuf = rg + TR + TR * TR;         // this block's tiles' stripes
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cid = blockIdx.x / C;

    // this cluster's element: the cid-th largest order (ties by index)
    if (tid == 0) elem = cid;
    __syncthreads();
    if (batch <= ORDER_MAX) {
        for (int e = tid; e < batch; e += BG_THREADS) {
            const int se = ragged_order(sizes, e, n);
            int rk = 0;
            for (int j = 0; j < batch; ++j) {
                const int sj = ragged_order(sizes, j, n);
                rk += sj > se || (sj == se && j < e);
            }
            if (rk == cid) elem = e;
        }
        __syncthreads();
    }
    const long off = (long)elem * n * n;
    const T* a = a_all + off;
    T* o = o_all + off;
    const int s = ragged_order(sizes, elem, n);

    // the pad (identity rows below s, zeros right of s) and the zeros
    // right of each live row's stripe: one warp a row
    for (int r = rank + C * warp; r < n; r += C * BG_WARPS) {
        T* row = o + (long)r * n;
        if (r < s) {
            const int c1 = min(s, (r / blk + 1) * blk);
            for (int c = c1 + lane; c < n; c += 32) row[c] = from_f<T>(0.f);
        } else {
            for (int c = lane; c < n; c += 32)
                row[c] = from_f<T>(c == r ? 1.f : 0.f);
        }
    }

    // look-ahead: the next stripe's diagonal block (the rows of this
    // stripe's tile 1) is factored by its owner while the other blocks
    // solve their rows and update the next stripe's tiles
    const bool ahead = blk == TR && C >= 3;
    for (int k = 0, k0 = 0; k0 < s; ++k, k0 += blk) {
        const int cw = min(blk, s - k0);
        const int ntiles = (s - k0 + TR - 1) / TR;
        const int owner = k % C;
        const Deal deal(rank, C, k, ntiles, ahead);
        int nown = 0;
        for (int i = deal.first; i < ntiles; i += deal.step, ++nown)
            if (i > 0 || !ahead || k == 0)
                stripe_update<T>(sbuf + nown * TR * SLD, a, o, n, s, k0, cw,
                                 k0 + TR * i, ring, ain);
        __syncthreads();
        if (rank == owner && (!ahead || k == 0))
            factor_tile<T>(sbuf, lsh, dg, rg, cw);
        cluster_arrive();
        cluster_wait();
        if (rank != owner) {
            float* mine = ring + ring_floats<T>();
            const float* src = cluster.map_shared_rank(mine, owner);
            for (int e = tid; e < TR * TR + 2 * TR; e += BG_THREADS)
                mine[e] = src[e];
        }
        __syncthreads();
        for (int e = tid; e < nown * TR; e += BG_THREADS) {
            const int m = e >> 5, row = k0 + TR * (deal.first + m * deal.step)
                + (e & 31);
            if (row >= k0 + cw && row < s)
                solve_row<T>(sbuf + m * TR * SLD + (e & 31) * SLD, lsh, dg,
                             rg, cw);
        }
        __syncthreads();
        for (int m = 0; m < nown; ++m) {
            const int r0 = k0 + TR * (deal.first + m * deal.step);
            const float* S = sbuf + m * TR * SLD;
            for (int e = tid; e < TR * TR; e += BG_THREADS) {
                const int r = e >> 5, c = e & 31;
                if (r0 + r < s && c < cw)
                    o[(long)(r0 + r) * n + k0 + c] = from_f<T>(S[r * SLD + c]);
            }
        }
        if (ahead && (rank - owner + C) % C == 1 && k0 + blk < s) {
            // this block owns the next stripe's diagonal tile: its rows
            // are final up to column k0 + blk once its own stores land
            __threadfence();
            __syncthreads();
            cluster_arrive();
            const int k1 = k0 + blk, cw1 = min(blk, s - k1);
            stripe_update<T>(sbuf, a, o, n, s, k1, cw1, k1, ring, ain);
            factor_tile<T>(sbuf, lsh, dg, rg, cw1);
            cluster_wait();
        } else {
            cluster_arrive();
            cluster_wait();
        }
    }
}

template <typename T>
int launch(const void* a, void* o, const int* sizes, int batch, int n,
           int blk, cudaStream_t stream) {
    if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
    if (blk < 8 || blk > RG_MAX_BLK || blk % 8 || n % 8)
        return (int)cudaErrorInvalidValue;
    int C = (n + 63) / 64;
    C = C < MAX_CLUSTER ? C : MAX_CLUSTER;
    // the most tiles a block is dealt (Deal)
    const int tiles = (n + TR - 1) / TR;
    const int skip = blk == TR && C >= 3 ? 2 : 1;
    const int mt = C == 1 ? tiles
        : tiles <= skip ? 1 : (tiles - skip + C - skip - 1) / (C - skip);
    const size_t smem =
        sizeof(float) * ((size_t)ring_floats<T>() + 2 * TR * TR + 2 * TR
                         + (size_t)mt * TR * SLD);
    cudaError_t e = cudaFuncSetAttribute(
        ragged_potrf_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * C);
    cfg.blockDim = dim3(BG_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, ragged_potrf_kernel<T>, (const T*)a, (T*)o,
                           sizes, batch, n, blk);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The (batch, n, n) row-major stack `a` (f32, or bf16 with bf16 != 0)
// factored into `o` (which may be `a`) with per-element orders
// `sizes` (int32, device), stripes of `blk` columns (8 <= blk <= 32,
// blk % 8 == 0, n % 8 == 0), on `stream`. Returns a cudaError_t.
int ragged_potrf(const void* a, void* o, const int* sizes, int batch, int n,
                 int blk, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(a, o, sizes, batch, n, blk, s)
                : launch<float>(a, o, sizes, batch, n, blk, s);
}

}  // extern "C"

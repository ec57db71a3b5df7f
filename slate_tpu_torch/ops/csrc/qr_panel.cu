// Householder QR of an (m, w) panel: the device work of ops/kernels.py
// qr_panel.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_qr_panel_pallas (the
// reference's bf16 QR panel route: XLA's native geqrf, like cuSOLVER's,
// takes no bf16). Per column j, with x the column in f32, zeroed above
// row j:
//   alpha = x_j, nrm = sqrt(sum x^2), beta = -sign(alpha) nrm (sign +1
//   for alpha >= 0); a zero column (sum x^2 <= 0) gives tau = 0 and
//   beta -> 1 in the divides; tau = (beta - alpha) / beta;
//   v = x / (alpha - beta) below j, v_j = 1 (a zero denominator -> 1),
//   kept in f32;
//   vta_c = sum_r v_r f32(a_rc) over the current panel;
//   a_rc = T(a_rc - T((tau v_r) vta_c)) for every column c > j;
//   column j becomes T(v) below the diagonal and T(beta) on it.
// taus come back in f32 (the wrapper casts them to the panel type).
// Panel types f32 and bf16 (the `bf16` argument). The scalars and the
// update use __fmul_rn/__fsub_rn/__fdiv_rn (v by band_gemm.cuh div_rn,
// the same correctly rounded quotient), so none of them contracts into
// an FMA and each rounds where the plain PyTorch version rounds; the
// sums (of squares, and of products) are accumulated with fmaf, in
// another order than the plain version's.
//
// Bound on an H100: 2 m w^2 - 2 w^3 / 3 FLOPs (at 8192 x 128 4.0 us at
// the f32 rate; the panel read and written once, 8 MB in f32, 2.5 us),
// or the latency of w columns in sequence, each needing a reduction
// over every SM that holds rows: w exchanges between SMs, ~0.07 ms at
// w = 128 (a round trip through L2 that finds its data ready, ~1.1k
// cycles). The first version took three grid barriers a column (an
// atomic counter spun on by every block, ~2.5 us each: ~0.95 ms at
// 4096 x 128, flat in m).
//
// Design: ONE exchange a column and no barrier.
//  - v^T A is taken from the sums the column's norm needs: with
//    S_c = sum_{r > j} x_r a_rc, vta_c = a_jc + S_c / (alpha - beta)
//    (v_j = 1, v_r = x_r / (alpha - beta)), so each block posts, for
//    column j, its partial sum of squares and its partial S_c for every
//    c > j in one vector, and the owner of row j posts row j: the
//    scalars and v^T A follow in every block from the same words (the
//    update keeps the reference's per-column rounding; only these sums
//    round otherwise, as any other order of summation would);
//  - the words are 64-bit, the column's epoch (j + 1) in the high half
//    beside the f32 payload, so a reader polls each word until its epoch
//    appears and needs no fence or counter; the slots alternate by
//    column parity (a block posts column j + 2's only after it has read
//    every block's column j + 1, posted after that block had read column
//    j's), and the wrapper zeroes them once a call;
//  - every block sums the partials in one fixed order (a thread per
//    column and group of at most 8 blocks, the groups' sums then in
//    order; the sums of squares two a lane, then a shuffle tree), so
//    all blocks hold bitwise the same scalars and v^T A;
//  - blocks of 512 threads, one for every 32 rows (at most 64: the
//    wrapper's qr_panel_blocks; 64 blocks of 128 rows at 8192 rows, 8
//    of 32 at 256), each keeping its rows in shared memory (f32, rows
//    padded by one word) for the whole call;
//  - per column: the exchange, during which one warp polls the sums of
//    squares and alpha (posted first) and takes the scalars (a square
//    root and two divides, ~1.2k cycles on one thread) while the other
//    warps gather S_c and row j; a block barrier; a thread a row writes
//    column j and updates column j + 1 (so the update of the other
//    columns reads tau v and a_r,j+1 as one float2 a row), whose sum of
//    squares (a block reduction) and alpha are posted at once; then the
//    update of the other columns, a thread per column and group of
//    rows, which accumulates the next column's S_c as it goes, 8 rows'
//    loads before their stores, and posts them after a block barrier.
// clock64 marks (H100, a column, block 0): ~2.4-2.9k cycles in the
// exchange (about two L2 round trips and the slowest block; the
// scalars, ~1.2k on one thread, now inside it), ~0.9-1.2k for the row
// pass, ~0.4k for its block reduction, 1.7-3.1k for the update (32-128
// rows a block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "band_gemm.cuh"
#include "coop.cuh"

namespace {

using slate_torch::div_rn;
using slate_torch::from_f;
using slate_torch::rcp_rn;
using slate_torch::rnd;
using slate_torch::to_f;

typedef unsigned long long u64;

constexpr int QR_THREADS = 512;
constexpr int QR_MAX_W = 256;          // a thread a column, and more
constexpr int QR_MAX_BLOCKS = 64;      // two sums of squares a lane
constexpr int QR_BATCH = 16;           // words a thread polls at once
constexpr int QR_ROWS = 8;             // rows a turn of the update
// most groups a column's sums are split into (of blocks in the
// exchange, of rows in the update): their partial sums are added in
// order, on the chain
constexpr int QR_MAX_GROUPS = 8;
// polls of one word before a block gives up with a trap (seconds: a
// word that never comes is a fault, and the card is not left spinning)
constexpr unsigned int QR_MAX_POLLS = 1u << 24;

__device__ __forceinline__ void post(u64* p, unsigned int epoch, float v) {
    const u64 word = ((u64)epoch << 32) | __float_as_uint(v);
    asm volatile("st.volatile.global.u64 [%0], %1;\n" :: "l"(p), "l"(word)
                 : "memory");
}

__device__ __forceinline__ u64 peek(const u64* p) {
    u64 word;
    asm volatile("ld.volatile.global.u64 %0, [%1];\n" : "=l"(word)
                 : "l"(p) : "memory");
    return word;
}

// Sum of v over the block's threads, in a fixed order; every thread
// gets the result. `red` holds QR_THREADS / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    __syncthreads();                 // red may still be read
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int i = 0; i < QR_THREADS / 32; ++i) s += red[i];
    return s;
}

// The payload of the word at p once it carries `epoch`.
__device__ __forceinline__ float poll_one(const u64* p, unsigned int epoch) {
    for (unsigned int polls = 0;; ++polls) {
        const u64 word = peek(p);
        if ((unsigned int)(word >> 32) == epoch)
            return __uint_as_float((unsigned int)word);
        if (polls == QR_MAX_POLLS) __trap();
    }
}

// The sum over blocks [i0, i1) of the words at slot[i * w] for `epoch`,
// in block order, and (with `extra`) the word at extra into *extra_v:
// polled in batches of QR_BATCH loads in flight, every load issued
// before the first is looked at, so the round trips overlap.
__device__ __forceinline__ float gather(const u64* slot, int w, int i0,
                                        int i1, unsigned int epoch,
                                        const u64* extra, float* extra_v) {
    float s = 0.f;
    for (int ib = i0; ib < i1 || extra; ib += QR_BATCH) {
        const int cnt = max(0, min(QR_BATCH, i1 - ib));
        const unsigned int all = (1u << cnt) - 1u;
        u64 word[QR_BATCH], xw = 0;
        unsigned int got = 0;
        bool xgot = extra == nullptr;
        for (unsigned int polls = 0; got != all || !xgot; ++polls) {
            if (polls == QR_MAX_POLLS) __trap();
#pragma unroll
            for (int q = 0; q < QR_BATCH; ++q)
                if (q < cnt && !(got >> q & 1u))
                    word[q] = peek(slot + (size_t)(ib + q) * w);
            if (!xgot) xw = peek(extra);
#pragma unroll
            for (int q = 0; q < QR_BATCH; ++q)
                if (q < cnt && (unsigned int)(word[q] >> 32) == epoch)
                    got |= 1u << q;
            if (!xgot && (unsigned int)(xw >> 32) == epoch) {
                *extra_v = __uint_as_float((unsigned int)xw);
                xgot = true;
            }
        }
        extra = nullptr;
#pragma unroll
        for (int q = 0; q < QR_BATCH; ++q)
            if (q < cnt)
                s = __fadd_rn(s, __uint_as_float((unsigned int)word[q]));
    }
    return s;
}

// The column's scalars from its reduced sum of squares and alpha:
// (tau, beta, the denominator of v).
__device__ __forceinline__ void scalars(float nrm2, float alpha, float& t,
                                        float& beta, float& denom) {
    const float nrm = sqrtf(nrm2);
    beta = alpha >= 0.f ? -nrm : nrm;
    const bool degenerate = nrm2 <= 0.f;
    const float safe_beta = degenerate ? 1.f : beta;
    t = degenerate ? 0.f : __fdiv_rn(__fsub_rn(beta, alpha), safe_beta);
    const float d = __fsub_rn(alpha, safe_beta);
    denom = d == 0.f ? 1.f : d;
}

// Entry i of the column's reduced vector: the groups' sums in order.
__device__ __forceinline__ float reduced(const float* red, int ng, int nc,
                                        int i) {
    float v[QR_MAX_GROUPS];
#pragma unroll
    for (int g = 0; g < QR_MAX_GROUPS; ++g)
        v[g] = g < ng ? red[g * nc + i] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < QR_MAX_GROUPS; ++g)
        if (g < ng) s = __fadd_rn(s, v[g]);
    return s;
}

// Groups of a column's sums over `n` columns, on `threads` threads: as
// many as those allow, at most QR_MAX_GROUPS and `cap`.
__device__ __forceinline__ int groups(int n, int cap, int threads) {
    return max(1, min(min(cap, QR_MAX_GROUPS), threads / max(n, 1)));
}

// The warp that takes the column's scalars while the others gather its
// vector, and the threads left to those.
constexpr int QR_SCALAR_WARP = QR_THREADS / 32 - 1;
constexpr int QR_GATHER_THREADS = QR_THREADS - 32;

// The update of the columns c > jn over the block's rows >= j with the
// step's tau v (tx[.].x) and v^T A (from the reduced vector `red` of
// column j's columns c > j: ng groups of nc entries, row j, denom and
// its reciprocal), then this block's S_c = sum_{r > jn} a_r,jn a_rc
// (a_r,jn in tx[.].y, zero for r <= jn) for those columns, posted for
// column jn; the owner of row jn posts the row's entries c > jn. (UPD
// false: no update, column 0's sums.)
template <typename T, bool UPD>
__device__ void post_partials(float* seg, int ld, const float2* tx,
                              const float* red, int ng, int nc,
                              const float* rowj, float denom, float rden,
                              float* red2, int j, int jn, int w, int lo,
                              int hi, u64* part, u64* rslot) {
    const int tid = threadIdx.x;
    const int ne = w - jn - 1;
    if (ne <= 0) return;
    const unsigned int ep = (unsigned int)jn + 1u;
    const int ng2 = groups(ne, QR_MAX_GROUPS, QR_THREADS);
    const int g = tid / ne, c = jn + 1 + tid - g * ne;
    if (g < ng2) {
        float s = 0.f;
        const float vc = UPD ? __fadd_rn(rowj[c], div_rn(
            reduced(red, ng, nc, c - j - 1), denom, rden)) : 0.f;
        // QR_ROWS rows a turn, every load before the first store (a
        // store to seg would otherwise hold back the next row's loads,
        // which the compiler cannot prove apart from it)
        for (int r0 = max(j, lo) + g; r0 < hi; r0 += QR_ROWS * ng2) {
            float x[QR_ROWS];
            float2 p[QR_ROWS];
#pragma unroll
            for (int k = 0; k < QR_ROWS; ++k) {
                const int r = r0 + k * ng2;
                const bool in = r < hi;
                x[k] = in ? seg[(r - lo) * ld + c] : 0.f;
                p[k] = in ? tx[r - lo] : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int k = 0; k < QR_ROWS; ++k) {
                const int r = r0 + k * ng2;
                if (UPD && r < hi) {
                    x[k] = rnd<T>(__fsub_rn(
                        x[k], rnd<T>(__fmul_rn(p[k].x, vc))));
                    seg[(r - lo) * ld + c] = x[k];
                }
                s = fmaf(p[k].y, x[k], s);
            }
        }
        red2[tid] = s;
    }
    __syncthreads();
    const int b = blockIdx.x;
    if (tid < ne)
        post(part + (size_t)b * w + jn + 1 + tid, ep,
             reduced(red2, ng2, ne, tid));
    else if (jn >= lo && jn < hi && tid - ne < ne)
        post(rslot + jn + 1 + tid - ne,
             ep, seg[(jn - lo) * ld + jn + 1 + tid - ne]);
}

// Warp QR_SCALAR_WARP: column j's sum of squares (G <= 64 words, summed
// in one fixed order) and alpha, polled, then its scalars into s_sc:
// tau, beta, denom, 1 / denom; block 0 writes tau.
__device__ __forceinline__ void column_scalars(const u64* ss_words, int w,
                                               int G, const u64* alpha_word,
                                               unsigned int ep, float* s_sc,
                                               float* tau_j) {
    const int lane = threadIdx.x & 31;
    const float s = gather(ss_words + (size_t)lane * w, 32 * w,
                           0, lane < G ? (lane + 32 < G ? 2 : 1) : 0, ep,
                           nullptr, nullptr);
    float nrm2 = s;
    for (int off = 16; off > 0; off >>= 1)
        nrm2 = __fadd_rn(nrm2, __shfl_down_sync(0xffffffffu, nrm2, off));
    if (lane == 0) {
        float t, beta, denom;
        scalars(nrm2, poll_one(alpha_word, ep), t, beta, denom);
        s_sc[0] = t;
        s_sc[1] = beta;
        s_sc[2] = denom;
        s_sc[3] = rcp_rn(denom);
        if (tau_j) *tau_j = t;
    }
}

template <typename T>
__global__ void __launch_bounds__(QR_THREADS, 1)
qr_panel_kernel(T* a, float* tau, int m, int w, int rpb, u64* scratch) {
    extern __shared__ float smem[];
    __shared__ float s_red[QR_THREADS / 32];
    __shared__ float s_sc[4];
    const int tid = threadIdx.x, warp = tid >> 5;
    const int G = gridDim.x, b = blockIdx.x;
    const int ld = w + 1;
    const int lo = b * rpb, hi = min(m, lo + rpb);
    const int nr = max(0, hi - lo);
    float2* tx = reinterpret_cast<float2*>(smem);   // rpb: tau v_r, a_r,j+1
    float* seg = smem + 2 * rpb;                    // nr x ld
    float* rowj = seg + (size_t)rpb * ld;           // w: row j
    float* red = rowj + w;                          // QR_THREADS
    float* red2 = red + QR_THREADS;                 // QR_THREADS
    // per column parity: G partial vectors of w words (entry j: the sum
    // of squares, c > j: S_c), then row j
    const size_t par_words = (size_t)(G + 1) * w;

    for (int e = tid; e < nr * w; e += QR_THREADS) {
        const int r = e / w, c = e - r * w;
        seg[r * ld + c] = to_f(a[(long)lo * w + e]);
    }
    __syncthreads();
    {
        float ss = 0.f;
        for (int r = lo + tid; r < hi; r += QR_THREADS) {
            const float x = seg[(r - lo) * ld];
            ss = fmaf(x, x, ss);
            tx[r - lo] = make_float2(0.f, r > 0 ? x : 0.f);
            if (r == 0) post(scratch + (size_t)G * w, 1u, x);
        }
        ss = block_sum(ss, s_red);
        if (tid == 0) post(scratch + (size_t)b * w, 1u, ss);
    }
    post_partials<T, false>(seg, ld, tx, red, 1, w, rowj, 1.f, 1.f, red2,
                            0, 0, w, lo, hi, scratch,
                            scratch + (size_t)G * w);

    for (int j = 0; j < w; ++j) {
        const unsigned int ep = (unsigned int)j + 1u;
        const u64* pj = scratch + (j & 1) * par_words;
        // (1) the exchange: one warp polls the sums of squares and alpha
        // (posted first) and takes the scalars, while the others gather
        // S_c and row j for c > j, thread (column j + 1 + t % nc, group
        // t / nc) over its group of blocks, in order
        const int nc = w - j - 1;
        const int ng = groups(nc, G, QR_GATHER_THREADS);
        if (warp == QR_SCALAR_WARP) {
            column_scalars(pj + j, w, G, pj + (size_t)G * w + j, ep, s_sc,
                           b == 0 ? tau + j : nullptr);
        } else if (nc > 0) {
            const int g = tid / nc, c = j + 1 + tid - g * nc;
            if (g < ng)
                red[tid] = gather(pj + c, w, g * G / ng, (g + 1) * G / ng,
                                  ep, g == 0 ? pj + (size_t)G * w + c
                                             : nullptr, rowj + c);
        }
        __syncthreads();
        const float t = s_sc[0], beta = s_sc[1], denom = s_sc[2];
        const float rden = s_sc[3];
        // (2) a thread a row >= j: column j becomes T(v) (T(beta) on the
        // diagonal), tau v kept; column j + 1 updated and kept for the
        // sums, its sum of squares and alpha posted at once
        const int jn = j + 1;
        const float vjn = jn < w ? __fadd_rn(rowj[jn], div_rn(
            reduced(red, ng, nc, 0), denom, rden)) : 0.f;
        float ss = 0.f;
        for (int r = max(j, lo) + tid; r < hi; r += QR_THREADS) {
            float* x = &seg[(r - lo) * ld + j];
            float tv = t;
            if (r == j) {
                *x = rnd<T>(beta);
            } else {
                const float v = div_rn(*x, denom, rden);
                tv = __fmul_rn(t, v);
                *x = rnd<T>(v);
            }
            if (jn < w) {
                const float y = rnd<T>(__fsub_rn(x[1], rnd<T>(__fmul_rn(
                    tv, vjn))));
                x[1] = y;
                tx[r - lo] = make_float2(tv, r > jn ? y : 0.f);
                if (r >= jn) ss = fmaf(y, y, ss);
                if (r == jn)
                    post(scratch + (jn & 1) * par_words + (size_t)G * w + jn,
                         ep + 1u, y);
            }
        }
        if (jn == w) break;
        ss = block_sum(ss, s_red);
        u64* pn = scratch + (jn & 1) * par_words;
        if (tid == 0) post(pn + (size_t)b * w + jn, ep + 1u, ss);
        // (3) the other columns, and the rest of column jn's exchange
        post_partials<T, true>(seg, ld, tx, red, ng, nc, rowj, denom, rden,
                               red2, j, jn, w, lo, hi, pn,
                               pn + (size_t)G * w);
    }
    __syncthreads();

    for (int e = tid; e < nr * w; e += QR_THREADS) {
        const int r = e / w, c = e - r * w;
        a[(long)lo * w + e] = from_f<T>(seg[r * ld + c]);
    }
}

size_t smem_bytes(int rpb, int w) {
    return sizeof(float) * ((size_t)rpb * (w + 3) + w + 2 * QR_THREADS);
}

template <typename T>
int launch_qr_panel(T* a, float* tau, int m, int w, int blocks,
                    u64* scratch, cudaStream_t s) {
    if (m <= 0 || w <= 0) return (int)cudaGetLastError();
    if (w > QR_MAX_W || w > m || blocks < 1 || blocks > QR_MAX_BLOCKS)
        return (int)cudaErrorInvalidValue;
    const int rpb = (m + blocks - 1) / blocks;
    const size_t smem = smem_bytes(rpb, w);
    static size_t attr = 48 * 1024;
    if (smem > attr) {
        const cudaError_t e = cudaFuncSetAttribute(
            qr_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
        attr = smem;
    }
    // every block polls the others' words: cooperative, so all of them
    // are resident at once or the launch fails
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(QR_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, qr_panel_kernel<T>, a,
                                             tau, m, w, rpb, scratch);
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

// The whole (m, w) row-major panel `a`, in place, over `blocks` blocks
// (at most one a SM); tau (w,) f32; `scratch` 2 (blocks + 1) w 64-bit
// words, zeroed. Returns a cudaError_t.
int qr_panel(void* a, float* tau, int m, int w, int blocks, void* scratch,
             int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    u64* scr = (u64*)scratch;
    if (bf16)
        return launch_qr_panel((__nv_bfloat16*)a, tau, m, w, blocks, scr, s);
    return launch_qr_panel((float*)a, tau, m, w, blocks, scr, s);
}

}  // extern "C"

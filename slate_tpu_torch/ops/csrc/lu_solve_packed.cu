// Solve P A X = B on a packed bf16 LU factor, for a few right-hand
// sides, in one launch: the forward sweep on L (unit lower, below the
// diagonal), then the backward sweep on U (on and above it). B is read
// through the composed row permutation. The device work of
// ops/kernels.py lu_solve_packed for CUDA tensors.
//
// Replaces no Pallas kernel: it stands where the reference's getrs
// (slate_tpu/linalg/lu.py) calls XLA's triangular_solve builtin, twice,
// on the masked halves of the factor. Before it the port masked each
// half of the 16384^2 factor (tril / triu), upcast it to f32 (bf16 has
// no library solve) and ran a library trsv: ~6 GB of traffic and
// ~5.3 ms a solve on an H100, 31 times a gesv_mixed_gmres call.
//
// Rounding, as that route's: B's bf16 values upcast exactly; each sweep
// accumulates in f32; the forward sweep's y stays f32 until the sweep
// ends and is rounded to bf16 before the backward sweep, whose x is
// rounded to bf16 at the end. Only the order of the f32 sums differs.
// A quotient by U's diagonal is the IEEE quotient: two Markstein
// corrections of s * RN(1/d), exact in the normal range, and a true
// division outside it (a zero, inf or nan pivot gives what the library
// gives, inf or nan, and never stops the sweep).
//
// Bound on an H100: bytes, the factor read once as bf16 (n^2 x 2 B:
// 0.537 GB, 0.160 ms at 3.35 TB/s for n = 16384), and latency, the
// chain of dependent substitutions: per row of each sweep a dependent
// fma (U's also its quotient, five more), and per block of rows one
// trip through L2 from the CTA that solved the rows above it.
//
// Design. Rows in blocks of R = 128; a CTA per block and sweep, 2
// ceil(n / R) CTAs. A CTA takes its block from an atomic ticket
// (forward blocks top down, then backward blocks bottom up), so a CTA
// only ever waits on CTAs with smaller tickets, which have all
// started: no deadlock, whatever the number of resident CTAs. Solved
// values are published to a scratch vector that the host fills with
// 0xffffffff first, a NaN that no arithmetic here stores (stored NaNs
// are canonical, 0x7fffffff), so a value is its own ready flag: no
// fences. Eight product warps stream the block's rows left of the
// diagonal block (right of it, backward) in 32-column pieces, 16-byte
// loads a lane, a batch of pieces ahead in registers, and multiply
// each piece by its solved values from a ring in shared memory. The
// ninth warp fills that ring: it reads the published values in rounds
// of up to 16 pieces (512 rows at one right-hand side), one trip to L2
// a round, and a piece goes in once all of its values are in. Their
// sums reach shared memory once, when the block's last piece is in.
// Then the ninth warp solves the R x R diagonal block from shared
// memory, four rows a lane: lane t solves its 4 x 4 block in registers
// (no shuffle inside it), broadcasts the 4 values, and every later
// lane subtracts them from its 4 rows; the lanes publish their rows
// when the block is done (the next block needs all of them first).
// The backward block is loaded mirrored, so the same code runs it top
// down.
//
// Measured on an H100 at n = 16384, one right-hand side (globaltimer
// marks in each CTA): ~1.3 us a forward block's diagonal solve, ~3.6
// us a backward one's (its four quotients a lane step lie on the
// chain), ~1.0 us between one block's last value and the next block's
// first step (one trip through L2, the last piece's products, a CTA
// barrier). Why the pieces are as they are: a product warp that polls
// and reads its own values pays two trips to L2 a piece, one after the
// other (3.0 ms a solve); a store inside the chain, or an out-of-line
// quotient in lanes whose values are thrown away, sits on the chain
// (2.3 ms); coefficient blocks 64 bytes apart in shared memory conflict
// four ways (1.2 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LS_R = 128;                  // rows of a block
constexpr int LS_PROD_WARPS = 8;           // warps on the off-diagonal part
constexpr int LS_WARP_ROWS = LS_R / LS_PROD_WARPS;
constexpr int LS_THREADS = 32 * (LS_PROD_WARPS + 1);
constexpr int LS_PIECE = 32;               // columns a piece
constexpr int LS_BATCH = 4;                // pieces loaded ahead
constexpr int LS_SUB = LS_R / 4;           // 4 x 4 blocks a side
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PENDING = 0xffffffffu;  // not yet published
constexpr int LS_RING = 8192;              // floats of solved values staged per CTA
constexpr int LS_FEED_V4 = 4;              // 16-byte loads a feeding lane issues a round

// Row a of the 4 x 4 block (t, l) of the diagonal block in shared
// memory, as a float4 index: at each step t the lanes l read 16-byte
// words side by side (no bank conflict), and a lane's blocks lie
// LS_SUB * 4 float4s apart
__device__ __forceinline__ int blk(int t, int a, int l) { return (t * 4 + a) * LS_SUB + l; }

__device__ __forceinline__ uint4 ld_poll4(const float* p) {
    uint4 v;
    asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

// n published floats from p (16-byte aligned, n a multiple of 4)
template <int N>
__device__ __forceinline__ void read_published(const float* p, float* out) {
    for (;;) {
        bool pending = false;
#pragma unroll
        for (int v = 0; v < N / 4; ++v) {
            const uint4 w = ld_poll4(p + 4 * v);
            pending |= w.x == PENDING || w.y == PENDING || w.z == PENDING
                       || w.w == PENDING;
            out[4 * v] = __uint_as_float(w.x);
            out[4 * v + 1] = __uint_as_float(w.y);
            out[4 * v + 2] = __uint_as_float(w.z);
            out[4 * v + 3] = __uint_as_float(w.w);
        }
        if (!pending) return;
    }
}

__device__ __forceinline__ float lo_bf(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float bf_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// What is stored: never the PENDING pattern
__device__ __forceinline__ float canon(float v) {
    return v != v ? __uint_as_float(0x7fffffffu) : v;
}

// 8 bf16 of a row from column col: zero past n or on a padding row
__device__ __forceinline__ uint4 load_group(const unsigned short* rowp, bool rowok,
                                            int col, int n) {
    if (!rowok || col >= n) return make_uint4(0, 0, 0, 0);
    if (col + 8 <= n) return __ldcs(reinterpret_cast<const uint4*>(rowp + col));
    unsigned e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = col + j < n ? rowp[col + j] : 0u;
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                      e[6] | e[7] << 16);
}

// s / d from r = RN(1/d): two Markstein corrections of s r, the IEEE
// quotient wherever d and the result lie in [2^-100, 2^100] (in_range
// says whether they do; elsewhere the caller divides)
__device__ __forceinline__ float qdiv(float s, float d, float r) {
    float q = s * r;
    float e = fmaf(-d, q, s);
    q = fmaf(e, r, q);
    e = fmaf(-d, q, s);
    return fmaf(e, r, q);
}

__device__ __forceinline__ bool in_range(float v) {
    const float a = fabsf(v);
    return a >= 0x1p-100f && a <= 0x1p+100f;
}

// The diagonal block into shared memory as 4 x 4 blocks (t, l), l >= t
// (those above are never read for a result), of the lower triangle in
// local order (the backward block mirrored: local row R-1-i is the
// block's row i): the strict lower part, the diagonal (1 forward; U's,
// or 1 on a padding row, backward) and zeros above it.
template <bool UPPER>
__device__ void load_diag(const unsigned short* lu, long long lda, int n, int r0,
                          float* T) {
    for (int q = threadIdx.x; q < LS_R * (LS_R / 8); q += LS_THREADS) {
        const int ar = q / (LS_R / 8), ac = (q % (LS_R / 8)) * 8;
        const int row = r0 + ar;
        // any element strictly below the local diagonal, or U's diagonal
        const bool want = UPPER ? ac + 7 >= ar : ac < ar;
        const uint4 v = want ? load_group(lu + (long long)row * lda, row < n, r0 + ac, n)
                             : make_uint4(0, 0, 0, 0);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int rho = UPPER ? LS_R - 1 - ar : ar;
            const int kap = UPPER ? LS_R - 1 - (ac + j) : ac + j;
            if ((kap >> 2) > (rho >> 2)) continue;
            float val = (j & 1) ? hi_bf(w[j >> 1]) : lo_bf(w[j >> 1]);
            if (kap > rho) val = 0.f;
            else if (kap == rho) val = (UPPER && row < n) ? val : 1.f;
            T[blk(kap >> 2, rho & 3, rho >> 2) * 4 + (kap & 3)] = val;
        }
    }
}

// Solved values a CTA has read, in shared memory: a ring of pieces in
// the order the product warps take them, the count fed so far, and
// each product warp's count of pieces done (the ring's free slots).
template <int KC>
struct Stage {
    static constexpr int PIECES = LS_RING / (LS_PIECE * KC);
    float ring[LS_RING];
    int fed;
    int done[LS_PROD_WARPS];
};

// The pieces of a block's off-diagonal part, in the order their values
// are published: left to right (forward), right to left (backward).
template <bool UPPER>
struct Pieces {
    int first, count;
    __device__ Pieces(int n, int r0)
        : first(UPPER ? (n + LS_PIECE - 1) / LS_PIECE - 1 : 0),
          count(UPPER ? max((n + LS_PIECE - 1) / LS_PIECE - (r0 + LS_R) / LS_PIECE, 0)
                      : r0 / LS_PIECE) {}
    __device__ int col(int q) const { return (UPPER ? first - q : q) * LS_PIECE; }
};

// The feeding warp: copies published values of the block's pieces into
// the ring as they appear, LS_FEED_V4 16-byte loads a lane a round (a
// value read is its own ready flag; a piece goes in once all of its
// values are published), and never past the slowest product warp.
template <int KC, bool UPPER>
__device__ void feed(const float* src, Pieces<UPPER> pc, Stage<KC>* sg) {
    constexpr int V4 = LS_PIECE * KC / 4;            // 16-byte words a piece
    constexpr int ROUND = 32 * LS_FEED_V4 / V4;      // pieces a round
    static_assert(ROUND >= 1, "a round holds a piece");
    const int lane = threadIdx.x & 31;
    volatile int* vdone = sg->done;
    int fed = 0;
    while (fed < pc.count) {
        int slow = vdone[0];
#pragma unroll
        for (int w = 1; w < LS_PROD_WARPS; ++w) slow = min(slow, vdone[w]);
        const int take = min(min(ROUND, pc.count - fed), slow + Stage<KC>::PIECES - fed);
        if (take <= 0) continue;
        uint4 v[LS_FEED_V4];
        int pend = take;
#pragma unroll
        for (int j = 0; j < LS_FEED_V4; ++j) {
            const int i = lane + 32 * j, p = i / V4;
            if (p < take) {
                v[j] = ld_poll4(src + (long long)pc.col(fed + p) * KC + (i % V4) * 4);
                if (v[j].x == PENDING || v[j].y == PENDING || v[j].z == PENDING
                    || v[j].w == PENDING)
                    pend = min(pend, p);
            }
        }
        const int ready = __reduce_min_sync(FULL, pend);
#pragma unroll
        for (int j = 0; j < LS_FEED_V4; ++j) {
            const int i = lane + 32 * j, p = i / V4;
            if (p < ready)
                reinterpret_cast<uint4*>(sg->ring)[((fed + p) % Stage<KC>::PIECES) * V4 + i % V4] =
                    v[j];
        }
        if (ready > 0) {
            __threadfence_block();
            __syncwarp();
            fed += ready;
            if (lane == 0) *(volatile int*)&sg->fed = fed;
        }
    }
}

// A product warp: part[i] = sum over the block's solved columns c of
// A[r0 + i, c] v[c], for its 16 rows; the factor streams a batch of
// pieces ahead in registers, the values come from the ring.
template <int KC, bool UPPER>
__device__ void off_diagonal(const unsigned short* lu, long long lda, int n, int r0,
                             Pieces<UPPER> pc, Stage<KC>* sg, float* part) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane & 3;
    const int rr = warp * LS_WARP_ROWS + (lane >> 2);
    const unsigned short* rowp[2];
    bool rowok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = r0 + rr + 8 * i;
        rowok[i] = row < n;
        rowp[i] = lu + (long long)(rowok[i] ? row : 0) * lda;
    }
    // two sums a row and right-hand side (even and odd pieces): the
    // last batch, on the chain between two blocks, runs half as deep
    float acc[2][2][KC];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int k = 0; k < KC; ++k) acc[h][i][k] = 0.f;

    const int count = pc.count;
    uint4 cur[2][LS_BATCH], nxt[2][LS_BATCH];
#pragma unroll
    for (int u = 0; u < LS_BATCH; ++u) {
        const int c = u < count ? pc.col(u) + 8 * g : n;
#pragma unroll
        for (int i = 0; i < 2; ++i) cur[i][u] = load_group(rowp[i], rowok[i], c, n);
    }
    volatile int* vfed = &sg->fed;
    for (int q0 = 0; q0 < count; q0 += LS_BATCH) {
#pragma unroll
        for (int u = 0; u < LS_BATCH; ++u) {
            const int q = q0 + LS_BATCH + u;
            const int c = q < count ? pc.col(q) + 8 * g : n;
#pragma unroll
            for (int i = 0; i < 2; ++i) nxt[i][u] = load_group(rowp[i], rowok[i], c, n);
        }
        const int last = min(q0 + LS_BATCH, count);
        while (*vfed < last) {}
        __threadfence_block();
#pragma unroll
        for (int u = 0; u < LS_BATCH; ++u) {
            if (q0 + u >= count) break;
            const float4* yp = reinterpret_cast<const float4*>(
                sg->ring + ((q0 + u) % Stage<KC>::PIECES) * LS_PIECE * KC + 8 * g * KC);
            float v[8 * KC];
#pragma unroll
            for (int j = 0; j < 2 * KC; ++j) {
                const float4 w = yp[j];
                v[4 * j] = w.x;
                v[4 * j + 1] = w.y;
                v[4 * j + 2] = w.z;
                v[4 * j + 3] = w.w;
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const unsigned w[4] = {cur[i][u].x, cur[i][u].y, cur[i][u].z, cur[i][u].w};
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float a = (j & 1) ? hi_bf(w[j >> 1]) : lo_bf(w[j >> 1]);
#pragma unroll
                    for (int k = 0; k < KC; ++k)
                        acc[u & 1][i][k] = fmaf(a, v[j * KC + k], acc[u & 1][i][k]);
                }
            }
        }
        // the slots of this batch are free once every lane has read them
        __threadfence_block();
        __syncwarp();
        if (lane == 0) *(volatile int*)&sg->done[warp] = last;
#pragma unroll
        for (int u = 0; u < LS_BATCH; ++u)
#pragma unroll
            for (int i = 0; i < 2; ++i) cur[i][u] = nxt[i][u];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < KC; ++k) {
            float s = acc[0][i][k] + acc[1][i][k];
            s += __shfl_xor_sync(FULL, s, 1);
            s += __shfl_xor_sync(FULL, s, 2);
            if (g == 0) part[(rr + 8 * i) * KC + k] = s;
        }
}

// One block of one sweep, by the whole CTA.
template <int KC, bool UPPER>
__device__ void solve_block(const unsigned short* lu, long long lda, int n,
                            const long long* perm, const unsigned short* b, long long ldb,
                            int k_used, unsigned short* out, long long ldo, float* ybuf,
                            float* xbuf, int r0, float* T, float* part, Stage<KC>* sg) {
    load_diag<UPPER>(lu, lda, n, r0, T);
    if (threadIdx.x < LS_PROD_WARPS) sg->done[threadIdx.x] = 0;
    if (threadIdx.x == 0) sg->fed = 0;
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Pieces<UPPER> pc(n, r0);
    float rhs[4][KC];
    if (warp < LS_PROD_WARPS) {
        off_diagonal<KC, UPPER>(lu, lda, n, r0, pc, sg, part);
    } else {
        // the right-hand side first: it is ready before the last piece
        if (UPPER) {
            // y rounded to bf16, the backward sweep's right-hand side:
            // this lane's rows r0 + R-1 - (4 lane + a), 4 in a row
            // (published for every row of the block, padding rows 0)
            const int base = r0 + LS_R - 4 - 4 * lane;
            float v[4 * KC];
            read_published<4 * KC>(ybuf + (long long)base * KC, v);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int k = 0; k < KC; ++k) rhs[a][k] = bf_round(v[(3 - a) * KC + k]);
        } else {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int row = r0 + 4 * lane + a;
                const long long src = row < n ? perm[row] : 0;
#pragma unroll
                for (int k = 0; k < KC; ++k)
                    rhs[a][k] = (row < n && k < k_used)
                                    ? __uint_as_float((unsigned)b[src * ldb + k] << 16)
                                    : 0.f;
            }
        }
        feed<KC, UPPER>(UPPER ? xbuf : ybuf, pc, sg);
    }
    __syncthreads();
    if (warp < LS_PROD_WARPS) return;

    // the diagonal warp
    float s[4][KC];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int rho = 4 * lane + a;
        const int i = UPPER ? LS_R - 1 - rho : rho;
#pragma unroll
        for (int k = 0; k < KC; ++k) s[a][k] = rhs[a][k] - part[i * KC + k];
    }
    // this lane's own 4 x 4 block
    const float4* own = reinterpret_cast<const float4*>(T);
    float c[4][4], d[4], r[4];
    bool ok = true;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const float4 w = own[blk(lane, a, lane)];
        c[a][0] = w.x;
        c[a][1] = w.y;
        c[a][2] = w.z;
        c[a][3] = w.w;
        d[a] = c[a][a];
        r[a] = __frcp_rn(d[a]);
        ok &= in_range(d[a]);
    }
    float keep[4][KC] = {};
    // the blocks (st, lane) this lane subtracts, one step ahead
    const float4* cb = reinterpret_cast<const float4*>(T) + lane;
    float4 w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) w[a] = cb[blk(0, a, 0)];
#pragma unroll 8
    for (int st = 0; st < LS_SUB; ++st) {
        float4 wn[4];
        const int nx = min(st + 1, LS_SUB - 1);
#pragma unroll
        for (int a = 0; a < 4; ++a) wn[a] = cb[blk(nx, a, 0)];
        // lane st solves its block (the other lanes' values are unused)
        const bool mine = lane == st;
        float y[4][KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
            const float v0 = s[0][k];
            y[0][k] = UPPER ? qdiv(v0, d[0], r[0]) : v0;
            const float v1 = fmaf(-c[1][0], y[0][k], s[1][k]);
            y[1][k] = UPPER ? qdiv(v1, d[1], r[1]) : v1;
            const float v2 = fmaf(-c[2][1], y[1][k], fmaf(-c[2][0], y[0][k], s[2][k]));
            y[2][k] = UPPER ? qdiv(v2, d[2], r[2]) : v2;
            const float v3 = fmaf(-c[3][2], y[2][k],
                                  fmaf(-c[3][1], y[1][k], fmaf(-c[3][0], y[0][k], s[3][k])));
            y[3][k] = UPPER ? qdiv(v3, d[3], r[3]) : v3;
        }
        // broadcast at once; the rare quotient out of the corrected
        // product's range (a zero, huge or tiny pivot or value) is
        // divided again by lane st and broadcast anew
        float Y[4][KC];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < KC; ++k) Y[a][k] = __shfl_sync(FULL, y[a][k], st);
        if (UPPER) {
            bool exact = ok;
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int k = 0; k < KC; ++k) exact &= in_range(y[a][k]);
            if (__any_sync(FULL, mine && !exact)) {
#pragma unroll
                for (int k = 0; k < KC; ++k) {
                    y[0][k] = __fdiv_rn(s[0][k], d[0]);
                    y[1][k] = __fdiv_rn(fmaf(-c[1][0], y[0][k], s[1][k]), d[1]);
                    y[2][k] = __fdiv_rn(
                        fmaf(-c[2][1], y[1][k], fmaf(-c[2][0], y[0][k], s[2][k])), d[2]);
                    y[3][k] = __fdiv_rn(
                        fmaf(-c[3][2], y[2][k],
                             fmaf(-c[3][1], y[1][k], fmaf(-c[3][0], y[0][k], s[3][k]))),
                        d[3]);
#pragma unroll
                    for (int a = 0; a < 4; ++a) Y[a][k] = __shfl_sync(FULL, y[a][k], st);
                }
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < KC; ++k) keep[a][k] = mine ? y[a][k] : keep[a][k];
        // later lanes subtract the block (t = st, l = lane); earlier
        // lanes subtract what lies above the diagonal and discard it
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                float v = s[a][k];
                v = fmaf(-w[a].x, Y[0][k], v);
                v = fmaf(-w[a].y, Y[1][k], v);
                v = fmaf(-w[a].z, Y[2][k], v);
                v = fmaf(-w[a].w, Y[3][k], v);
                s[a][k] = v;
            }
            w[a] = wn[a];
        }
    }
    // publish the block at once: the next block needs all of it before
    // its own diagonal block, and a store inside the loop would sit on
    // the chain. Lane l's rows are 4 in a row (mirrored backward).
    const int base = UPPER ? r0 + LS_R - 4 - 4 * lane : r0 + 4 * lane;
    float v[4 * KC];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < KC; ++k) v[(UPPER ? 3 - a : a) * KC + k] = canon(keep[a][k]);
    float4* dst = reinterpret_cast<float4*>((UPPER ? xbuf : ybuf) + (long long)base * KC);
#pragma unroll
    for (int j = 0; j < KC; ++j)
        __stcg(dst + j, make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
    if (UPPER) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const long long row = base + 3 - a;
#pragma unroll
            for (int k = 0; k < KC; ++k)
                if (row < n && k < k_used)
                    out[row * ldo + k] = __bfloat16_as_ushort(__float2bfloat16_rn(keep[a][k]));
        }
    }
}

template <int KC>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)LS_SUB * LS_SUB * 16 + (size_t)LS_R * KC) + sizeof(Stage<KC>);
}

// One CTA: the block its ticket names.
template <int KC>
__global__ void __launch_bounds__(LS_THREADS, KC <= 2 ? 2 : 1)
lu_solve_kernel(const unsigned short* lu, long long lda, int n, const long long* perm,
                const unsigned short* b, long long ldb, int k_used, unsigned short* out,
                long long ldo, float* ybuf, float* xbuf, int* counter, int nblk) {
    extern __shared__ float4 smem[];
    float* T = reinterpret_cast<float*>(smem);                 // LS_SUB^2 x 16
    float* part = T + LS_SUB * LS_SUB * 16;                    // LS_R x KC
    auto* sg = reinterpret_cast<Stage<KC>*>(part + LS_R * KC);
    __shared__ int s_ticket;
    if (threadIdx.x == 0) s_ticket = -1 - atomicAdd(counter, -1);
    __syncthreads();
    const int t = s_ticket;
    if (t < nblk)
        solve_block<KC, false>(lu, lda, n, perm, b, ldb, k_used, out, ldo, ybuf, xbuf,
                               t * LS_R, T, part, sg);
    else
        solve_block<KC, true>(lu, lda, n, perm, b, ldb, k_used, out, ldo, ybuf, xbuf,
                              (2 * nblk - 1 - t) * LS_R, T, part, sg);
}

template <int KC>
int launch(const unsigned short* lu, long long lda, int n, const long long* perm,
           const unsigned short* b, long long ldb, int k_used, unsigned short* out,
           long long ldo, float* scratch, int nblk, cudaStream_t s) {
    constexpr size_t smem = smem_bytes<KC>();
    const cudaError_t e = cudaFuncSetAttribute(
        lu_solve_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    float* ybuf = scratch;
    float* xbuf = scratch + (size_t)nblk * LS_R * KC;
    int* counter = reinterpret_cast<int*>(xbuf + (size_t)nblk * LS_R * KC);
    lu_solve_kernel<KC><<<2 * nblk, LS_THREADS, smem, s>>>(
        lu, lda, n, perm, b, ldb, k_used, out, ldo, ybuf, xbuf, counter, nblk);
    return (int)cudaGetLastError();
}

int columns_of(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : 4; }

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// 4-byte words of scratch a solve of order n with k right-hand sides
// takes (16-byte aligned, contents overwritten).
int lu_solve_packed_scratch(int n, int k) {
    const int nblk = (n + LS_R - 1) / LS_R;
    return 2 * nblk * LS_R * columns_of(k) + 4;
}

// out[i, j] = X[i, j] for i < n, j < k, with P A X = B: lu the packed
// bf16 factor (n x n, leading dimension lda, a multiple of 8, 16-byte
// aligned), perm the composed row permutation (int64, n entries: B's
// row perm[i] is row i of P B), b bf16 with leading dimension ldb, out
// bf16 with leading dimension ldo (its other entries untouched);
// 1 <= k <= 4; scratch as lu_solve_packed_scratch says; on `stream`.
int lu_solve_packed(const void* lu, long long lda, int n, const long long* perm,
                    const void* b, long long ldb, int k, void* out, long long ldo,
                    void* scratch, void* stream) {
    if (n < 0 || k < 1 || k > 4 || lda < n || lda % 8 != 0
        || ((uintptr_t)lu & 15) != 0 || ((uintptr_t)scratch & 15) != 0)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const int nblk = (n + LS_R - 1) / LS_R;
    const cudaError_t e = cudaMemsetAsync(
        scratch, 0xff, sizeof(float) * (size_t)lu_solve_packed_scratch(n, k), s);
    if (e != cudaSuccess) return (int)e;
    const auto* a = static_cast<const unsigned short*>(lu);
    const auto* bb = static_cast<const unsigned short*>(b);
    auto* o = static_cast<unsigned short*>(out);
    auto* sc = static_cast<float*>(scratch);
    switch (columns_of(k)) {
        case 1: return launch<1>(a, lda, n, perm, bb, ldb, k, o, ldo, sc, nblk, s);
        case 2: return launch<2>(a, lda, n, perm, bb, ldb, k, o, ldo, sc, nblk, s);
        default: return launch<4>(a, lda, n, perm, bb, ldb, k, o, ldo, sc, nblk, s);
    }
}

}  // extern "C"

// Ragged batched partial-pivot LU: the device work of ops/kernels.py
// ragged_getrf.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_getrf_pallas (a grid
// over the batch; per element a blocked right-looking sweep of
// ceil(s/ib) steps over blkdiag(A[:s, :s], I)). Per stripe [k0, k1) of
// ib columns of the live block, as the reference:
//   * the base case, per column j: the pivot p = the lowest row of
//     largest |a_rj| over rows >= j; the full-row swap; the multipliers
//     T(a_rj / safe) (a zero pivot divides by 1); the rank-1 update
//     T(a_rc - T(mu_r a_jc)) confined to the stripe's columns;
//   * the U12 row substitution T(a_ic - T(l_ir u_rc)), rows in order;
//   * the trailing update T(A22 - T(L21 U12)), products summed in f32 by
//     fmaf in k order.
// Restricted to the live block it equals the reference's whole-ceiling
// sweep: padded rows hold exact zeros in live columns, so they are
// never chosen and take no update, and padded columns pivot on their
// own unit diagonal, so their swap targets are identity swaps and the
// pad comes back as the identity. The pad of the input is never read.
// Swap targets are written as int32 (the reference writes an f32 row
// for its TPU compiler). T is f32 or bf16, arithmetic f32.
//
// Bound on an H100: sum 2/3 s^3 f32 operations (the trailing updates),
// or the live bytes (33 us for the serving stream's first flush, 64
// elements of orders up to 608); and a latency floor, s_max dependent
// columns. What holds a flush back is its largest element: on one SM
// its trailing updates and column-by-column U12 solve took most of its
// time (clock64 marks, PERF.md).
//
// Design: a thread-block cluster of C blocks per element (C =
// ceil(n / 128), at most 8, from the ceiling: 5 at the serving stream's
// first flush, where 4 and 6-8 were slower on an H100 (fewer blocks
// leave the trailing tiles on the critical path, more leave fewer
// elements running at once); 8 at the order-1024 flush), the clusters
// ordered by decreasing order so the largest elements start first; one
// cluster barrier a stripe.
//  - Rank 0 factors each stripe with lu_base_block.cuh's block-local
//    base case: its rows [k0, s) in registers, one block barrier a
//    column, the stripe and its pivots to device memory once, at the
//    end.
//  - The swaps of the other columns are deferred to one gather a
//    stripe: every block composes the stripe's swaps into a list of
//    (destination, source) rows (one warp, shuffles and ballots), and
//    each block moves the rows of the columns it owns.
//  - The trailing columns [k1, s) are dealt in 32-column tiles; the
//    block of a tile gathers its rows, solves its U12 tile in shared
//    memory (one warp four columns, one lane a row, the substitution's
//    row passed by a shuffle), writes it back, then updates the tile's
//    rows below k1 in 64-row chunks, one lane a column and eight rows a
//    thread, the multipliers from shared memory.
//  - Look-ahead: rank 0 owns the first trailing tile (the next stripe's
//    columns) and no other, so right after that tile it factors the
//    next stripe while the other blocks finish this stripe's tiles and
//    the gathers of the columns left of the stripe.
// Every entry takes the operations of the blocked sweep in its order,
// so pivots, multipliers and the substitution are bitwise the plain
// version's where their inputs are, and the trailing products are
// summed in the same k order as the first design's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lu_base_block.cuh"
#include "ragged.cuh"

namespace {

using namespace slate_torch;

constexpr unsigned FULL = 0xffffffffu;
constexpr int NTH = LB_THREADS;          // 256
constexpr int NWARPS = NTH / 32;
constexpr int W = LB_W;                  // widest stripe (32)
constexpr int TCOL = 32;                 // columns of a trailing tile
constexpr int CH = 64;                   // rows of an update chunk
constexpr int PAD = W + 1;               // conflict-free row pitch
constexpr int MAX_CLUSTER = 8;
// batches up to this size are ordered by decreasing order
constexpr int ORDER_MAX = 1024;

struct Smem {
    LuBlockSmem b;           // the base case's exchange, the gather lists
    float l11[W][PAD];       // the stripe's unit-lower block
    float u[W][PAD];         // a tile's U12 rows
    float l21[CH][PAD];      // an update chunk's multipliers
};

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One trailing tile, columns [c, c + nc) of stripe [k0, k0 + cw): its
// rows gathered, U12 solved and written, the rows [k0 + cw, s) updated.
// sm.l11 holds the stripe's unit-lower block.
template <typename T>
__device__ void trail_tile(T* o, int n, int s, int k0, int cw, int c,
                           int nc, Smem& sm) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int k1 = k0 + cw;
    gather_cols(o, n, c, nc, sm.b);
    __syncthreads();
    for (int e = tid; e < W * TCOL; e += NTH) {
        const int r = e / TCOL, cc = e % TCOL;
        sm.u[r][cc] = r < cw && cc < nc
            ? to_f(__ldcg(o + (long)(k0 + r) * n + c + cc)) : 0.f;
    }
    __syncthreads();
    {
        // the substitution: warp w columns 4 w ... 4 w + 3, lane i row
        // k0 + i; row r is final when step r reads it
        float x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = sm.u[lane][4 * warp + q];
        for (int r = 0; r + 1 < cw; ++r) {
            const float l = sm.l11[lane][r];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float xr = __shfl_sync(FULL, x[q], r);
                if (lane > r)
                    x[q] = rnd<T>(__fsub_rn(x[q], rnd<T>(__fmul_rn(l, xr))));
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) sm.u[lane][4 * warp + q] = x[q];
    }
    __syncthreads();
    for (int e = tid; e < cw * TCOL; e += NTH) {
        const int r = e / TCOL, cc = e % TCOL;
        if (cc < nc) o[(long)(k0 + r) * n + c + cc] = from_f<T>(sm.u[r][cc]);
    }
    // the rows below, CH at a time: lane a column, rows warp + 8 i; the
    // next chunk's multipliers are fetched into registers while this
    // one is computed, and a chunk's entries before its products
    constexpr int RPT = CH / NWARPS;
    constexpr int LPT = CH * W / NTH;
    float lv[LPT];
    auto fetch = [&](int r0) {
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
            const int e = tid + NTH * q, r = e / W, k = e % W;
            lv[q] = r0 + r < s && k < cw
                ? to_f(__ldcg(o + (long)(r0 + r) * n + k0 + k)) : 0.f;
        }
    };
    fetch(k1);
    for (int r0 = k1; r0 < s; r0 += CH) {
        const int nr = min(CH, s - r0);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < LPT; ++q) {
            const int e = tid + NTH * q;
            sm.l21[e / W][e % W] = lv[q];
        }
        __syncthreads();
        if (r0 + CH < s) fetch(r0 + CH);
        if (lane < nc) {
            float xv[RPT], acc[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = warp + NWARPS * i;
                xv[i] = r < nr
                    ? to_f(__ldcg(o + (long)(r0 + r) * n + c + lane)) : 0.f;
                acc[i] = 0.f;
            }
            for (int k = 0; k < cw; ++k) {
                const float uk = sm.u[k][lane];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    acc[i] = fmaf(sm.l21[warp + NWARPS * i][k], uk, acc[i]);
            }
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int r = warp + NWARPS * i;
                if (r < nr)
                    o[(long)(r0 + r) * n + c + lane] =
                        from_f<T>(__fsub_rn(xv[i], rnd<T>(acc[i])));
            }
        }
    }
    __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NTH, 1)
ragged_getrf_kernel(const T* a_all, T* o_all, int* piv_all,
                    const int* sizes, int batch, int n, int ib) {
    __shared__ Smem sm;
    __shared__ int elem;
    unsigned int C, rank;
    asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(C));
    asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
    const int tid = threadIdx.x;
    const int cid = blockIdx.x / C;

    // this cluster's element: the cid-th largest order (ties by index)
    if (tid == 0) elem = cid;
    __syncthreads();
    if (batch <= ORDER_MAX) {
        for (int e = tid; e < batch; e += NTH) {
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
    int* piv = piv_all + (long)elem * n;
    const int s = ragged_order(sizes, elem, n);

    // the pad, the live block copied (nothing to do in place), and the
    // pad's identity swaps: one warp a row, split over the cluster
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = rank + C * warp; r < n; r += C * NWARPS) {
        T* dst = o + (long)r * n;
        const T* src = a + (long)r * n;
        for (int c = lane; c < n; c += 32)
            dst[c] = r < s && c < s ? (a == o ? dst[c] : src[c])
                                    : from_f<T>(r == c ? 1.f : 0.f);
        if (lane == 0 && r >= s) piv[r] = r;
    }
    cluster_sync();
    if (s > 0 && rank == 0)
        lu_block_factor_any<T>(o, piv, n, s, 0, min(ib, s), sm.b);
    cluster_sync();

    for (int k0 = 0; k0 < s; k0 += ib) {
        const int cw = min(ib, s - k0), k1 = k0 + cw;
        swap_lists(piv, k0, cw, sm.b);
        for (int e = tid; e < W * W; e += NTH) {
            const int r = e / W, c = e % W;
            sm.l11[r][c] = r < cw && c < cw
                ? to_f(__ldcg(o + (long)(k0 + r) * n + k0 + c)) : 0.f;
        }
        __syncthreads();
        const int ntiles = (s - k1 + TCOL - 1) / TCOL;
        if (rank == 0) {
            // the next stripe's columns, then its base case
            if (ntiles > 0) {
                trail_tile<T>(o, n, s, k0, cw, k1, min(TCOL, s - k1), sm);
                lu_block_factor_any<T>(o, piv, n, s, k1, min(ib, s - k1),
                                       sm.b);
            }
            if (C == 1) {
                for (int t = 1; t < ntiles; ++t)
                    trail_tile<T>(o, n, s, k0, cw, k1 + TCOL * t,
                                  min(TCOL, s - k1 - TCOL * t), sm);
                for (int c = 0; c < k0; c += TCOL) {
                    gather_cols(o, n, c, min(TCOL, k0 - c), sm.b);
                    __syncthreads();
                }
            }
        } else {
            for (int t = rank; t < ntiles; t += C - 1)
                trail_tile<T>(o, n, s, k0, cw, k1 + TCOL * t,
                              min(TCOL, s - k1 - TCOL * t), sm);
            for (int c = TCOL * (rank - 1); c < k0; c += TCOL * (C - 1)) {
                gather_cols(o, n, c, min(TCOL, k0 - c), sm.b);
                __syncthreads();
            }
        }
        cluster_sync();
    }
}

// Blocks of an element's cluster at ceiling n.
inline int cluster_size(int n) {
    const int c = (n + 127) / 128;
    return c < MAX_CLUSTER ? c : MAX_CLUSTER;
}

template <typename T>
int launch(const void* a, void* o, int* piv, const int* sizes, int batch,
           int n, int ib, cudaStream_t stream) {
    if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
    if (ib < 1 || ib > RG_MAX_BLK) return (int)cudaErrorInvalidValue;
    const int C = cluster_size(n);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(batch * C);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, ragged_getrf_kernel<T>, (const T*)a, (T*)o, piv, sizes, batch,
        n, ib);
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
// factored into `o` (which may be `a`), int32 swap targets (batch, n)
// into `piv`, per-element orders `sizes` (int32, device), blocks of
// `ib` columns, on `stream`. Returns a cudaError_t.
int ragged_getrf(const void* a, void* o, int* piv, const int* sizes,
                 int batch, int n, int ib, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<__nv_bfloat16>(a, o, piv, sizes, batch, n, ib, s)
                : launch<float>(a, o, piv, sizes, batch, n, ib, s);
}

// Blocks of the cluster that factors each element at ceiling n.
int ragged_getrf_cluster(int n) { return cluster_size(n); }

}  // extern "C"

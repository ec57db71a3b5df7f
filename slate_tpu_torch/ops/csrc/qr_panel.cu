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
// Panel types f32 and bf16 (the `bf16` argument). The scalars, the
// v^T A products and the update use __fmul_rn/__fadd_rn/__fsub_rn, so
// none of them contracts into an FMA and each rounds where the plain
// PyTorch version rounds; the sum of squares of the norm is accumulated
// with fmaf, in another order than the plain version's sum.
//
// Bound on an H100: 2 m w^2 - 2 w^3 / 3 FLOPs, at 8192 x 128 that is
// 267 MFLOP, 4.0 us at the f32 rate (the panel read once and written
// once is 8 MB in f32: 2.5 us). The kernel is latency-bound instead: w
// columns in sequence, each needing two reductions over all m rows (the
// norm, then v^T A). Design: the cooperative pattern of coop.cuh. One
// block per SM owns a contiguous row slice of the panel in shared
// memory for the whole call (8192 x 128 f32: 63 rows x 128 x 4 B =
// 32 KB a block), so no update touches device memory. Per column three
// grid barriers: after each block posts its partial norm (and the owner
// of row j posts alpha); after each block posts its w partial sums of
// v^T A; and after block b has reduced the partials of columns
// j + 1 + b, j + 1 + b + G, ... (one warp, lanes strided over the
// blocks, then a shuffle tree) into the final v^T A. Every block then
// reads the w finals, so all blocks use bitwise the same v^T A (and
// reduce the norm partials themselves, in one fixed order). The third
// barrier replaces G x w dependent L2 reads per block per column (the
// first version: every block summed every column's G partials, 15 us a
// column at 8192 x 128) with G / 32 per lane in one block. Single
// buffers suffice: a block rewrites a buffer only after the next
// barrier, which every block reaches only once it has read that
// buffer. Not done: no block-level blocking of the update (compact WY
// inside the panel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace {

using slate_torch::from_f;
using slate_torch::grid_barrier;
using slate_torch::rnd;
using slate_torch::to_f;

constexpr int QR_THREADS = 256;
constexpr int QR_MAX_BLOCKS = 1024;     // partial-sum slots

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

template <typename T>
__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(T* a, float* tau, int m, int w, int rows_per_block,
                float* part_nrm, float* part_alpha, float* part_vta,
                float* vta_fin, unsigned int* bar) {
    extern __shared__ float smem[];
    __shared__ float red[QR_THREADS / 32];
    __shared__ float s_scal[3];      // tau, beta, denominator of v
    const int tid = threadIdx.x;
    const int G = gridDim.x, b = blockIdx.x;
    const int r_lo = b * rows_per_block;
    const int r_hi = min(m, r_lo + rows_per_block);
    const int nr = max(0, r_hi - r_lo);
    float* seg = smem;                             // nr x w
    float* v = seg + (size_t)rows_per_block * w;   // nr
    float* vta = v + rows_per_block;               // w

    for (int e = tid; e < nr * w; e += QR_THREADS)
        seg[e] = to_f(a[(long)r_lo * w + e]);
    __syncthreads();

    unsigned int epoch = 0;
    for (int j = 0; j < w; ++j) {
        // (1) this block's part of sum x^2 over rows >= j; the owner of
        // row j posts alpha
        float ss = 0.f;
        for (int r = max(j, r_lo) + tid; r < r_hi; r += QR_THREADS) {
            const float x = seg[(r - r_lo) * w + j];
            ss = fmaf(x, x, ss);
        }
        ss = block_sum(ss, red);
        if (tid == 0) {
            part_nrm[b] = ss;
            if (j >= r_lo && j < r_hi) *part_alpha = seg[(j - r_lo) * w + j];
        }
        grid_barrier(bar, ++epoch);
        // (2) the column's scalars, the same in every block
        if (tid < 32) {
            float s = 0.f;
            for (int i = tid; i < G; i += 32) s += __ldcg(&part_nrm[i]);
            for (int off = 16; off > 0; off >>= 1)
                s += __shfl_down_sync(0xffffffffu, s, off);
            if (tid == 0) {
                const float nrm2 = s;
                const float alpha = __ldcg(part_alpha);
                const float nrm = sqrtf(nrm2);
                const float beta = alpha >= 0.f ? -nrm : nrm;
                const bool degenerate = nrm2 <= 0.f;
                const float safe_beta = degenerate ? 1.f : beta;
                const float t = degenerate
                    ? 0.f : __fdiv_rn(__fsub_rn(beta, alpha), safe_beta);
                const float d = __fsub_rn(alpha, safe_beta);
                s_scal[0] = t;
                s_scal[1] = beta;
                s_scal[2] = d == 0.f ? 1.f : d;
                if (b == 0) tau[j] = t;
            }
        }
        __syncthreads();
        const float t = s_scal[0], beta = s_scal[1], denom = s_scal[2];
        for (int r = r_lo + tid; r < r_hi; r += QR_THREADS)
            v[r - r_lo] = r > j ? __fdiv_rn(seg[(r - r_lo) * w + j], denom)
                                : (r == j ? 1.f : 0.f);
        __syncthreads();
        // (3) this block's partial sums of v^T A for the columns > j
        const int r0 = max(j, r_lo);
        for (int c = j + 1 + tid; c < w; c += QR_THREADS) {
            float acc = 0.f;
            for (int r = r0; r < r_hi; ++r)
                acc = __fadd_rn(acc,
                                __fmul_rn(v[r - r_lo], seg[(r - r_lo) * w + c]));
            part_vta[(size_t)b * w + c] = acc;
        }
        grid_barrier(bar, ++epoch);
        // (3b) block b reduces columns j + 1 + b, j + 1 + b + G, ...
        if (tid < 32) {
            for (int c = j + 1 + b; c < w; c += G) {
                float acc = 0.f;
                for (int i = tid; i < G; i += 32)
                    acc = __fadd_rn(acc,
                                    __ldcg(&part_vta[(size_t)i * w + c]));
                for (int off = 16; off > 0; off >>= 1)
                    acc = __fadd_rn(acc,
                                    __shfl_down_sync(0xffffffffu, acc, off));
                if (tid == 0) vta_fin[c] = acc;
            }
        }
        grid_barrier(bar, ++epoch);
        for (int c = j + 1 + tid; c < w; c += QR_THREADS)
            vta[c] = __ldcg(&vta_fin[c]);
        __syncthreads();
        // (4) the reflection of rows >= j, then column j
        const int ncol = w - j - 1;
        for (int e = tid; e < (r_hi - r0) * ncol; e += QR_THREADS) {
            const int rl = r0 - r_lo + e / ncol, c = j + 1 + e % ncol;
            const float u = rnd<T>(__fmul_rn(__fmul_rn(t, v[rl]), vta[c]));
            float* x = &seg[rl * w + c];
            *x = rnd<T>(__fsub_rn(*x, u));
        }
        for (int r = r0 + tid; r < r_hi; r += QR_THREADS)
            seg[(r - r_lo) * w + j] = r == j ? rnd<T>(beta)
                                             : rnd<T>(v[r - r_lo]);
        __syncthreads();
    }

    for (int e = tid; e < nr * w; e += QR_THREADS)
        a[(long)r_lo * w + e] = from_f<T>(seg[e]);
}

template <typename T>
int launch_qr_panel(T* a, float* tau, int m, int w, float* scratch_f,
                    unsigned int* bar, cudaStream_t s) {
    // at least 16 rows per block, at most one block per SM
    const int blocks = slate_torch::coop_blocks(m, 16, QR_MAX_BLOCKS);
    const int rows = (m + blocks - 1) / blocks;
    const size_t smem = sizeof(float) * ((size_t)rows * w + rows + w);
    float* part_nrm = scratch_f;
    float* part_alpha = scratch_f + QR_MAX_BLOCKS;
    float* part_vta = part_alpha + 1;
    float* vta_fin = part_vta + (size_t)QR_MAX_BLOCKS * w;
    void* args[] = {&a, &tau, &m, &w, (void*)&rows, &part_nrm, &part_alpha,
                    &part_vta, &vta_fin, &bar};
    return slate_torch::coop_launch(qr_panel_kernel<T>, blocks, QR_THREADS,
                                    smem, args, bar, s);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// Floats of scratch a (., w) panel needs: the norm partials, alpha,
// the v^T A partials and finals.
int qr_panel_scratch(int w) { return QR_MAX_BLOCKS * (w + 1) + 1 + w; }

// The whole (m, w) row-major panel `a`, in place; tau (w,) f32.
int qr_panel(void* a, float* tau, int m, int w, float* scratch_f,
             unsigned int* bar, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return launch_qr_panel((__nv_bfloat16*)a, tau, m, w, scratch_f, bar,
                               s);
    return launch_qr_panel((float*)a, tau, m, w, scratch_f, bar, s);
}

}  // extern "C"

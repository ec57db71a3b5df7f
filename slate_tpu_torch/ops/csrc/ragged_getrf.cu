// Ragged batched partial-pivot LU: the device work of ops/kernels.py
// ragged_getrf.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_ragged_getrf_pallas (a grid
// over the batch; per element a blocked right-looking sweep of
// ceil(s/ib) steps over blkdiag(A[:s, :s], I)). Per block [k0, k1) of
// ib columns of the live block, as the reference:
//   * the base case, per column j: the pivot p = the lowest row of
//     largest |a_rj| over rows >= j; the full-row swap; the multipliers
//     T(a_rj / safe) (a zero pivot divides by 1); the rank-1 update
//     T(a_rc - T(mu_r a_jc)) confined to the block's columns;
//   * the U12 row substitution T(a_ic - T(l_ir u_rc)), rows in order;
//   * the trailing update T(A22 - T(L21 U12)), products summed in f32.
// Restricted to the live block it equals the reference's whole-ceiling
// sweep: padded rows hold exact zeros in live columns, so they are
// never chosen and take no update, and padded columns pivot on their
// own unit diagonal, so their swap targets are identity swaps and the
// pad comes back as the identity. The pad of the input is never read.
// Swap targets are written as int32 (the reference writes an f32 row
// for its TPU compiler). T is f32 or bf16, arithmetic f32.
//
// Bound on an H100: sum 2/3 s^3 f32 operations (the trailing updates),
// or the live bytes, whichever is larger. Design: one block of 256
// threads per element, the element in device memory (order 1024 is 4
// MB). The block's ib columns (rows k0 ... s) sit in shared memory for
// the base case (N x 33 f32, 132 KiB at N = 1024; rows padded to 33 so
// column walks are free of bank conflicts): per column a block argmax
// reduction, the swap (the rest of the two rows in device memory), the
// multipliers and the rank-1 update, five block barriers. The U12 strip
// is solved with one thread per column (the columns are independent,
// so no barrier), and the trailing update is gemm_sub.cuh's tiled GEMM
// walked by the block. Not done: tensor cores, several blocks per
// element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_sub.cuh"
#include "lu_base.cuh"
#include "ragged.cuh"

namespace {

using namespace slate_torch;

constexpr int NWARPS = RG_THREADS / 32;
constexpr int PLD = RG_MAX_BLK + 1;   // padded row of the block

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
ragged_getrf_kernel(const T* a_all, T* o_all, int* piv_all,
                    const int* sizes, int n, int ib) {
    extern __shared__ float P[];   // (s - k0) x PLD block columns
    __shared__ float s_val[NWARPS];
    __shared__ int s_row[NWARPS];
    __shared__ int s_p;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long off = (long)blockIdx.x * n * n;
    const T* a = a_all + off;
    T* o = o_all + off;
    int* piv = piv_all + (long)blockIdx.x * n;
    const int s = ragged_order(sizes, blockIdx.x, n);
    for (int j = tid; j < n; j += RG_THREADS) piv[j] = j;
    ragged_write_pad(o, n, s);
    ragged_copy_live(a, o, n, s);
    __syncthreads();

    for (int k0 = 0; k0 < s; k0 += ib) {
        const int k1 = min(k0 + ib, s), w = k1 - k0, nr = s - k0;
        // the block's columns, rows [k0, s), into shared memory
        for (int e = tid; e < nr * w; e += RG_THREADS) {
            const int r = e / w, c = e % w;
            P[r * PLD + c] = to_f(o[(long)(k0 + r) * n + k0 + c]);
        }
        __syncthreads();
        for (int jj = 0; jj < w; ++jj) {
            const int j = k0 + jj;
            // the pivot: rows visited in increasing order, strict >, so
            // each thread keeps its lowest row among equal magnitudes
            float best = -1.f;
            int brow = n;
            for (int r = jj + tid; r < nr; r += RG_THREADS) {
                const float v = fabsf(P[r * PLD + jj]);
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
                for (int i = 1; i < NWARPS; ++i)
                    argmax_merge(best, brow, s_val[i], s_row[i]);
                // an all-NaN column finds no maximum: keep row j
                const int pr = brow < n ? brow : jj;
                s_p = pr;
                piv[j] = k0 + pr;
            }
            __syncthreads();
            const int pr = s_p, p = k0 + pr;
            if (pr != jj) {
                // the full-row swap: the block's columns in shared
                // memory, the others in device memory
                for (int c = tid; c < w; c += RG_THREADS) {
                    const float t = P[jj * PLD + c];
                    P[jj * PLD + c] = P[pr * PLD + c];
                    P[pr * PLD + c] = t;
                }
                for (int c = tid; c < s - w; c += RG_THREADS) {
                    const int cc = c < k0 ? c : c + w;
                    const T t = o[(long)j * n + cc];
                    o[(long)j * n + cc] = o[(long)p * n + cc];
                    o[(long)p * n + cc] = t;
                }
            }
            __syncthreads();
            const float pivval = P[jj * PLD + jj];
            const float safe = pivval == 0.f ? 1.f : pivval;
            for (int r = jj + 1 + tid; r < nr; r += RG_THREADS)
                P[r * PLD + jj] = rnd<T>(__fdiv_rn(P[r * PLD + jj], safe));
            __syncthreads();
            const int ncol = w - jj - 1;
            for (int e = tid; e < (nr - jj - 1) * ncol; e += RG_THREADS) {
                const int r = jj + 1 + e / ncol, c = jj + 1 + e % ncol;
                P[r * PLD + c] = rnd<T>(__fsub_rn(
                    P[r * PLD + c],
                    rnd<T>(__fmul_rn(P[r * PLD + jj], P[jj * PLD + c]))));
            }
            __syncthreads();
        }
        for (int e = tid; e < nr * w; e += RG_THREADS) {
            const int r = e / w, c = e % w;
            o[(long)(k0 + r) * n + k0 + c] = from_f<T>(P[r * PLD + c]);
        }
        __syncthreads();
        // U12 = L11^-1 A12, one thread per column, rows in order
        for (int c = k1 + tid; c < s; c += RG_THREADS)
            for (int r = k0; r < k1; ++r) {
                const float u = to_f(o[(long)r * n + c]);
                for (int i = r + 1; i < k1; ++i)
                    o[(long)i * n + c] = from_f<T>(__fsub_rn(
                        to_f(o[(long)i * n + c]),
                        rnd<T>(__fmul_rn(to_f(o[(long)i * n + r]), u))));
            }
        __syncthreads();
        if (k1 < s) {
            T* a22 = o + (long)k1 * n + k1;
            cta_gemm_sub<T, false>(a22, n, o + (long)k1 * n + k0, n,
                                   o + (long)k0 * n + k1, n, a22, n, s - k1,
                                   s - k1, k1 - k0);
            __syncthreads();
        }
    }
}

template <typename T>
int launch(const void* a, void* o, int* piv, const int* sizes, int batch,
           int n, int ib, cudaStream_t stream) {
    if (batch <= 0 || n <= 0) return (int)cudaGetLastError();
    if (ib < 1 || ib > RG_MAX_BLK) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (size_t)n * PLD;
    const int rc = ragged_smem(ragged_getrf_kernel<T>, smem);
    if (rc != 0) return rc;
    ragged_getrf_kernel<T><<<batch, RG_THREADS, smem, stream>>>(
        (const T*)a, (T*)o, piv, sizes, n, ib);
    return (int)cudaGetLastError();
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

}  // extern "C"

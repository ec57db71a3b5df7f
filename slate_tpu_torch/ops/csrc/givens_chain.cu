// Apply a chain of adjacent Givens rotations to the columns of Z:
// out = Z @ G, where G is the composed chain of the n-1 rotations
// (c_k, s_k) acting on index pairs (k, k+1) in order (the matrix of
// slate_tpu_torch/linalg/svd.py _givens_chain_matrix). Per row, one
// carry t streams along the columns:
//     t = z_0;  out_k = c_k t + s_k z_{k+1};  t = -s_k t + c_k z_{k+1};
//     out_{n-1} = t.
// The device work of ops/kernels.py givens_chain_apply for CUDA tensors.
//
// Replaces slate_tpu/ops/pallas_kernels.py _givens_apply_pallas (:739,
// pallas_call :763; entry givens_chain_apply :827). The TPU kernel
// builds (2b, 2b) window factors of the chain on the host and applies
// them as MXU matmuls, O(rows n b) flops. In f32 on Hopper (TF32 off)
// those products buy no tensor cores, so this kernel streams the chain
// instead: O(rows n) work, 6 flops per element.
//
// Bound on an H100: bytes. Z is read once and the output written once
// (at n = 2048, 2 x 16.8 MB). Each row's chain is a sequential
// recurrence, so the parallelism is one lane per row; a block of four
// warps owns RB = 32 rows. Warp 0 walks the chain of its 32 rows over
// a tile of TW columns in shared memory while warps 1-3 load the next
// tile and store the previous tile's outputs (double-buffered), so
// global reads and writes coalesce along whichever axis of Z is
// contiguous (Z may be a transposed view: strides are arguments).
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn)
// in the plain version's order, so the result is bitwise that of
// givens_chain_apply_plain on the card.

#include <cuda_runtime.h>

namespace {

constexpr int RB = 32;          // rows per block, one compute lane each
constexpr int TW = 128;         // columns per tile
constexpr int LD = TW + 1;      // padded row pitch: conflict-free lanes
constexpr int THREADS = 128;    // warp 0 computes, warps 1-3 move tiles
constexpr size_t SMEM = sizeof(float) * 4 * RB * LD;

// Copy tile t of Z (rows r0.., columns t*TW..) into `buf`, thread `lt`
// of `nthr`; consecutive threads step along Z's contiguous axis.
__device__ void load_tile(const float* Z, long long sr, long long sk,
                          float* buf, int r0, int t, int rows, int n,
                          int lt, int nthr) {
    const int k0 = t * TW;
    const int kw = min(TW, n - k0);
    const bool kfast = sk == 1;
    for (int idx = lt; idx < RB * TW; idx += nthr) {
        const int rr = kfast ? idx / TW : idx % RB;
        const int cc = kfast ? idx % TW : idx / RB;
        if (r0 + rr < rows && cc < kw)
            buf[rr * LD + cc] = Z[(long long)(r0 + rr) * sr
                                  + (long long)(k0 + cc) * sk];
    }
}

// Store the outputs of tile t: buf index i holds column t*TW + i - 1.
__device__ void store_tile(float* O, long long sr, long long sk,
                           const float* buf, int r0, int t, int rows,
                           int n, int lt, int nthr) {
    const int k0 = t * TW;
    const int kw = min(TW, n - k0);
    const bool kfast = sk == 1;
    for (int idx = lt; idx < RB * TW; idx += nthr) {
        const int rr = kfast ? idx / TW : idx % RB;
        const int cc = kfast ? idx % TW : idx / RB;
        const int col = k0 + cc - 1;
        if (r0 + rr < rows && cc < kw && col >= 0)
            O[(long long)(r0 + rr) * sr + (long long)col * sk] =
                buf[rr * LD + cc];
    }
}

__global__ void __launch_bounds__(THREADS)
givens_chain_kernel(const float* Z, long long zsr, long long zsk, float* O,
                    long long osr, long long osk, const float* cs,
                    const float* sn, int rows, int n) {
    extern __shared__ float sm[];
    float* in[2] = {sm, sm + RB * LD};
    float* out[2] = {sm + 2 * RB * LD, sm + 3 * RB * LD};
    const int tid = threadIdx.x;
    const int r0 = blockIdx.x * RB;
    const int T = (n + TW - 1) / TW;
    load_tile(Z, zsr, zsk, in[0], r0, 0, rows, n, tid, THREADS);
    __syncthreads();
    float carry = 0.f;
    const bool live = tid < RB && r0 + tid < rows;
    for (int t = 0; t < T; ++t) {
        if (tid < 32) {
            if (live) {
                const float* src = in[t & 1] + tid * LD;
                float* dst = out[t & 1] + tid * LD;
                const int k0 = t * TW;
                const int kw = min(TW, n - k0);
                for (int i = 0; i < kw; ++i) {
                    const int j = k0 + i;
                    const float z = src[i];
                    if (j == 0) {
                        carry = z;
                        continue;
                    }
                    const float c = __ldg(cs + j - 1);
                    const float s = __ldg(sn + j - 1);
                    dst[i] = __fadd_rn(__fmul_rn(c, carry), __fmul_rn(s, z));
                    carry = __fadd_rn(__fmul_rn(-s, carry), __fmul_rn(c, z));
                }
            }
        } else {
            if (t + 1 < T)
                load_tile(Z, zsr, zsk, in[(t + 1) & 1], r0, t + 1, rows, n,
                          tid - 32, THREADS - 32);
            if (t >= 1)
                store_tile(O, osr, osk, out[(t - 1) & 1], r0, t - 1, rows,
                           n, tid - 32, THREADS - 32);
        }
        __syncthreads();
    }
    store_tile(O, osr, osk, out[(T - 1) & 1], r0, T - 1, rows, n, tid,
               THREADS);
    if (live)
        O[(long long)(r0 + tid) * osr + (long long)(n - 1) * osk] = carry;
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// O = Z @ G for Z (rows, n) f32 with element strides (zsr, zsk), O with
// (osr, osk); cs, sn the n-1 rotations; on `stream`.
int givens_chain(const float* Z, long long zsr, long long zsk, float* O,
                 long long osr, long long osk, const float* cs,
                 const float* sn, int rows, int n, void* stream) {
    if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
    const cudaError_t e = cudaFuncSetAttribute(
        givens_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    const int blocks = (rows + RB - 1) / RB;
    givens_chain_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
        Z, zsr, zsk, O, osr, osk, cs, sn, rows, n);
    return (int)cudaGetLastError();
}

}  // extern "C"

// Inverse of a lower-triangular block by forward substitution: the
// device work of ops/kernels.py trtri_lower.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_trtri_lower_pallas (n <=
// 512, n % 128 == 0, f32). Row j of X = inv(L) is
//   x_j = (e_j - L[j, :j] X[:j, :]) / L[j, j],
// the product accumulated in f32 with fmaf, a zero diagonal entry taken
// as 1, and no divide at all with a unit diagonal. Entries above the
// diagonal are 0.
//
// Bound on an H100: n^3 / 3 FLOPs, 44.7 MFLOP at n = 512, 0.67 us at
// the f32 rate (1 MB read, 1 MB written: 0.6 us). The substitution is a
// chain of n dependent rows, but the columns of X are independent:
// column c is x_jc = (delta_jc - sum_{c <= k < j} L_jk x_kc) / L_jj for
// j >= c. Design: one warp per column, so no grid barrier and no
// block barrier: the warp keeps its column in shared memory, its lanes
// split each row's dot product (reading L's row j on neighbouring
// addresses, shared by every warp through L1/L2) and reduce it with
// shuffles; eight warps a block. Not done: a block-level blocking of the
// substitution into matrix products.

#include <cuda_runtime.h>

namespace {

constexpr int TR_WARPS = 8;
constexpr int TR_MAX_N = 512;

__global__ void __launch_bounds__(TR_WARPS * 32)
trtri_lower_kernel(const float* __restrict__ L, float* __restrict__ X,
                   int n, int unit) {
    __shared__ float xs[TR_WARPS][TR_MAX_N];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int c = blockIdx.x * TR_WARPS + warp;
    if (c >= n) return;
    float* x = xs[warp];
    for (int j = c; j < n; ++j) {
        const float* lrow = L + (long)j * n;
        float p = 0.f;
        for (int k = c + lane; k < j; k += 32) p = fmaf(lrow[k], x[k], p);
        for (int off = 16; off > 0; off >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, off);
        float xj = __fsub_rn(j == c ? 1.f : 0.f, p);
        if (!unit) {
            const float ljj = lrow[j];
            xj = __fdiv_rn(xj, ljj == 0.f ? 1.f : ljj);
        }
        if (lane == 0) {
            x[j] = xj;
            X[(long)j * n + c] = xj;
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// X = inv(L) for the (n, n) row-major f32 lower triangle L, n <= 512;
// X must hold zeros (the entries above the diagonal are not written).
int trtri_lower(const float* L, float* X, int n, int unit, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    if (n > TR_MAX_N) return (int)cudaErrorInvalidValue;
    trtri_lower_kernel<<<(n + TR_WARPS - 1) / TR_WARPS, TR_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(L, X, n, unit);
    return (int)cudaGetLastError();
}

}  // extern "C"

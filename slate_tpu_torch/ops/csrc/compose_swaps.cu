// Compose a sequence of row swaps into one permutation, on the card:
// perm = range(m), then for j = 0 .. w-1 in order, swap perm[j] and
// perm[piv[j]]; for a (batch, w) stack of swap sequences, each row on
// its own. The device work of ops/kernels.py lu_pivots_to_permutation
// for CUDA tensors.
//
// Replaces no Pallas kernel: it is the port of XLA's builtin
// lu_pivots_to_permutation, which the reference calls at
// slate_tpu/linalg/lu.py:63 and ops/pallas_kernels.py:656,663, and
// vmapped over a batch in slate_tpu/batch/drivers.py:389-398 (the
// ragged gesv's pivot application). Without it the port copied the
// pivots to the host and swapped in Python, one host synchronisation
// per panel.
//
// Bound on an H100: latency. The swaps are a sequential chain (a later
// swap may touch what an earlier one moved), so one thread walks them;
// the bytes (w int32 in, m int64 out) take well under a microsecond.
// Design: ONE block per sequence. Its threads stage the pivots and
// the identity in shared memory (int32; m = 16384 is 64 KB), one
// thread walks the w swaps there, and all threads write the
// permutation out once as int64, the index type torch gathers take. An
// index array too large for shared memory is composed the same way in
// the output buffer.
// Targets outside [0, m) are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int CS_THREADS = 1024;
constexpr size_t CS_SMEM_MAX = 200 * 1024;

__global__ void __launch_bounds__(CS_THREADS)
compose_swaps_kernel(const int* piv_all, int w, int m, long long* perm_all,
                     int in_smem) {
    extern __shared__ int sm[];
    const int tid = threadIdx.x;
    const int* piv = piv_all + (long)blockIdx.x * w;
    long long* perm = perm_all + (long)blockIdx.x * m;
    const int nsw = min(w, m);
    if (in_smem) {
        int* p = sm;                 // m entries
        int* t = sm + m;             // nsw swap targets
        for (int i = tid; i < m; i += CS_THREADS) p[i] = i;
        for (int j = tid; j < nsw; j += CS_THREADS) t[j] = piv[j];
        __syncthreads();
        if (tid == 0)
            for (int j = 0; j < nsw; ++j) {
                const int k = t[j];
                if (k < 0 || k >= m) continue;
                const int pj = p[j];
                p[j] = p[k];
                p[k] = pj;
            }
        __syncthreads();
        for (int i = tid; i < m; i += CS_THREADS) perm[i] = p[i];
        return;
    }
    for (int i = tid; i < m; i += CS_THREADS) perm[i] = i;
    __syncthreads();
    if (tid == 0)
        for (int j = 0; j < nsw; ++j) {
            const int k = piv[j];
            if (k < 0 || k >= m) continue;
            const long long pj = perm[j];
            perm[j] = perm[k];
            perm[k] = pj;
        }
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// perm (batch, m) int64 from piv (batch, w) int32, on `stream`.
int compose_swaps(const int* piv, int batch, int w, int m, long long* perm,
                  void* stream) {
    if (m <= 0 || batch <= 0) return (int)cudaGetLastError();
    const size_t smem = sizeof(int) * ((size_t)m + (size_t)min(w, m));
    const int in_smem = smem <= CS_SMEM_MAX;
    const size_t dyn = in_smem ? smem : 0;
    if (dyn > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            compose_swaps_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    compose_swaps_kernel<<<batch, CS_THREADS, dyn, (cudaStream_t)stream>>>(
        piv, w, m, perm, in_smem);
    return (int)cudaGetLastError();
}

}  // extern "C"

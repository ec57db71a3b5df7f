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
// Bound on an H100: latency (the bytes, w int32 in and m int64 out,
// take well under a microsecond). Walked in order the swaps are a
// chain of w dependent steps, so the design avoids the walk where it
// can. Every caller passes an LU swap sequence, piv[j] >= j. Then
// position j is final after swap j, and with v(j) the value at
// position j just before swap j:
//   - perm[j] is the value at piv[j] just before swap j: v(i) for the
//     last earlier swap i that also targeted piv[j], else piv[j]
//     itself;
//   - v(j) is v(i) for the last swap i < j that targeted j, else j:
//     a forest over the steps, whose roots are the values;
//   - a row p >= w holds v(i) of the last swap that targeted it, else
//     p.
// So one block per sequence sorts the (target, step) pairs (a bitonic
// sort in shared memory, its short strides in registers across a
// warp), links each step to its target's and its own position's
// previous swap, resolves the forest by pointer jumping (log2 of its
// depth rounds) and writes the w final rows and the targets past w.
// Other blocks write the identity rows past w that no swap targets,
// each over its own span of rows, so the output is written by many
// SMs. A sequence that is not of that form (a target below its step or
// outside [0, m)), found by a check over the block, is walked in order
// by one thread of the same block, with XLA's semantics: a negative
// target counts from the end, a target still outside [0, m) reads the
// nearest row and is not written. That walk runs in shared memory, or
// in the output where m rows do not fit.

#include <cuda_runtime.h>

namespace {

constexpr int CS_THREADS = 1024;
constexpr int CS_WARPS = CS_THREADS / 32;
// longest sequence the sort takes (its keys and links: 8 w bytes of
// shared memory at most)
constexpr int CS_SORT_MAX_W = 16384;
// most rows plus swap targets the in-order walk keeps in shared memory
constexpr int CS_WALK_SMEM = 49152;
// identity rows a filling block writes
constexpr int CS_FILL_SPAN = 2048;
constexpr unsigned CS_PAD = 0xffffffffu;
constexpr unsigned FULL = 0xffffffffu;

// A target as XLA reads it: negative counts from the end.
__device__ __forceinline__ int wrap(int t, int m) { return t < 0 ? t + m : t; }

// Stages k in [k_lo, k_hi] (strides min(k/2, 32) .. 1) of the bitonic
// sort of s[0, P) on 64-key windows held two a lane in registers.
__device__ void window_stages(unsigned* s, int P, int k_lo, int k_hi) {
    const int lane = threadIdx.x & 31;
    for (int base = (threadIdx.x >> 5) * 64; base < P; base += CS_WARPS * 64) {
        const int ia = base + lane, ib = ia + 32;
        unsigned a = s[ia], b = s[ib];
        for (int k = k_lo; k <= k_hi; k <<= 1) {
            for (int j = min(k >> 1, 32); j > 0; j >>= 1) {
                if (j == 32) {
                    const bool asc = (ia & k) == 0;
                    if ((a > b) == asc) {
                        const unsigned t = a;
                        a = b;
                        b = t;
                    }
                } else {
                    const unsigned pa = __shfl_xor_sync(FULL, a, j);
                    const unsigned pb = __shfl_xor_sync(FULL, b, j);
                    const bool lo = (lane & j) == 0;
                    a = (lo == ((ia & k) == 0)) ? min(a, pa) : max(a, pa);
                    b = (lo == ((ib & k) == 0)) ? min(b, pb) : max(b, pb);
                }
            }
        }
        s[ia] = a;
        s[ib] = b;
    }
}

// Ascending bitonic sort of s[0, P), P a power of two >= 64, by the
// whole block; strides of 64 and more through shared memory.
__device__ void block_sort(unsigned* s, int P) {
    window_stages(s, P, 2, 64);
    __syncthreads();
    for (int k = 128; k <= P; k <<= 1) {
        for (int j = k >> 1; j >= 64; j >>= 1) {
            for (int q = threadIdx.x; q < P / 2; q += CS_THREADS) {
                const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
                const unsigned a = s[i], b = s[i + j];
                if ((a > b) == ((i & k) == 0)) {
                    s[i] = b;
                    s[i + j] = a;
                }
            }
            __syncthreads();
        }
        window_stages(s, P, k, k);
        __syncthreads();
    }
}

// The LU-sequence composition of one sequence (piv[j] >= j, all below
// m), keys (target << kb | step) in s[0, P), links in r[0, w).
__device__ void compose_sorted(unsigned* s, int* r, int P, int w, int kb,
                               long long* perm) {
    const unsigned mask = (1u << kb) - 1;
    for (int j = threadIdx.x; j < w; j += CS_THREADS) r[j] = -1;
    block_sort(s, P);
    // r[x] = the last swap before step x that targeted row x (-1: none)
    for (int k = threadIdx.x; k < w; k += CS_THREADS) {
        const unsigned key = s[k];
        const int x = (int)(key >> kb), i = (int)(key & mask);
        if (x >= w) continue;
        const bool same = k > 0 && (s[k - 1] >> kb) == (unsigned)x;
        const bool last = k + 1 == w || (s[k + 1] >> kb) != (unsigned)x;
        if (i == x)
            r[x] = same ? (int)(s[k - 1] & mask) : -1;
        else if (last)
            r[x] = i;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < w; j += CS_THREADS)
        if (r[j] < 0) r[j] = j;
    __syncthreads();
    // pointer jumping to the roots: r[j] = v(j)
    for (;;) {
        int changed = 0;
        for (int j = threadIdx.x; j < w; j += CS_THREADS) {
            const int a = r[j], b = r[a];
            if (a != b) {
                r[j] = b;
                changed = 1;
            }
        }
        if (!__syncthreads_or(changed)) break;
    }
    for (int k = threadIdx.x; k < w; k += CS_THREADS) {
        const unsigned key = s[k];
        const int x = (int)(key >> kb), i = (int)(key & mask);
        const bool same = k > 0 && (s[k - 1] >> kb) == (unsigned)x;
        perm[i] = same ? r[s[k - 1] & mask] : x;
        if (x >= w && (k + 1 == w || (s[k + 1] >> kb) != (unsigned)x))
            perm[x] = r[i];
    }
}

// Any sequence, in order by one thread, XLA's semantics. Writes rows
// [0, w) and the in-range targets; reads only those and row m-1. With
// sp, the rows (m) and the wrapped targets (w) sit in shared memory.
__device__ void compose_walk(const int* piv, int w, int m, int* sp,
                             long long* perm) {
    const int tid = threadIdx.x;
    if (sp) {
        int* tt = sp + m;
        for (int p = tid; p < m; p += CS_THREADS) sp[p] = p;
        for (int j = tid; j < w; j += CS_THREADS) tt[j] = wrap(piv[j], m);
        __syncthreads();
        if (tid == 0)
            for (int j = 0; j < w; ++j) {
                const int t = tt[j];
                const int x = sp[j];
                sp[j] = sp[min(max(t, 0), m - 1)];
                if (t >= 0 && t < m) sp[t] = x;
            }
        __syncthreads();
        for (int j = tid; j < w; j += CS_THREADS) {
            perm[j] = sp[j];
            const int t = tt[j];
            if (t >= w && t < m) perm[t] = sp[t];
        }
        return;
    }
    // in the output: rows [0, w) and the targets start as the identity;
    // row m-1 is read as itself unless this block owns it
    int owns_last = m - 1 < w;
    for (int j = tid; j < w; j += CS_THREADS) {
        perm[j] = j;
        const int t = wrap(piv[j], m);
        if (t >= w && t < m) perm[t] = t;
        owns_last |= t == m - 1;
    }
    owns_last = __syncthreads_or(owns_last);
    if (tid == 0)
        for (int j0 = 0; j0 < w; j0 += 8) {
            int tv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                tv[u] = j0 + u < w ? wrap(__ldg(piv + j0 + u), m) : 0;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int j = j0 + u, t = tv[u];
                if (j >= w) break;
                const int c = min(max(t, 0), m - 1);
                const long long x = perm[j];
                perm[j] = (c == m - 1 && !owns_last) ? (long long)c : perm[c];
                if (t >= 0 && t < m) perm[t] = x;
            }
        }
}

// Block 0 of each sequence composes; blocks 1.. write the identity on
// their span of rows past w, except the rows some swap targets.
__global__ void __launch_bounds__(CS_THREADS)
compose_swaps_kernel(const int* piv_all, int w, int m, long long* perm_all,
                     int sort_ok, int kb, int P, int walk_in_smem) {
    extern __shared__ unsigned sm[];
    __shared__ unsigned flags[CS_FILL_SPAN / 32];
    const int tid = threadIdx.x;
    const int* piv = piv_all + (long)blockIdx.y * w;
    long long* perm = perm_all + (long)blockIdx.y * m;
    if (blockIdx.x > 0) {
        const int lo = w + (blockIdx.x - 1) * CS_FILL_SPAN;
        const int hi = min(m, lo + CS_FILL_SPAN);
        for (int q = tid; q < CS_FILL_SPAN / 32; q += CS_THREADS) flags[q] = 0;
        __syncthreads();
        for (int j = tid; j < w; j += CS_THREADS) {
            const int t = wrap(piv[j], m);
            if (t >= lo && t < hi)
                atomicOr(&flags[(t - lo) >> 5], 1u << ((t - lo) & 31));
        }
        __syncthreads();
        for (int p = lo + tid; p < hi; p += CS_THREADS)
            if (!((flags[(p - lo) >> 5] >> ((p - lo) & 31)) & 1u)) perm[p] = p;
        return;
    }
    if (w == 0) return;
    int ok = sort_ok;
    if (sort_ok) {
        for (int j = tid; j < P; j += CS_THREADS) {
            unsigned key = CS_PAD;
            if (j < w) {
                const int t = piv[j];
                ok &= t >= j && t < m;
                key = ((unsigned)t << kb) | (unsigned)j;
            }
            sm[j] = key;
        }
        ok = __syncthreads_and(ok);
    }
    if (ok) {
        compose_sorted(sm, (int*)(sm + P), P, w, kb, perm);
        return;
    }
    compose_walk(piv, w, m, walk_in_smem ? (int*)sm : nullptr, perm);
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// perm (batch, m) int64 from piv (batch, w) int32, on `stream`; w <= m
// (XLA's lu_pivots_to_permutation raises otherwise).
int compose_swaps(const int* piv, int batch, int w, int m, long long* perm,
                  void* stream) {
    if (w < 0 || m < 0 || batch < 0 || w > m) return (int)cudaErrorInvalidValue;
    if (m == 0 || batch == 0) return (int)cudaGetLastError();
    int kb = 0;
    while ((1 << kb) < w) ++kb;
    int P = 64;
    while (P < w) P <<= 1;
    const int sort_ok = w <= CS_SORT_MAX_W
                        && ((unsigned long long)m << kb) < (1ull << 32);
    const int walk_in_smem = (long long)m + w <= CS_WALK_SMEM;
    size_t dyn = sort_ok ? sizeof(unsigned) * ((size_t)P + w) : 0;
    const size_t walk = sizeof(int) * ((size_t)m + w);
    if (walk_in_smem && walk > dyn) dyn = walk;
    // the opt-in is needed once dynamic plus static shared memory (the
    // fill flags) pass the default 48 KiB, and must not rest on an
    // earlier, larger call having raised the attribute
    if (dyn + sizeof(unsigned) * (CS_FILL_SPAN / 32) > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            compose_swaps_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
    }
    const int fill = (m - w + CS_FILL_SPAN - 1) / CS_FILL_SPAN;
    for (int b0 = 0; b0 < batch; b0 += 65535) {
        const dim3 grid(1 + fill, min(batch - b0, 65535));
        compose_swaps_kernel<<<grid, CS_THREADS, dyn, (cudaStream_t)stream>>>(
            piv + (long)b0 * w, w, m, perm + (long)b0 * m, sort_ok, kb, P,
            walk_in_smem);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"

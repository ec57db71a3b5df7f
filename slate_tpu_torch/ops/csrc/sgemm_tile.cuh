// Register-tiled f32 GEMM-with-subtract on the CUDA cores, with the K
// slabs staged in shared memory by cp.async: D = T(C - T(A * op(B))).
//
// The f32 product of the port's redesigned kernels: the f32 trailing
// update of the tall-panel split (rank_update.cu, 128 x 128 tiles) and
// the trailing update of the Cholesky block (chol_panel.cu, 64 x 64
// tiles, op(B) = B^T).
//
// Bound on an H100: f32 FLOPs at 67 TFLOP/s (TF32 is off, so the tensor
// cores cannot take the products exactly). Design: a BM x BN output tile
// per block of 256 threads, each thread a (BM/16) x (BN/16) register
// block, its rows and columns in runs of 4 (ty * 4 + 64 h), so each
// k-step reads A and B with 16-byte shared loads (LDS.128) that the
// threads of a warp share or spread over distinct banks; BK = 16-deep K
// slabs in a ring of shared buffers (3 deep by default), filled by cp.async
// (4-byte copies that transpose A (and B^T) into k-major rows; 16-byte
// copies of B's rows where the columns are 16-byte aligned) while the
// block computes on the slab before, zero-filled past the edges, so any
// M, N, K is taken. f32 operands only take the cp.async path; the
// generic path (bf16 storage, the rank update's odd shapes) loads
// through registers into the same ring. The products accumulate in f32
// in k order by fmaf; the sum is rounded to T once and subtracted once,
// as the reference's `a - P.astype(a.dtype)`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace slate_torch {

constexpr int SG_THREADS = 256;
constexpr int SG_BK = 16;
constexpr int SG_STAGES = 3;

// Dynamic shared memory of one block of a BM x BN tile.
__host__ __device__ constexpr int sg_smem_bytes(int BM, int BN,
                                                int stages = SG_STAGES) {
    return stages * SG_BK * (BM + 4 + BN + 4) * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One slab [k0, k0 + SG_BK) of A (rows row0 ...) and op(B) (columns
// col0 ...) into the k-major shared rows As[k][BM + 4], Bs[k][BN + 4].
// ASYNC: f32 operands through cp.async; VECB: B's rows in 16-byte
// chunks (N % 4 == 0, 16-byte aligned rows, !BT).
template <typename T, int BM, int BN, bool BT, bool ASYNC, bool VECB>
__device__ __forceinline__ void
sg_load_slab(float* As, float* Bs, const T* A, long lda, const T* B,
             long ldb, int M, int N, int K, int row0, int col0, int k0) {
    constexpr int LDA = BM + 4, LDB = BN + 4;
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < BM * SG_BK / SG_THREADS; ++i) {
        const int e = i * SG_THREADS + tid;
        const int r = e / SG_BK, k = e % SG_BK;
        const int gr = row0 + r, gk = k0 + k;
        const bool in = gr < M && gk < K;
        if constexpr (ASYNC) {
            cp_async4(As + k * LDA + r,
                      (const float*)A + (in ? (long)gr * lda + gk : 0), in);
        } else {
            As[k * LDA + r] = in ? to_f(A[(long)gr * lda + gk]) : 0.f;
        }
    }
    if constexpr (BT) {
        // op(B)[k][c] = B[c][k]: neighbouring threads on neighbouring k
#pragma unroll
        for (int i = 0; i < BN * SG_BK / SG_THREADS; ++i) {
            const int e = i * SG_THREADS + tid;
            const int c = e / SG_BK, k = e % SG_BK;
            const int gc = col0 + c, gk = k0 + k;
            const bool in = gc < N && gk < K;
            if constexpr (ASYNC) {
                cp_async4(Bs + k * LDB + c,
                          (const float*)B + (in ? (long)gc * ldb + gk : 0),
                          in);
            } else {
                Bs[k * LDB + c] = in ? to_f(B[(long)gc * ldb + gk]) : 0.f;
            }
        }
    } else if constexpr (VECB) {
#pragma unroll
        for (int i = 0; i < BN * SG_BK / 4 / SG_THREADS; ++i) {
            const int e = i * SG_THREADS + tid;
            const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
            const int gk = k0 + k, gc = col0 + c;
            const bool in = gk < K && gc < N;
            cp_async16(Bs + k * LDB + c,
                       (const float*)B + (in ? (long)gk * ldb + gc : 0), in);
        }
    } else {
#pragma unroll
        for (int i = 0; i < BN * SG_BK / SG_THREADS; ++i) {
            const int e = i * SG_THREADS + tid;
            const int k = e / BN, c = e % BN;
            const int gk = k0 + k, gc = col0 + c;
            const bool in = gk < K && gc < N;
            if constexpr (ASYNC) {
                cp_async4(Bs + k * LDB + c,
                          (const float*)B + (in ? (long)gk * ldb + gc : 0),
                          in);
            } else {
                Bs[k * LDB + c] = in ? to_f(B[(long)gk * ldb + gc]) : 0.f;
            }
        }
    }
}

// The BM x BN tile of D at (row0, col0) by the SG_THREADS threads of
// the calling block, `smem` holding sg_smem_bytes(BM, BN). D may alias C
// (each element is read, then written, by one thread); A and B must not
// overlap D. VEC: the 16-byte path (f32, N % 4 == 0 and 16-byte aligned
// rows of B, C and D). STAGES: the ring's depth (K / SG_BK + 1 puts
// every slab of a short K in flight at once).
template <typename T, int BM, int BN, bool BT, bool VEC,
          int STAGES = SG_STAGES>
__device__ __forceinline__ void
sgemm_sub_tile(float* smem, const T* C, long ldc, const T* A, long lda,
               const T* B, long ldb, T* D, long ldd, int M, int N, int K,
               int row0, int col0) {
    constexpr int TM = BM / 16, TN = BN / 16;
    constexpr int LDA = BM + 4, LDB = BN + 4;
    constexpr int STAGE = SG_BK * (LDA + LDB);
    constexpr bool ASYNC = sizeof(T) == 4;
    constexpr bool VECB = VEC && !BT;
    static_assert(TM % 4 == 0 && TN % 4 == 0, "tiles of 64 or 128");
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int nk = (K + SG_BK - 1) / SG_BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            sg_load_slab<T, BM, BN, BT, ASYNC, VECB>(
                smem + s * STAGE, smem + s * STAGE + SG_BK * LDA, A, lda, B,
                ldb, M, N, K, row0, col0, s * SG_BK);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        // slab kt has landed (this thread's copies), then every thread's
        // copies are visible and every thread is done with slab kt - 1,
        // whose buffer the next load refills
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = kt + STAGES - 1;
        if (nxt < nk) {
            float* st = smem + (nxt % STAGES) * STAGE;
            sg_load_slab<T, BM, BN, BT, ASYNC, VECB>(
                st, st + SG_BK * LDA, A, lda, B, ldb, M, N, K, row0, col0,
                nxt * SG_BK);
        }
        cp_async_commit();
        const float* As = smem + (kt % STAGES) * STAGE;
        const float* Bs = As + SG_BK * LDA;
#pragma unroll
        for (int kk = 0; kk < SG_BK; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int h = 0; h < TM / 4; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(
                    As + kk * LDA + ty * 4 + 64 * h);
                a[4 * h] = v.x; a[4 * h + 1] = v.y;
                a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int h = 0; h < TN / 4; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(
                    Bs + kk * LDB + tx * 4 + 64 * h);
                b[4 * h] = v.x; b[4 * h + 1] = v.y;
                b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();      // the ring is free for the caller's next tile

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * 4 + 64 * (i / 4) + i % 4;
        if (r >= M) continue;
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
            const int c = col0 + tx * 4 + 64 * h;
            if constexpr (VEC) {
                if (c < N) {
                    const float4 cv = *reinterpret_cast<const float4*>(
                        (const float*)C + (long)r * ldc + c);
                    float4 dv;
                    dv.x = __fsub_rn(cv.x, acc[i][4 * h]);
                    dv.y = __fsub_rn(cv.y, acc[i][4 * h + 1]);
                    dv.z = __fsub_rn(cv.z, acc[i][4 * h + 2]);
                    dv.w = __fsub_rn(cv.w, acc[i][4 * h + 3]);
                    *reinterpret_cast<float4*>((float*)D + (long)r * ldd + c)
                        = dv;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (c + q < N)
                        D[(long)r * ldd + c + q] = from_f<T>(__fsub_rn(
                            to_f(C[(long)r * ldc + c + q]),
                            rnd<T>(acc[i][4 * h + q])));
            }
        }
    }
}

}  // namespace slate_torch

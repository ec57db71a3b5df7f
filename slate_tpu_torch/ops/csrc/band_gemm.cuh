// The 32 x 32 split-K product of the blocked substitutions
// (trtri_lower.cu, ragged_potrf.cu): P = A B^T for a 32-row band A and
// 32 rows B, both held k-contiguous in shared memory, summed in f32.
//
// The eight warps of a 256-thread block split K. Each warp accumulates
// the whole 32 x 32 tile over its slice: lane (ty, tx) = (lane / 8,
// lane % 8) owns rows ty + 4 i (i < 8) and columns tx + 8 j (j < 4),
// and reads four consecutive k of each of its rows and columns with one
// 16-byte (f32) or 8-byte (bf16) shared load. With a row pitch of 4
// words mod 32 the eight distinct rows of a load fall on distinct banks,
// so every load is one wavefront: 12 loads feed 128 FMAs. The partials
// meet in shared memory (bg_store_partial) and are summed in warp order
// (bg_sum). Products of bf16 values are exact in f32; every product is
// accumulated in k order by fmaf within a warp's slice.
//
// Also the divide both substitutions put on their chains (div_rn).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace slate_torch {

constexpr int BG_THREADS = 256;
constexpr int BG_WARPS = BG_THREADS / 32;
// padded row of a warp's 32 x 32 partial: lanes (ty, tx) store to banks
// 8 ty + tx, all distinct
constexpr int BG_RED_LD = 40;
constexpr int BG_RED_FLOATS = BG_WARPS * 32 * BG_RED_LD;

// 16 bytes into shared memory through L2 only (data other blocks wrote
// is never served stale from L1): `bytes` (0, 4, ..., 16) of them from
// src, the rest zero.
__device__ __forceinline__ void bg_cp16(void* dst, const void* src,
                                        int bytes) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes (or a zero when !in) into shared memory.
__device__ __forceinline__ void bg_cp4(float* dst, const float* src,
                                       bool in) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void bg_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bg_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four consecutive values of a shared row, as f32.
__device__ __forceinline__ float4 bg_ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 bg_ld4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
}

// acc[i][j] += sum_{k0 <= k < k1} A[ty + 4 i][k] B[tx + 8 j][k], by one
// warp; lda and ldb in elements, k0 and k1 multiples of 4.
template <typename T>
__device__ __forceinline__ void bg_mac(float (&acc)[8][4], const T* A,
                                       int lda, const T* B, int ldb, int k0,
                                       int k1) {
    const int lane = threadIdx.x & 31;
    const T* a = A + (lane >> 3) * lda;
    const T* b = B + (lane & 7) * ldb;
#pragma unroll 2
    for (int k = k0; k < k1; k += 4) {
        float4 av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = bg_ld4(a + 4 * i * lda + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bg_ld4(b + 8 * j * ldb + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float s = acc[i][j];
                s = fmaf(av[i].x, bv[j].x, s);
                s = fmaf(av[i].y, bv[j].y, s);
                s = fmaf(av[i].z, bv[j].z, s);
                acc[i][j] = fmaf(av[i].w, bv[j].w, s);
            }
    }
}

// This warp's partial into slab `slot` (32 x BG_RED_LD) of `red`.
__device__ __forceinline__ void bg_store_partial(const float (&acc)[8][4],
                                                 float* red, int slot) {
    const int lane = threadIdx.x & 31;
    float* p = red + slot * 32 * BG_RED_LD + (lane >> 3) * BG_RED_LD
        + (lane & 7);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[4 * i * BG_RED_LD + 8 * j] = acc[i][j];
}

// This warp's partial into the slab of its own index.
__device__ __forceinline__ void bg_store_partial(const float (&acc)[8][4],
                                                 float* red) {
    bg_store_partial(acc, red, threadIdx.x >> 5);
}

// P[r][c]: the first `parts` partials summed in slot order.
__device__ __forceinline__ float bg_sum(const float* red, int r, int c,
                                        int parts = BG_WARPS) {
    const float* p = red + r * BG_RED_LD + c;
    float s = p[0];
#pragma unroll
    for (int w = 1; w < parts; ++w) s += p[w * 32 * BG_RED_LD];
    return s;
}

// Division through a reciprocal: RN(x / d) from r = rcp_rn(d) = RN(1 / d)
// by one correction (Markstein), which is exact while x, d and the
// quotient stay well inside the normal range; elsewhere (or r == 0, the
// mark of a d outside it) the IEEE divide. The reciprocals are taken
// off the chain, so a step of it costs a multiply and two FMAs.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
    float q = __fmul_rn(x, r);
    q = fmaf(fmaf(-q, d, x), r, q);
    if (x != 0.f && !(fabsf(q) >= 0x1p-120f && fabsf(q) <= 0x1p120f))
        q = __fdiv_rn(x, d);
    return q;
}

__device__ __forceinline__ float rcp_rn(float d) {
    const float a = fabsf(d);
    return a >= 0x1p-120f && a <= 0x1p120f ? __frcp_rn(d) : 0.f;
}

}  // namespace slate_torch

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
// Bound on an H100: the larger of two. Bytes: Z read once and the
// output written once (2 x 16.8 MB at n = 2048: 10 us at 3.35 TB/s).
// Latency: each row's chain is n-1 dependent steps of one multiply and
// one add, rounded one at a time (the result is bitwise the plain
// version's, so no segmented scan), ~8 cycles a step: ~9.4 us at
// n = 2048, ~2.3 us at 512. The parallelism is the rows.
//
// Design: RB rows a block (8, 16 or 32: the host picks it so that the
// blocks cover the SMs), one lane of the computing warp a row, and a
// second warp that only moves data. The block's band of Z streams
// through a ring of STAGES chunks of TW = 32 columns in shared memory,
// loaded by the Tensor Memory Accelerator (one 2D box of Z and two 1D
// boxes of the chunk's c and s per chunk, completing on one "full"
// mbarrier), so up to STAGES chunks are in flight per SM with no
// registers or instructions spent on the copy. A
// 2D tensor map takes either stride order: a row-major Z loads as
// (RB rows x 128 bytes) boxes in the 128-byte swizzle (a lane reads
// its row as eight conflict-free 16-byte loads), a transposed view
// (bdsqr applies its right chain to Gvh^T) as (32 columns x RB rows)
// boxes that lanes read as consecutive words. Chunk t computes the
// outputs of its own columns (its last step reads the first column of
// chunk t+1), in place in the chunk's buffer, the 2 x 32 products of z
// first and then the chain of the carry (two dependent operations a
// step), and arrives on the slot's "done" mbarrier; the data warp then
// stores the chunk by TMA and refills the slot once the store has read
// it, so the computing warp never waits on a store (clock64 marks on
// the card: a warp doing both spent ~220 of ~1070 cycles a chunk on
// them). The host path sets the shared memory attribute once per
// kernel and builds the four tensor maps per call.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using namespace slate_torch;

constexpr int TW = 32;          // columns a chunk: 128 bytes of f32
constexpr int STAGES = 16;      // chunks of the ring

template <int RB>
constexpr int smem_bytes() {
    return 1024 + STAGES * (RB * TW + 2 * TW) * 4 + 2 * STAGES * 8;
}

// Float index of (row r, chunk column i) in a chunk buffer: KMAJ (Z
// row-major) rows of 128 bytes in the 128-byte swizzle (16-byte unit q
// of row r at q ^ (r & 7)); else (a transposed view) column-major
// [TW][RB].
template <int RB, bool KMAJ>
__device__ __forceinline__ int at(int r, int i) {
    return KMAJ ? r * TW + ((((i >> 2) ^ (r & 7))) << 2) + (i & 3)
                : i * RB + r;
}

__device__ __forceinline__ float rot_out(float c, float s, float t,
                                         float z) {
    return __fadd_rn(__fmul_rn(c, t), __fmul_rn(s, z));
}

__device__ __forceinline__ float rot_carry(float c, float s, float t,
                                           float z) {
    return __fadd_rn(__fmul_rn(-s, t), __fmul_rn(c, z));
}

// Chunk t of Z and its rotations into ring slot t % STAGES (one thread).
template <int RB, bool KMAJ>
__device__ __forceinline__ void issue(int t, int r0, float* zb, float* cb,
                                      float* sb, uint64_t* full,
                                      const CUtensorMap* mz,
                                      const CUtensorMap* mc,
                                      const CUtensorMap* ms) {
    constexpr int BYTES = (RB * TW + 2 * TW) * 4;
    const int slot = t % STAGES;
    const uint32_t bar = smem_u32(&full[slot]);
    mbar_expect_tx(bar, BYTES);
    tma_load_2d(smem_u32(zb + slot * RB * TW), mz, KMAJ ? t * TW : r0,
                KMAJ ? r0 : t * TW, bar);
    tma_load_1d(smem_u32(cb + slot * TW), mc, t * TW, bar);
    tma_load_1d(smem_u32(sb + slot * TW), ms, t * TW, bar);
}

template <int RB, bool KMAJ>
__global__ void __launch_bounds__(64)
givens_chain_tma(const __grid_constant__ CUtensorMap mz,
                 const __grid_constant__ CUtensorMap mo,
                 const __grid_constant__ CUtensorMap mc,
                 const __grid_constant__ CUtensorMap ms, int n) {
    // the ring 1024-byte aligned (the 128-byte swizzle's period), by an
    // offset from the shared array itself: the compiler then keeps the
    // shared address space (LDS, not generic loads in the chain)
    extern __shared__ uint8_t gc_raw[];
    float* zb = reinterpret_cast<float*>(
        gc_raw + ((1024u - (smem_u32(gc_raw) & 1023u)) & 1023u));
    float* cb = zb + STAGES * RB * TW;
    float* sb = cb + STAGES * TW;
    uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * TW);
    uint64_t* done = full + STAGES;
    const int lane = threadIdx.x & 31;
    const int r0 = blockIdx.x * RB;
    const int T = (n + TW - 1) / TW;

    if (threadIdx.x == 32) {
        prefetch_map(&mz);
        prefetch_map(&mo);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1);
            mbar_init(smem_u32(&done[s]), 1);
        }
        mbar_init_fence();
        for (int t = 0; t < T && t < STAGES; ++t)
            issue<RB, KMAJ>(t, r0, zb, cb, sb, full, &mz, &mc, &ms);
    }
    __syncthreads();
    if (threadIdx.x >= 32) {
        // the producer: store each finished chunk, then refill its slot
        if (threadIdx.x == 32) {
            for (int t = 0; t < T; ++t) {
                mbar_wait(smem_u32(&done[t % STAGES]), (t / STAGES) & 1);
                tma_store_2d(&mo, KMAJ ? t * TW : r0, KMAJ ? r0 : t * TW,
                             smem_u32(zb + (t % STAGES) * RB * TW));
                tma_commit();
                if (t + STAGES < T) {
                    tma_wait_read<0>();
                    issue<RB, KMAJ>(t + STAGES, r0, zb, cb, sb, full, &mz,
                                    &mc, &ms);
                }
            }
            tma_wait<0>();
        }
        return;
    }

    mbar_wait(smem_u32(&full[0]), 0);
    const bool live = lane < RB;
    float carry = live ? zb[at<RB, KMAJ>(lane, 0)] : 0.f;
    for (int t = 0; t < T; ++t) {
        const int slot = t % STAGES;
        const bool last = t == T - 1;
        if (!last)
            mbar_wait(smem_u32(&full[(t + 1) % STAGES]),
                      ((t + 1) / STAGES) & 1);
        float* zs = zb + slot * RB * TW;
        const float* cc = cb + slot * TW;
        const float* ss = sb + slot * TW;
        if (live) {
            if (!last) {
                // all TW steps: outputs of columns t*TW .. t*TW + TW-1
                float z[TW + 1], c[TW], s[TW];
                if (KMAJ) {
#pragma unroll
                    for (int q = 0; q < TW / 4; ++q) {
                        const float4 v = *reinterpret_cast<const float4*>(
                            zs + at<RB, KMAJ>(lane, 4 * q));
                        z[4 * q] = v.x; z[4 * q + 1] = v.y;
                        z[4 * q + 2] = v.z; z[4 * q + 3] = v.w;
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < TW; ++i) z[i] = zs[at<RB, KMAJ>(lane, i)];
                }
                z[TW] = zb[((t + 1) % STAGES) * RB * TW + at<RB, KMAJ>(lane, 0)];
#pragma unroll
                for (int q = 0; q < TW / 4; ++q) {
                    const float4 cv = reinterpret_cast<const float4*>(cc)[q];
                    const float4 sv = reinterpret_cast<const float4*>(ss)[q];
                    c[4 * q] = cv.x; c[4 * q + 1] = cv.y;
                    c[4 * q + 2] = cv.z; c[4 * q + 3] = cv.w;
                    s[4 * q] = sv.x; s[4 * q + 1] = sv.y;
                    s[4 * q + 2] = sv.z; s[4 * q + 3] = sv.w;
                }
                // the products of z, off the carry's chain, first
                float cz[TW], sz[TW], o[TW];
#pragma unroll
                for (int i = 0; i < TW; ++i) {
                    cz[i] = __fmul_rn(c[i], z[i + 1]);
                    sz[i] = __fmul_rn(s[i], z[i + 1]);
                }
#pragma unroll
                for (int i = 0; i < TW; ++i) {
                    o[i] = __fadd_rn(__fmul_rn(c[i], carry), sz[i]);
                    carry = __fadd_rn(__fmul_rn(-s[i], carry), cz[i]);
                }
                if (KMAJ) {
#pragma unroll
                    for (int q = 0; q < TW / 4; ++q)
                        *reinterpret_cast<float4*>(
                            zs + at<RB, KMAJ>(lane, 4 * q)) =
                            make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                        o[4 * q + 3]);
                } else {
#pragma unroll
                    for (int i = 0; i < TW; ++i) zs[at<RB, KMAJ>(lane, i)] = o[i];
                }
            } else {
                // the last chunk: kw columns, the last output the carry
                const int kw = n - t * TW;
                for (int i = 0; i + 1 < kw; ++i) {
                    const float z = zs[at<RB, KMAJ>(lane, i + 1)];
                    const float o = rot_out(cc[i], ss[i], carry, z);
                    carry = rot_carry(cc[i], ss[i], carry, z);
                    zs[at<RB, KMAJ>(lane, i)] = o;
                }
                zs[at<RB, KMAJ>(lane, kw - 1)] = carry;
            }
        }
        // the chunk's outputs, visible to the TMA store the producer issues
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&done[slot]));
    }
}

// The tensor map of Z or the output: KMAJ (row-major, element (r, k)
// at r * ld + k) boxes of RB rows x TW columns in the 128-byte swizzle;
// else (element (r, k) at r + k * ld) boxes of TW columns x RB rows.
bool map_z(CUtensorMap* map, const float* p, long long ld, int rows, int n,
           int rb, bool kmaj) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)(kmaj ? n : rows),
                                (cuuint64_t)(kmaj ? rows : n)};
    const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)(kmaj ? TW : rb),
                               (cuuint32_t)(kmaj ? rb : TW)};
    const cuuint32_t estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
               dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               kmaj ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A vector of `len` f32, boxes of TW.
bool map_vec(CUtensorMap* map, const float* p, int len) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[1] = {(cuuint64_t)len};
    const cuuint64_t strides[1] = {0};
    const cuuint32_t box[1] = {(cuuint32_t)TW};
    const cuuint32_t estr[1] = {1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(p),
               dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RB, bool KMAJ>
int launch(const CUtensorMap& mz, const CUtensorMap& mo,
           const CUtensorMap& mc, const CUtensorMap& ms, int rows, int n,
           cudaStream_t s) {
    constexpr int smem = smem_bytes<RB>();
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            givens_chain_tma<RB, KMAJ>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) {
            cudaGetLastError();
            return (int)e;
        }
        attr_set = true;
    }
    givens_chain_tma<RB, KMAJ><<<(rows + RB - 1) / RB, 64, smem, s>>>(
        mz, mo, mc, ms, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// O = Z @ G for Z (rows, n) f32 with element strides (zsr, zsk), O with
// (osr, osk), one of each pair 1 and the same one for both (the
// other, the leading stride, a multiple of 4), Z, O, cs and sn 16-byte
// aligned; cs, sn the n-1 rotations; rb rows a block (8, 16 or 32); on
// `stream`. n = 1 copies Z. Returns a cudaError_t.
int givens_chain(const float* Z, long long zsr, long long zsk, float* O,
                 long long osr, long long osk, const float* cs,
                 const float* sn, int rows, int n, int rb, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
    const bool kmaj = zsk == 1;
    if (kmaj ? osk != 1 : (zsr != 1 || osr != 1))
        return (int)cudaErrorInvalidValue;
    if (n == 1)
        return (int)cudaMemcpy2DAsync(O, osr * sizeof(float), Z,
                                      zsr * sizeof(float), sizeof(float),
                                      rows, cudaMemcpyDeviceToDevice, s);
    CUtensorMap mz, mo, mc, ms;
    if (!map_z(&mz, Z, kmaj ? zsr : zsk, rows, n, rb, kmaj)
        || !map_z(&mo, O, kmaj ? osr : osk, rows, n, rb, kmaj)
        || !map_vec(&mc, cs, n - 1) || !map_vec(&ms, sn, n - 1))
        return (int)cudaErrorInvalidValue;
    switch (rb * 2 + (int)kmaj) {
        case 17: return launch<8, true>(mz, mo, mc, ms, rows, n, s);
        case 16: return launch<8, false>(mz, mo, mc, ms, rows, n, s);
        case 33: return launch<16, true>(mz, mo, mc, ms, rows, n, s);
        case 32: return launch<16, false>(mz, mo, mc, ms, rows, n, s);
        case 65: return launch<32, true>(mz, mo, mc, ms, rows, n, s);
        case 64: return launch<32, false>(mz, mo, mc, ms, rows, n, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"

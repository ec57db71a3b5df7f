// Trailing update of the tall-panel split: out = A22 - L21 @ U12.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_rank_update_pallas (:594),
// which grids the same product over row blocks rb in {2048 ... 128}
// because VMEM holds one (rb, w) block at a time. The kernels here mask
// their own ragged edge, so they take every height m2; the port
// launches them for every height (ops/kernels.py _rank_update). The
// reference's rounding points (pallas_kernels.py :605-611) are kept:
// the products accumulate in f32, the sum is rounded to T, then
// out = T(f32(A22) - f32(T(P))).
//
// Bound on an H100, at the split's shapes (m2 ~ 16k, w1 = w2 <= 256):
//  - bf16: the bytes. A22, L21 and out are 3 m2 w bf16 and U12 is
//    small: 7.4 us at 16128 x 256 x 256 (3.35 TB/s); the products
//    (2 m2 w1 w2) take 2.1 us at the tensor cores' 989 TFLOP/s.
//    Design (rank_update_wgmma): one block of two consumer warpgroups
//    per 128-row band of L21, the whole K = w1 <= 256 and N = w2 <= 256
//    in shared memory at once (L21's band 64 KB, U12 as B^T 128 KB),
//    loaded by TMA in 64-deep K slabs (128B swizzle, one mbarrier a
//    slab, so the products of slab 0 start while slab 3 is in flight),
//    the products by wgmma m64nNk16 (bf16 x bf16 -> f32, both operands
//    K-major from shared memory); the band of A22 is prefetched into L2
//    at the start, and the epilogue stages T(P) through the warpgroup's
//    own (now free) slab buffers in a swizzled layout, so A22 is read
//    and out written once, in 16-byte coalesced accesses. wgmma reads
//    B K-major, so U12 is first transposed into a scratch (w2, w1) by a
//    small kernel (128 KB, once a call), launched so that the product's
//    grid starts under it and waits for U12^T only before loading it.
//    Shapes it takes: w1, w2 <= 256 and multiples of 8 (TMA's 16-byte
//    strides), 16-byte aligned rows.
//  - f32: the operations. 2 m2 w1 w2 at 67 TFLOP/s on the CUDA cores
//    (TF32 is off: the tensor cores cannot take f32 products exactly):
//    31.6 us at 16128 x 256 x 256. Design (rank_update_simt): the
//    register-tiled product of sgemm_tile.cuh, 128 x 128 tiles (252
//    blocks at that shape, two resident a SM: one wave on 132 SMs), an
//    8 x 8 block per thread, LDS.128 reads, a 3-deep cp.async ring of
//    16-deep K slabs, A22 read and out written by 16-byte accesses.
//  - anything else the wrapper takes (bf16 of other widths, unaligned
//    rows) runs rank_update_simt's generic path: the same tile, loaded
//    through registers.
// Operands are row-major and contiguous; the wrapper allocates `out`
// and the bf16 scratch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pdl.cuh"
#include "sgemm_tile.cuh"
#include "tma.cuh"

namespace {

using slate_torch::sgemm_sub_tile;
using slate_torch::sg_smem_bytes;
typedef __nv_bfloat16 bf16;

// -- f32 and the generic shapes: the CUDA-core tile ------------------------

constexpr int RU_TILE = 128;

template <typename T, bool VEC>
__global__ void __launch_bounds__(slate_torch::SG_THREADS, 2)
rank_update_simt(const T* a22, const T* l21, const T* u12, T* out, int m2,
                 int w2, int w1) {
    extern __shared__ float4 sg_smem4[];
    sgemm_sub_tile<T, RU_TILE, RU_TILE, false, VEC>(
        reinterpret_cast<float*>(sg_smem4), a22, w2, l21, w1, u12, w2, out,
        w2, m2, w2, w1, blockIdx.y * RU_TILE, blockIdx.x * RU_TILE);
}

template <typename T, bool VEC>
int launch_simt(const T* a22, const T* l21, const T* u12, T* out, int m2,
                int w2, int w1, cudaStream_t s) {
    constexpr int smem = sg_smem_bytes(RU_TILE, RU_TILE);
    cudaError_t e = cudaFuncSetAttribute(
        rank_update_simt<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    dim3 grid((w2 + RU_TILE - 1) / RU_TILE, (m2 + RU_TILE - 1) / RU_TILE);
    rank_update_simt<T, VEC><<<grid, slate_torch::SG_THREADS, smem, s>>>(
        a22, l21, u12, out, m2, w2, w1);
    return (int)cudaGetLastError();
}

// -- bf16: TMA, mbarriers and wgmma --------------------------------------

constexpr int WG_ROWS = 128;            // rows of L21 a block (2 x m64)
constexpr int WG_SLAB = 64;             // K of one slab: 128 bytes of bf16
constexpr int WG_MAX_K = 256;
constexpr int WG_SLABS = WG_MAX_K / WG_SLAB;
constexpr int WG_A_BOX = 64 * 128;      // bytes of a 64-row slab of L21
constexpr int WG_A_BYTES = 2 * WG_SLABS * WG_A_BOX;

using slate_torch::mbar_expect_tx;
using slate_torch::mbar_init;
using slate_torch::mbar_wait;
using slate_torch::smem_u32;
using slate_torch::tma_load_2d;

// Shared-memory matrix descriptor of a K-major operand in the 128B
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused for this layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
    uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
    d |= (uint64_t)(16 >> 4) << 16;
    d |= (uint64_t)(1024 >> 4) << 32;
    d |= (uint64_t)1 << 62;
    return d;
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da,
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
}

// U12 (w1, w2) -> U12^T (w2, w1), 32 x 32 tiles through shared memory.
__global__ void __launch_bounds__(256)
transpose_bf16(const bf16* __restrict__ src, bf16* __restrict__ dst,
               int rows, int cols) {
    __shared__ bf16 t[32][34];
    slate_torch::pdl_wait();
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int r = r0 + i, c = c0 + threadIdx.x;
        if (r < rows && c < cols) t[i][threadIdx.x] = src[(long)r * cols + c];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += 8) {
        const int c = c0 + i, r = r0 + threadIdx.x;
        if (r < rows && c < cols) dst[(long)c * rows + r] = t[threadIdx.x][i];
    }
}

// One 128-row band of out per block; N: the wgmma width (64, 128, 256)
// that covers w2. Threads 0-127 are warpgroup 0 (rows 0-63 of the band),
// 128-255 warpgroup 1 (rows 64-127).
template <int N>
__global__ void __launch_bounds__(256, 1)
rank_update_wgmma(const __grid_constant__ CUtensorMap map_l21,
                  const __grid_constant__ CUtensorMap map_u12t,
                  const bf16* __restrict__ a22, bf16* __restrict__ out,
                  int m2, int w2, int w1) {
    extern __shared__ uint8_t wg_smem[];
    __shared__ __align__(8) uint64_t full[WG_SLABS];
    // 1024-byte alignment of the swizzled tiles
    const uint32_t raw = smem_u32(wg_smem);
    uint8_t* base = wg_smem + ((1024 - (raw & 1023)) & 1023);
    uint8_t* As = base;                     // [half][slab][64 rows][128 B]
    uint8_t* Bs = base + WG_A_BYTES;        // [slab][N rows][128 B]
    const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
    const int row0 = blockIdx.x * WG_ROWS;
    const int nk = (w1 + WG_SLAB - 1) / WG_SLAB;

    if (tid == 0) {
        for (int s = 0; s < nk; ++s) mbar_init(smem_u32(&full[s]), 1);
        slate_torch::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
        // the band of A22 into L2 while the products run
        const int rows = min(WG_ROWS, m2 - row0);
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                     :: "l"(a22 + (long)row0 * w2),
                        "r"(rows * w2 * (int)sizeof(bf16))
                     : "memory");
        for (int s = 0; s < nk; ++s) {
            const uint32_t bar = smem_u32(&full[s]);
            mbar_expect_tx(bar, 2 * WG_A_BOX + N * 128);
            tma_load_2d(smem_u32(As + s * WG_A_BOX), &map_l21, s * WG_SLAB,
                        row0, bar);
            tma_load_2d(smem_u32(As + (WG_SLABS + s) * WG_A_BOX), &map_l21,
                        s * WG_SLAB, row0 + 64, bar);
        }
        // U12^T comes from the transpose launched just before this grid
        // (launch_pdl): wait for it only here
        asm volatile("griddepcontrol.wait;\n" ::: "memory");
        for (int s = 0; s < nk; ++s)
            tma_load_2d(smem_u32(Bs + s * N * 128), &map_u12t, s * WG_SLAB,
                        0, smem_u32(&full[s]));
    }

    // no other instruction writes the accumulators before the products
    // (the first takes scale-d = 0), so the wgmmas of a slab pipeline
    float acc[N / 2];
    uint8_t* Aw = As + wg * WG_SLABS * WG_A_BOX;   // this warpgroup's rows
    for (int s = 0; s < nk; ++s) {
        mbar_wait(smem_u32(&full[s]), 0);
        __syncwarp();
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WG_SLAB / 16; ++kk)
            wgmma_bf16<N>(acc,
                          sw128_desc(smem_u32(Aw + s * WG_A_BOX + kk * 32)),
                          sw128_desc(smem_u32(Bs + s * N * 128 + kk * 32)),
                          s > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // T(P) into this warpgroup's slab buffers (read only by its own
    // products, all complete): row r at r * 2N bytes, its 16-byte chunk
    // c at (c ^ (r % 8)), so the fragment stores and the row reads below
    // spread over the banks
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + lane / 4 + 8 * h;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(
                Aw + r * 2 * N + ((j ^ (r & 7)) << 4) + (lane % 4) * 4) = v;
        }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

    constexpr int CPR = N / 8;               // 16-byte chunks a row
#pragma unroll 4
    for (int e = t; e < 64 * CPR; e += 128) {
        const int r = e / CPR, c = e % CPR;
        const int gr = row0 + 64 * wg + r, gc = c * 8;
        if (gr >= m2 || gc >= w2) continue;
        const uint4 pv = *reinterpret_cast<const uint4*>(
            Aw + r * 2 * N + ((c ^ (r & 7)) << 4));
        const uint4 av = *reinterpret_cast<const uint4*>(
            a22 + (long)gr * w2 + gc);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&pv);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
        uint4 ov;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float2 a = __bfloat1622float2(a2[q]);
            const float2 p = __bfloat1622float2(p2[q]);
            o2[q] = __floats2bfloat162_rn(__fsub_rn(a.x, p.x),
                                          __fsub_rn(a.y, p.y));
        }
        *reinterpret_cast<uint4*>(out + (long)gr * w2 + gc) = ov;
    }
}

// A (rows, cols) row-major bf16 tensor, boxes of (box_rows, 64) in the
// 128B swizzle; out-of-range rows and columns read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
    slate_torch::EncodeTiled enc = slate_torch::encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
    const cuuint32_t box[2] = {(cuuint32_t)WG_SLAB, (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(ptr), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
int launch_wgmma(const bf16* a22, const bf16* l21, const bf16* u12, bf16* out,
                 bf16* u12t, int m2, int w2, int w1, cudaStream_t s) {
    dim3 tgrid((w2 + 31) / 32, (w1 + 31) / 32);
    cudaError_t e = slate_torch::launch_pdl(transpose_bf16, tgrid,
                                            dim3(32, 8), 0, s, u12, u12t, w1,
                                            w2);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap ml, mu;
    if (!make_map(&ml, l21, m2, w1, 64) || !make_map(&mu, u12t, w2, w1, N))
        return (int)cudaErrorInvalidValue;
    const int smem = 1024 + WG_A_BYTES + WG_SLABS * N * 128;
    e = cudaFuncSetAttribute(rank_update_wgmma<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    e = slate_torch::launch_pdl(rank_update_wgmma<N>,
                                dim3((m2 + WG_ROWS - 1) / WG_ROWS), dim3(256),
                                smem, s, ml, mu, a22, out, m2, w2, w1);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The widths the bf16 tensor-core path takes: TMA's 16-byte row strides
// and the widths that fit shared memory at once.
bool wgmma_ok(int w2, int w1) {
    return w1 > 0 && w2 > 0 && w1 <= WG_MAX_K && w2 <= 256 && w1 % 8 == 0
           && w2 % 8 == 0;
}

}  // namespace

// Make `device` current for this library's runtime.
extern "C" int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// out = A22 - L21 @ U12 for row-major (m2, w2), (m2, w1), (w1, w2)
// operands of one type (bf16 != 0: bf16, else f32) on `stream`;
// `scratch` holds w2 * w1 bf16 for the bf16 tensor-core path, which
// takes w1, w2 <= 256, multiples of 8, with 16-byte aligned operands
// (null, or other shapes: the CUDA-core tile takes the call). Returns a cudaError_t.
extern "C" int rank_update(const void* a22, const void* l21,
                           const void* u12, void* out, int m2, int w2,
                           int w1, int bf16_, void* scratch, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (m2 <= 0 || w2 <= 0) return (int)cudaGetLastError();
    if (bf16_) {
        const bf16 *A = (const bf16*)a22, *L = (const bf16*)l21,
                   *U = (const bf16*)u12;
        bf16* O = (bf16*)out;
        if (scratch != nullptr && wgmma_ok(w2, w1)
            && aligned16(A) && aligned16(L) && aligned16(O)
            && aligned16(scratch)) {
            bf16* T = (bf16*)scratch;
            if (w2 <= 64) return launch_wgmma<64>(A, L, U, O, T, m2, w2, w1, s);
            if (w2 <= 128)
                return launch_wgmma<128>(A, L, U, O, T, m2, w2, w1, s);
            return launch_wgmma<256>(A, L, U, O, T, m2, w2, w1, s);
        }
        return launch_simt<bf16, false>(A, L, U, O, m2, w2, w1, s);
    }
    const float *A = (const float*)a22, *L = (const float*)l21,
                *U = (const float*)u12;
    float* O = (float*)out;
    if (w2 % 4 == 0 && aligned16(A) && aligned16(U) && aligned16(O))
        return launch_simt<float, true>(A, L, U, O, m2, w2, w1, s);
    return launch_simt<float, false>(A, L, U, O, m2, w2, w1, s);
}

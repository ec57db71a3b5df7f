// What the TMA kernels share: shared-memory mbarriers, the Tensor
// Memory Accelerator's bulk tensor copies (loads into shared memory
// that complete on an mbarrier, stores from shared memory in bulk
// groups), the proxy fence between them, and cuTensorMapEncodeTiled
// reached through the runtime (no link against libcuda).
//
// Used by the bf16 trailing update (rank_update.cu) and the Givens
// chain apply (givens_chain.cu).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slate_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// Make the mbarrier inits visible to the async proxy (the TMA unit).
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            int c0, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2}], [%3];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(bar)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(c1), "r"(bar)
        : "memory");
}

// Store a box from shared memory; elements outside the tensor are not
// written. Completion is tracked by bulk groups (tma_commit / tma_wait*).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0,
                                             int c1, uint32_t src) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%1, %2}], [%3];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(src)
        : "memory");
}

__device__ __forceinline__ void tma_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void tma_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// At most N of this thread's bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void tma_wait() {
    asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory writes of this thread, visible to the async proxy (a
// TMA store that follows).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no link against libcuda).
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

}  // namespace slate_torch

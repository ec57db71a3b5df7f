// Programmatic dependent launch (Hopper): a grid launched by launch_pdl
// may start while the previous grid on the stream still runs, so its
// launch and prologue overlap that grid's tail. It must wait
// (griddepcontrol.wait) before it touches anything an earlier grid
// writes; pdl_wait() does that and then lets the next grid launch.
// Used between the launches of one C entry (chol_panel.cu,
// rank_update.cu).

#pragma once

#include <cuda_runtime.h>

namespace slate_torch {

__device__ __forceinline__ void pdl_wait() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       int smem, cudaStream_t s, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace slate_torch

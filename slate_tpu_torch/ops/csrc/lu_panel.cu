// Rank-1-per-column partial-pivot LU panel: the device work of
// ops/kernels.py lu_panel.
//
// Replaces slate_tpu/ops/pallas_kernels.py:_lu_panel_pallas (the
// reference's cold bf16 panel route, the lo-precision factor of
// gesv_mixed). Per column j of an (m, w) panel, w <= 256: argmax of |a|
// over rows >= j in f32 (first maximum wins), full-row swap,
// pivval == 0 -> 1 safe divide in f32 with the multiplier rounded to
// the panel type, rank-1 update of every column > j in the panel type
// (for bf16: x = bf16(x - bf16(mu * u)), one rounding per op), the
// multipliers written below the diagonal, pivots as int32 swap targets.
// f32 and bf16 panels (the `bf16` argument).
//
// The rank-1 panel is the recursive panel's base case taken over the
// whole width, so it is one launch of the cooperative segment
// factorization of lu_base.cuh with c0 = 0, wseg = w. The Pallas
// kernel's masked whole-panel selects (Mosaic has no dynamic row ops)
// are not carried over: rows are indexed directly.
//
// Bound on an H100: m w^2 - w^3/3 FLOPs; at 4096 x 256 that is 263
// MFLOP, about 4 us at the 67 TFLOP/s f32 rate (the panel read once and
// written once is 4 MB in bf16, 8 MB in f32: 1.3-2.5 us). It is
// latency-bound on the 256-column recurrence instead: every column
// needs a reduction over all m rows and a row exchange before the next
// can start, two grid barriers of a few microseconds each (measured on
// an H100: 1.6-1.8 ms at 4096 x 256, about 6.5 us a column; PERF.md).
// What the design does about it:
// one block per SM keeps its row slice of the whole panel in shared
// memory for the whole call (4096 x 256 f32: 32 rows x 256 x 4 B =
// 32 KB per block), so each column costs two barriers and the
// block-local work on shared memory, never a pass over device memory;
// the candidates and the two exchanged rows are the only cross-block
// traffic. Not done: splitting the width recursively (that is
// lu_panel_rec), or fewer barriers per column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lu_base.cuh"

extern "C" {

// Make `device` current for this library's runtime.
int slate_set_device(int device) {
    cudaSetDevice(device);
    return (int)cudaGetLastError();
}

// The whole (m, w) panel `a`, in place (scratch as launch_lu_base).
int lu_panel(void* a, int* piv, int m, int w, float* scratch_f,
             int* scratch_i, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return slate_torch::launch_lu_base((__nv_bfloat16*)a, piv, m, w, 0,
                                           w, scratch_f, scratch_i, s);
    return slate_torch::launch_lu_base((float*)a, piv, m, w, 0, w,
                                       scratch_f, scratch_i, s);
}

}  // extern "C"

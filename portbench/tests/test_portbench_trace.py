"""Reading a profiler trace: the busy union, device time tied to the
range that launched it, idle gaps labelled by what the host was doing,
and the port's spans moved onto the trace's clock. A hand-made Chrome
trace stands for the profiler's."""

import json

import pytest

from portbench import readers, trace


class _FakeProfiler:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


EVENTS = [
    # two traced calls on thread 1: [0, 100) and [100, 200)
    _x("user_annotation", "portbench::call", 0, 100),
    _x("user_annotation", "portbench::call", 100, 100),
    _x("user_annotation", "portbench::panel", 2, 23),
    _x("cpu_op", "aten::mm", 30, 5),
    _x("cpu_op", "aten::item", 60, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=3),
    # device: panel kernel [10, 40), gemm [35, 50), another [130, 190)
    _x("kernel", "lu_base_grid_kernel", 10, 30, tid=7, correlation=1),
    _x("kernel", "sm80_xmma_gemm_f32", 35, 15, tid=7, correlation=2),
    _x("kernel", "elementwise", 130, 60, tid=7, correlation=3),
    # another thread's operator is not the caller's
    _x("cpu_op", "aten::other", 50, 80, tid=2),
]


def test_busy_union_and_window(tmp_tmpdir):
    t = trace.read(_FakeProfiler(EVENTS))
    assert t.window == (0, 200) and t.window_s == pytest.approx(200e-6)
    assert t.busy() == [(10, 50), (130, 190)]
    assert t.busy_s() == pytest.approx(100e-6)
    assert [o.name for o in t.launched_in("portbench::panel")] == [
        "lu_base_grid_kernel"]
    assert t.top_ops(2) == [["elementwise", pytest.approx(60e-6)],
                            ["lu_base_grid_kernel", pytest.approx(30e-6)]]


def test_idle_gaps_are_labelled_by_the_calling_thread(tmp_tmpdir):
    spans = [("gesv", 1.0, 1.0002)]          # perf_counter seconds
    t = trace.read(_FakeProfiler(EVENTS), spans, [1.0, 1.0001])
    assert dict(t.idle_gaps()) == {
        # [0, 10): inside the panel's range, no operator open
        "portbench::panel / python (x1)": pytest.approx(10e-6),
        # [50, 130): the port's gesv span (moved onto the trace's clock)
        # and aten::item, which holds the midpoint 90
        "gesv / aten::item (x1)": pytest.approx(80e-6),
        "gesv / python (x1)": pytest.approx(10e-6)}


def test_innermost_span():
    spans = [(0, 100, "outer"), (10, 20, "inner"), (30, 40, "second")]
    assert trace.innermost(spans, [5, 15, 25, 35, 150]) == [
        "outer", "inner", "outer", "second", None]


def test_no_traced_call_gives_no_trace(tmp_tmpdir):
    assert trace.read(_FakeProfiler(EVENTS[2:])) is None


#: kernel names that cuBLAS launched in the LU cells on an H100
LIBRARY_SEEN = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
    "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, "
    "4, 4, false, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBat",
    "void kernel_trsm_l_mul32<float, 8, false, true, false, false>(int, int, "
    "float const*, float const*, int, float*, int, float, int)",
    "void trsv_lt_exec<float, 32u, 32u, 4u, false, false>(int, float const*, "
    "long, float*, long, int*)",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>("
    "cutlass_80_simt_sgemm_128x128_8x4_nn_align1::Params)",
]
#: PyTorch's own kernels are not the libraries'
ATEN_SEEN = [
    "void at::native::vectorized_gather_kernel<16, long>(char*, char*, "
    "long*, int, long, long, long, long, bool)",
    "void at::native::triu_tril_kernel<c10::BFloat16, int, false, 4, false>"
    "(at::cuda::detail::TensorInfo<c10::BFloat16, int>)",
]


def _count_globals():
    import glob
    import importlib.util
    import os
    root = os.path.join(list(importlib.util.find_spec(
        "slate_tpu_torch").submodule_search_locations)[0], "ops", "csrc")
    return sum(open(p, errors="replace").read().count("__global__")
               for p in glob.glob(os.path.join(root, "**", "*.cu*"),
                                  recursive=True))


def test_every_hand_kernel_of_the_port_is_found():
    hand = readers.hand_kernels()
    assert len(hand) == _count_globals() > 0
    assert {"chol_trsm_kernel", "ragged_trsm_kernel", "lu_base_grid_kernel",
            "rank_update_wgmma"} <= hand


@pytest.mark.parametrize("form", [
    "{k}", "void {k}(float*, int)", "void {k}<float>(float*, int, int)",
    "void slate_torch::{k}<__nv_bfloat16, 1>(__nv_bfloat16*, int*)",
    "void (anonymous namespace)::{k}<float, true>(float*, int)"])
def test_no_hand_kernel_of_the_port_is_library(form):
    for k in sorted(readers.hand_kernels()):
        assert not readers.is_library(form.format(k=k)), form.format(k=k)


@pytest.mark.parametrize("name", LIBRARY_SEEN)
def test_the_libraries_kernels_are_library(name):
    assert readers.is_library(name)


@pytest.mark.parametrize("name", ATEN_SEEN)
def test_pytorchs_own_kernels_are_not_library(name):
    assert not readers.is_library(name)

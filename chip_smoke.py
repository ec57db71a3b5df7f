#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (slate_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failed phase makes the
script exit non-zero without the final result line:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile every CUDA kernel from ops/csrc (nvcc, in
              parallel) and report the seconds and ptxas usage;
  3. kernels  each kernel against its plain PyTorch version on the
              card, at the shapes the main path gives it, timed beside
              the plain version, one PyTorch library call computing the
              same function (timed only; the port never calls it) and
              the least time the card could take;
  4. gesv     the main path: gesv at n = 16384, 64 right-hand sides,
              f32, tiles and Option.BlockSize of 512, with a tune cache
              routing every LU panel to the recursive kernel; both
              kernels' launch counts must rise during the call, the
              backward error must be <= 1e-6, and X must agree with
              the cold route (library LU panels) to 1e-3;
  5. profile  the same gesv, on both routes, once more under
              torch.profiler: host wall, device busy time (the union
              of the kernel, copy and memset intervals of the trace),
              idle share and the heaviest kernels by device time;
  6. the {"kernels": [...]} summary, then the card's nvidia-smi line,
     then {"ok": true, "device": {...}}.

Needs a CUDA card: without one it exits 2 and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import slate_tpu_torch as st
from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.testing import (EXACT_KINDS, panel_cases,
                                     permuted_boosted_system)
from slate_tpu_torch.tune import cache as tcache
from slate_tpu_torch.tune import select as tselect

#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the
#: tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N, NRHS, NB = 16384, 64, 512


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(flops, nbytes):
    """Least time for the work: the larger of operations over the f32
    peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, reps):
    """Mean ms per call over `reps` calls after one warm-up, by CUDA
    events around the whole run."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def lu_residual(a, packed, piv):
    """||P A - L U||_F / ||A||_F of a packed (m, w) panel, in f64."""
    m, w = a.shape
    perm = pk.lu_pivots_to_permutation(piv, m)
    p64 = packed.double()
    L = torch.tril(p64, -1)
    L[:w].diagonal().fill_(1)
    U = torch.triu(p64[:w])
    return float(torch.linalg.norm(a.double()[perm] - L @ U)
                 / torch.linalg.norm(a.double()))


def panel_flops(m, w):
    return m * w * w - w ** 3 / 3.0


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    return {"phase": "device", "ok": True,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build():
    secs = _build.build_all()
    for name in _build.LIBS:
        _build.load(name)
    return {"phase": "build", "ok": True, "seconds": secs,
            "libs": {k: v for k, v in _build.build_log.items()}}


def phase_panel(rng, results):
    """lu_panel_rec: the adversarial suite (m=256, w=32, ib=8), then
    random panels at the main path's shapes."""
    dev = torch.device("cuda")
    ok, worst = True, 0.0
    kinds = {}
    for kind, a_np in panel_cases(rng, 256, 32, 8).items():
        a = torch.as_tensor(a_np, device=dev)
        kp, kpiv = pk.lu_panel_rec(a, ib=8)
        pp, ppiv = pk.lu_panel_rec_plain(a, ib=8)
        torch.cuda.synchronize()
        piv_eq = torch.equal(kpiv, ppiv)
        err = float((kp - pp).abs().max())
        # the zero-noise kinds are exact in every operation: bitwise;
        # the others agree to f32 rounding of differently ordered sums
        val_ok = err == 0.0 if kind in EXACT_KINDS else err <= 1e-4
        ok &= piv_eq and val_ok
        worst = max(worst, err)
        kinds[kind] = {"pivots_bitwise": piv_eq, "max_abs_err": err}
    shapes = {}
    for m, w in ((N, 128), (N, 512)):
        a = torch.as_tensor(rng.standard_normal((m, w), dtype=np.float32),
                            device=dev)
        kp, kpiv = pk.lu_panel_rec(a)
        pp, ppiv = pk.lu_panel_rec_plain(a)
        res = lu_residual(a, kp, kpiv)
        res_plain = lu_residual(a, pp, ppiv)
        piv_eq = torch.equal(kpiv, ppiv)
        err = float((kp - pp).abs().max()) if piv_eq else None
        if err is not None:
            worst = max(worst, err)
        ok &= res <= 1e-5
        reps = 5 if w == 128 else 3
        ms = cuda_ms(lambda: pk.lu_panel_rec(a), reps)
        plain_ms = cuda_ms(lambda: pk.lu_panel_rec_plain(a), 1)
        lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(a), reps)
        b_ms, b_by = bound_ms(panel_flops(m, w), 4.0 * (2 * m * w + w))
        shapes["%dx%d" % (m, w)] = {
            "residual": res, "residual_plain": res_plain,
            "pivots_equal_plain": piv_eq, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "split": m * w > pk.LU_REC_MAX_ELEMS}
    s = shapes["%dx128" % N]
    results["lu_panel_rec"] = {
        "name": "lu_panel_rec", "route": "cuda",
        "source": "slate_tpu_torch/ops/csrc/lu_panel_rec.cu",
        "replaces": "slate_tpu/ops/pallas_kernels.py:454",
        "shape": "%dx128" % N, "max_abs_err": worst, "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
    return {"phase": "kernel.lu_panel_rec", "ok": bool(ok),
            "adversarial": kinds, "shapes": shapes}


def phase_rank_update(rng, results):
    """_rank_update at the two shapes the split of a 16384x512 panel
    gives it."""
    dev = torch.device("cuda")
    ok, worst, shapes = True, 0.0, {}
    for m2, w1, w2 in ((N - 256, 256, 256), (N - 128, 128, 128)):
        a22, l21, u12 = (torch.as_tensor(
            rng.standard_normal(s, dtype=np.float32), device=dev)
            for s in ((m2, w2), (m2, w1), (w1, w2)))
        out = pk._rank_update(a22, l21, u12)
        ref = pk.rank_update_plain(a22, l21, u12)
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        # sums of w1 products in another order than cuBLAS's: 1e-4
        # relative is far above f32 rounding (~1e-6)
        ok &= rel <= 1e-4
        ms = cuda_ms(lambda: pk._rank_update(a22, l21, u12), 20)
        plain_ms = cuda_ms(lambda: pk.rank_update_plain(a22, l21, u12), 20)
        lib_ms = cuda_ms(lambda: torch.addmm(a22, l21, u12, alpha=-1), 20)
        b_ms, b_by = bound_ms(2.0 * m2 * w1 * w2,
                              4.0 * (2 * m2 * w2 + m2 * w1 + w1 * w2))
        shapes["%dx%dx%d" % (m2, w1, w2)] = {
            "rel_err": rel, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by}
    key = "%dx%dx%d" % (N - 256, 256, 256)
    s = shapes[key]
    results["rank_update"] = {
        "name": "rank_update", "route": "cuda",
        "source": "slate_tpu_torch/ops/csrc/rank_update.cu",
        "replaces": "slate_tpu/ops/pallas_kernels.py:594",
        "shape": key, "max_abs_err": worst, "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
    return {"phase": "kernel.rank_update", "ok": bool(ok), "shapes": shapes}


def phase_gesv(seed, results, system):
    """The main path, routed to the recursive panel kernel by a tune
    cache of its own. Leaves A, B and the options in `system` for the
    profile phase."""
    tmp = tempfile.mkdtemp(prefix="slate_tpu_torch_tune_")
    os.environ["SLATE_TPU_TORCH_TUNE_CACHE"] = tmp
    os.environ.pop("SLATE_TPU_TORCH_TUNE", None)
    tcache.reset_cache()
    cache = tcache.get_cache()
    n = 512
    while n <= N:
        cache.put("lu_panel", torch.float32, n,
                  {"method_lu_panel": "pallas_rec"})
        n *= 2
    cache.save()
    a_np, b_np = permuted_boosted_system(np.random.default_rng(seed), N,
                                         NRHS)
    A = st.Matrix(a_np, mb=NB)
    B = st.Matrix(b_np, mb=NB)
    del a_np, b_np
    opts = {st.Option.BlockSize: NB}
    st.gesv(A, B, opts)                       # warm-up
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    F, X = st.gesv(A, B, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pk.launch_counts()
    for name, count in launches.items():
        results[name]["launches"] = count
    a64, x64 = A.data.double(), X.data.double()
    berr = float(torch.linalg.norm(a64 @ x64 - B.data.double())
                 / (torch.linalg.norm(a64) * torch.linalg.norm(x64)))
    del a64, x64
    with tselect.disabled():                  # the cold route
        st.gesv(A, B, opts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Fc, Xc = st.gesv(A, B, opts)
        torch.cuda.synchronize()
        wall_cold = time.perf_counter() - t0
    xdiff = float(torch.linalg.norm(X.data - Xc.data)
                  / torch.linalg.norm(Xc.data))
    ok = (all(c > 0 for c in launches.values()) and berr <= 1e-6
          and xdiff <= 1e-3 and int(F.info) == 0
          and bool(torch.isfinite(X.data).all()))
    system.update(A=A, B=B, opts=opts)
    return {"phase": "gesv", "ok": bool(ok), "n": N, "nrhs": NRHS,
            "nb": NB, "dtype": "float32", "seed": seed, "wall_s": wall,
            "launches": launches, "backward_error": berr,
            "x_rel_diff_cold": xdiff,
            "pivots_equal_cold": torch.equal(F.pivots, Fc.pivots),
            "wall_s_cold_route": wall_cold,
            "gflops": (2.0 / 3.0 * N ** 3 + 2.0 * N * N * NRHS) / wall / 1e9,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


#: trace categories of work on the card; other rows of a profiler trace
#: (operators, runtime calls, the profiler's own buffer flushes) are not
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_gesv(system, top=8):
    """One gesv (already warm) under torch.profiler. Busy time is the
    union of the device intervals in the exported trace, so overlapping
    kernels count once."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st.gesv(system["A"], system["B"], system["opts"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="slate_tpu_torch_prof_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t, t + dur))
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + dur / 1e3, calls + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if spans else None,
            "top": [{"kernel": k[:100], "device_ms": ms, "calls": c}
                    for k, (ms, c) in heavy]}


def phase_profile(system):
    """Where the time of the main path's gesv goes, on both routes."""
    out = {"phase": "profile", "ok": True,
           "pallas_rec": profile_gesv(system)}
    with tselect.disabled():
        out["cold"] = profile_gesv(system)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    results, system = {}, {}
    failed = []
    device = None
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernel.lu_panel_rec",
                      lambda: phase_panel(rng, results)),
                     ("kernel.rank_update",
                      lambda: phase_rank_update(rng, results)),
                     ("gesv", lambda: phase_gesv(args.seed, results,
                                                 system)),
                     ("profile", lambda: phase_profile(system))):
        try:
            out = fn()
        except Exception as e:          # report the phase, then stop
            import traceback
            traceback.print_exc()
            out = {"phase": name, "ok": False,
                   "error": "%s: %s" % (type(e).__name__, e)}
        emit(out)
        if name == "device":
            device = out
        if not out["ok"]:
            failed.append(name)
            break
    if failed:
        print("chip_smoke: failed phase(s): %s" % failed, file=sys.stderr)
        return 1
    emit({"kernels": [results[k] for k in ("lu_panel_rec", "rank_update")]})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

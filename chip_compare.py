#!/usr/bin/env python3
"""Parent against change on one card, in one run: the Householder
panel (`qr_panel`), the ragged triangular solve (`ragged_trsm`), and
the calls on their paths.

    git archive <parent> | tar -x -C smoke_archive/parent
    python3 chip_compare.py --parent smoke_archive/parent

  1. kernels  the parent tree's qr_panel.cu and ragged_trsm.cu are
              compiled from its sources into libraries of their own and
              called through their C entries on the same inputs as this
              tree's wrappers, in the order parent, change, change,
              parent, back to back (`ms`) and replayed from a CUDA graph
              (`graph_ms`): qr_panel f32 and bf16 at 8192, 4096, 1024
              and 256 x 128 (each tree against the plain version:
              chip_smoke.qr_values_ok and the factors' residual within
              chip_smoke.QR_RES_LIMIT), beside torch.geqrf (an f32
              upcast for bf16); ragged_trsm f32 and bf16 in the four
              modes the posv / gesv flushes run (000, 010, 001, 100:
              upper, trans, unit) on the serving stream's first flush
              and on the flush that holds the order-1024 request (the
              factors from ragged_potrf), each tree within
              chip_smoke.RAGGED_LIMIT of the plain version with zero pad
              rows, beside torch.linalg.solve_triangular on the
              identity-padded factors; each row carries its bound
              (chip_smoke.qr_bounds / trsm_bounds);
  2. solves   in one process per tree, in the order parent, change,
              change, parent: the bf16 gels at n = 8192 as chip_smoke.py's
              phase runs it (its checks included, 64 qr_panel launches)
              and once more under torch.profiler (busy time, idle share,
              qr_panel's share); the ragged posv and gesv of the serving
              stream's first flush on the card (batch.drivers
              ragged_dispatch on device stacks, warm, CUDA events), and
              the same posv through the queue (chip_smoke.serve_run, host
              copies included).

Prints one JSON line a phase and the card's nvidia-smi line; exits 1
when a check fails and 2 without a CUDA card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as pk

from chip_smoke import (DTYPES, QR_RES_LIMIT, RAGGED_LIMIT, TRSM_PATH_MODES,
                        cuda_ms, graph_ms, identity_padded, largest_flush,
                        path_stacks, plain_subset, qr_bounds, qr_residual,
                        qr_values_ok, scaled_err, to_card, trsm_bounds,
                        trsm_library)

ORDER = ("parent", "change", "change", "parent")
QR_SHAPES = (8192, 4096, 1024, 256)

#: the parent's C entries
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_LIBS = {
    "qr_panel": {"qr_panel_scratch": [_I],
                 "qr_panel": [_P, _P, _I, _I, _P, _P, _I, _P]},
    "ragged_trsm": {"ragged_trsm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P]},
}


def build_parent(tree):
    """The parent's libraries, compiled from its sources, in parallel."""
    csrc = os.path.join(tree, "slate_tpu_torch", "ops", "csrc")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs, procs = {}, []
    for name in PARENT_LIBS:
        out = os.path.join(_build.BUILD_DIR, "libparent_%s.so" % name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
               os.path.join(csrc, name + ".cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("parent %s: nvcc failed\n%s" % (name, log))
        lib = ctypes.CDLL(out)
        lib.slate_set_device.argtypes = [_I]
        for fn, argtypes in PARENT_LIBS[name].items():
            getattr(lib, fn).argtypes = argtypes
        lib.slate_set_device(torch.cuda.current_device())
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def parent_qr_panel(lib, a):
    """One panel through the parent's kernel, as its wrapper called it."""
    m, w = a.shape
    out = a.clone(memory_format=torch.contiguous_format)
    taus = torch.empty(w, dtype=torch.float32, device=a.device)
    scr = torch.empty(lib.qr_panel_scratch(w), dtype=torch.float32,
                      device=a.device)
    bar = torch.empty(1, dtype=torch.int32, device=a.device)
    _build.check(lib.qr_panel(out.data_ptr(), taus.data_ptr(), m, w,
                              scr.data_ptr(), bar.data_ptr(),
                              int(a.dtype == torch.bfloat16), _stream()),
                 "parent qr_panel")
    return out, taus


def parent_ragged_trsm(lib, t, b, sizes, upper, trans, unit):
    B, N, K = b.shape
    out = torch.empty_like(b)
    _build.check(lib.ragged_trsm(t.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 sizes.data_ptr(), B, N, K, pk.ragged_blk(),
                                 int(upper), int(trans), int(unit),
                                 int(b.dtype == torch.bfloat16), _stream()),
                 "parent ragged_trsm")
    return out


def timed(row, fns, reps):
    """ms and graph_ms of each tree's call, in the order ORDER."""
    for i, who in enumerate(ORDER):
        row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], reps)
        row["graph_ms_%d_%s" % (i, who)] = graph_ms(fns[who], reps)


def qr_rows(libs, rng):
    ok, rows = True, []
    for m in QR_SHAPES:
        for dname, dtype in DTYPES:
            a = torch.as_tensor(rng.standard_normal((m, 128),
                                                    dtype=np.float32),
                                device="cuda").to(dtype)
            pp, pt = pk.qr_panel_plain(a)
            fns = {"parent": lambda: parent_qr_panel(libs["qr_panel"], a),
                   "change": lambda: pk._qr_panel_launch(a)}
            row = {"kernel": "qr_panel", "dtype": dname,
                   "shape": "%dx128" % m}
            for who, fn in fns.items():
                kp, kt = fn()
                v_ok, err, terr = qr_values_ok("random", dtype, kp, kt, pp,
                                               pt)
                res = qr_residual(a, kp, kt)
                row.update({"values_ok_" + who: v_ok, "err_" + who: err,
                            "tau_err_" + who: terr, "residual_" + who: res})
                ok &= res <= QR_RES_LIMIT[dtype]
            timed(row, fns, 10)
            a32 = a.float()
            row["library"] = "torch.geqrf" + (
                " (f32 upcast)" if dtype != torch.float32 else "")
            row["library_ms"] = cuda_ms(lambda: torch.geqrf(a32), 10)
            row["library_graph_ms"] = graph_ms(lambda: torch.geqrf(a32), 10)
            row.update(qr_bounds(m, 128, a.element_size()))
            rows.append(row)
    return ok, rows


def trsm_rows(libs, seed):
    ok, rows = True, []
    for flush in (0, largest_flush(seed)):
        sizes, ceil, spd, _gen, rhs = path_stacks(seed, flush)
        sub = plain_subset(sizes)
        szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        for dname, dtype in DTYPES:
            L = pk.ragged_potrf(to_card(spd, dtype), szc)
            U = L.mT.contiguous()
            b = to_card(rhs, dtype)
            Lid = identity_padded(L, sizes).float()
            b32 = b.float()
            for up, tr, un in TRSM_PATH_MODES:
                T = U if up else L
                px = pk.ragged_trsm_plain(T[sub], b[sub],
                                          [sizes[i] for i in sub],
                                          pk.ragged_blk(), up, tr, un)
                fns = {"parent": lambda: parent_ragged_trsm(
                           libs["ragged_trsm"], T, b, szc, up, tr, un),
                       "change": lambda: pk.ragged_trsm(
                           T, b, szc, upper=up, trans=tr, unit=un)}
                row = {"kernel": "ragged_trsm", "dtype": dname,
                       "mode": "%d%d%d" % (up, tr, un), "flush": flush,
                       "shape": "%dx%dx%d, K = 1" % L.shape}
                for who, fn in fns.items():
                    kx = fn()
                    err = scaled_err(kx[sub], px)
                    zero_pad = all(bool((kx[i, s:] == 0).all())
                                   for i, s in enumerate(sizes))
                    row["err_" + who], row["zero_pad_" + who] = err, zero_pad
                    ok &= err <= RAGGED_LIMIT[dtype] and zero_pad
                timed(row, fns, 20)
                lib = trsm_library(Lid, b32, up, tr, un)
                row["library_ms"] = cuda_ms(lib, 20)
                row["library_graph_ms"] = graph_ms(lib)
                row.update(trsm_bounds(sizes, b))
                rows.append(row)
    return ok, rows


def phase_kernels(libs, seed):
    rng = np.random.default_rng(seed)
    ok, rows = True, []
    for part in (lambda: qr_rows(libs, rng), lambda: trsm_rows(libs, seed)):
        p_ok, p_rows = part()
        ok &= p_ok
        rows += p_rows
    return {"phase": "kernels", "ok": bool(ok), "rows": rows}


#: run in each tree (only what both trees' chip_smoke.py have): the bf16
#: gels phase, the bf16 gels under the profiler, then the serving
#: stream's first flush as ragged posv and gesv on the card and the
#: posv through the queue
SOLVES = """
import json
import numpy as np
import torch
import chip_smoke as cs
import slate_tpu_torch as st
from slate_tpu_torch.batch import drivers
seed = %d
results, system = {}, {}
g = cs.phase_gels_bf16(seed, results, system)
a_np, b_np = cs.permuted_boosted_system(np.random.default_rng(seed),
                                        cs.N_QR_BF16, cs.NRHS)
Ab = st.Matrix(torch.as_tensor(a_np, device="cuda").bfloat16(), mb=cs.NB)
Bb = st.Matrix(torch.as_tensor(b_np, device="cuda").bfloat16(), mb=cs.NB)
del a_np, b_np
prof = cs.profile_call(lambda: st.gels(Ab, Bb), top=40)
qr_ms = sum(t["device_ms"] for t in prof["top"]
            if "qr_panel" in t["kernel"])
del Ab, Bb
sizes, ceil, spd, gen, rhs = cs.path_stacks(seed)
szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
flush = {}
for op, stack in (("posv", spd), ("gesv", gen)):
    S = torch.as_tensor(stack, device="cuda")
    R = torch.as_tensor(rhs, device="cuda")
    x = drivers.ragged_dispatch(op, S, szc, R, device="cuda")
    a64 = S.double()
    r = torch.linalg.norm(a64 @ x.double() - R.double()) / (
        torch.linalg.norm(a64) * torch.linalg.norm(x.double()))
    flush[op] = {"ms": cs.cuda_ms(lambda: drivers.ragged_dispatch(
        op, S, szc, R, device="cuda"), 10), "backward_error": float(r)}
mats = [np.ascontiguousarray(spd[i, :n, :n]) for i, n in enumerate(sizes)]
rhss = [np.ascontiguousarray(rhs[i, :n]) for i, n in enumerate(sizes)]
cs.serve_run("posv", mats, rhss, "ragged")
_, rec, _ = cs.serve_run("posv", mats, rhss, "ragged")
print("SOLVES " + json.dumps({
    "gels_bf16_wall_s": g["wall_s"], "gels_bf16_ok": g["ok"],
    "gels_bf16_x_rel_diff_f32": g["x_rel_diff_f32"],
    "gels_bf16_qr_panel_launches": g["launches"]["qr_panel"],
    "gels_f32_wall_s": g["gels_f32_wall_s"],
    "gels_bf16_profile": {"wall_s": prof["wall_s"],
                          "busy_s": prof["device_busy_s"],
                          "idle_share": prof["idle_share"],
                          "qr_panel_ms": qr_ms,
                          "qr_panel_share": qr_ms / 1e3
                          / prof["device_busy_s"],
                          "top": prof["top"][:8]},
    "ragged_flush": flush, "posv_queue_flush": rec}))
"""


def phase_solves(trees, seed):
    ok, runs = True, []
    for who in ORDER:
        proc = subprocess.run([sys.executable, "-c", SOLVES % seed],
                              cwd=trees[who], capture_output=True,
                              text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("SOLVES ")]
        if proc.returncode or not line:
            runs.append({"tree": who, "rc": proc.returncode,
                         "stderr": proc.stderr[-2000:]})
            ok = False
            continue
        rec = json.loads(line[-1][len("SOLVES "):])
        rec["tree"] = who
        ok &= rec["gels_bf16_ok"] and all(
            f["backward_error"] <= 1e-6 for f in rec["ragged_flush"].values())
        runs.append(rec)
    return {"phase": "solves", "ok": bool(ok), "runs": runs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the parent commit's tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-solves", action="store_true",
                    help="run the kernels phase only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: needs a CUDA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(args.parent), "change": here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    _build.build_all()
    failed = []
    phases = [("kernels", lambda: phase_kernels(
        build_parent(trees["parent"]), args.seed))]
    if not args.skip_solves:
        phases.append(("solves", lambda: phase_solves(trees, args.seed)))
    for name, fn in phases:
        out = fn()
        print(json.dumps(out), flush=True)
        if not out["ok"]:
            failed.append(name)
    print(smi, flush=True)
    if failed:
        print("chip_compare: failed phase(s): %s" % failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

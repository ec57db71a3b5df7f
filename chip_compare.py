#!/usr/bin/env python3
"""Parent against change on one card, in one run: the rank-1 LU panel
(`lu_panel`), the ragged batched LU (`ragged_getrf`), and the calls on
their paths.

    git archive <parent> | tar -x -C smoke_archive/parent
    python3 chip_compare.py --parent smoke_archive/parent

  1. kernels  the parent tree's lu_panel.cu and ragged_getrf.cu are
              compiled from its sources into libraries of their own and
              called through their C entries on the same inputs as this
              tree's wrappers, in the order parent, change, change,
              parent, back to back (`ms`) and replayed from a CUDA graph
              (`graph_ms`): lu_panel f32 and bf16 on random 256-column
              panels at every height the cold mixed route runs (4096,
              3840, ..., 256 rows), each tree BITWISE against
              lu_panel_plain (packed LU and pivots), beside
              torch.linalg.lu_factor (an f32 upcast for bf16; replayed
              from a graph as lu_factor_ex where the capture takes it);
              ragged_getrf f32 and bf16 on the serving stream's first
              flush and on the flush that holds the order-1024 request,
              each tree against the plain version on four elements
              (pivots and pads bitwise, values within
              chip_smoke.RAGGED_LIMIT), beside torch.linalg.lu_factor_ex
              on the identity-padded stack (f32); each row carries its
              bound and latency floor;
  2. solves   in one process per tree, in the order parent, change,
              change, parent: gesv_mixed cold at n = 4096 as
              chip_smoke.py's phase runs it (its checks included, 16
              lu_panel launches; the pivots' digest, to hold the trees
              equal) and once more under torch.profiler (busy time, idle
              share, lu_panel's share: its base-case kernels, over the grid
              and in one block, and its trailing-column kernel); the ragged gesv of the serving stream's first
              flush on the card (batch.drivers ragged_dispatch on device
              stacks, warm, CUDA events) and the same gesv through the
              queue (chip_smoke.serve_run, host copies included).

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

from chip_smoke import (DTYPES, N_COLD, PEAK_BF16_FLOPS, PEAK_F32_FLOPS,
                        RAGGED_LIMIT, bound_ms, cuda_ms, graph_ms,
                        identity_padded, largest_flush, lu_panel_latency_ms,
                        panel_flops, path_stacks, plain_subset,
                        ragged_compare, ragged_getrf_cluster,
                        ragged_lu_latency_ms, to_card, try_graph_ms)

ORDER = ("parent", "change", "change", "parent")
#: the cold mixed route's panels at n = 4096: 256 columns, 4096 ... 256
#: rows
LU_HEIGHTS = tuple(range(N_COLD, 0, -256))

#: the parent's C entries
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_LIBS = {
    "lu_panel": {"lu_panel": [_P, _P, _I, _I, _P, _P, _I, _P]},
    "ragged_getrf": {"ragged_getrf": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
}
#: the parent's lu_panel scratch (csrc/lu_base.cuh launch_lu_base):
#: candidate slots of its cooperative grid
_PARENT_BASE_MAX_BLOCKS = 1024


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


def parent_lu_panel(lib, a):
    """One panel through the parent's kernel, as its wrapper called it."""
    m, w = a.shape
    out = a.clone(memory_format=torch.contiguous_format)
    piv = torch.zeros(w, dtype=torch.int32, device=a.device)
    scr_f = torch.empty(2 * _PARENT_BASE_MAX_BLOCKS + 4 * w,
                        dtype=torch.float32, device=a.device)
    scr_i = torch.empty(1 + 2 * _PARENT_BASE_MAX_BLOCKS, dtype=torch.int32,
                        device=a.device)
    _build.check(lib.lu_panel(out.data_ptr(), piv.data_ptr(), m, w,
                              scr_f.data_ptr(), scr_i.data_ptr(),
                              int(a.dtype == torch.bfloat16), _stream()),
                 "parent lu_panel")
    return out, piv


def parent_ragged_getrf(lib, a, sizes):
    B, N = a.shape[0], a.shape[-1]
    out = torch.empty_like(a)
    piv = torch.empty((B, N), dtype=torch.int32, device=a.device)
    _build.check(lib.ragged_getrf(a.data_ptr(), out.data_ptr(),
                                  piv.data_ptr(), sizes.data_ptr(), B, N,
                                  pk.ragged_blk(),
                                  int(a.dtype == torch.bfloat16), _stream()),
                 "parent ragged_getrf")
    return out, piv


def timed(row, fns, reps):
    """ms and graph_ms of each tree's call, in the order ORDER."""
    for i, who in enumerate(ORDER):
        row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], reps)
        row["graph_ms_%d_%s" % (i, who)] = graph_ms(fns[who], reps)


def lu_rows(libs, rng):
    ok, rows = True, []
    for m in LU_HEIGHTS:
        for dname, dtype in DTYPES:
            a = torch.as_tensor(rng.standard_normal((m, 256),
                                                    dtype=np.float32),
                                device="cuda").to(dtype)
            pp, ppiv = pk.lu_panel_plain(a)
            fns = {"parent": lambda: parent_lu_panel(libs["lu_panel"], a),
                   "change": lambda: pk._lu_panel_launch(a)}
            row = {"kernel": "lu_panel", "dtype": dname,
                   "shape": "%dx256" % m}
            for who, fn in fns.items():
                kp, kpiv = fn()
                same = bool(torch.equal(kp, pp) and torch.equal(kpiv, ppiv))
                row["bitwise_plain_" + who] = same
                ok &= same
            timed(row, fns, 5)
            a32 = a.float()
            row["library"] = "torch.linalg.lu_factor" + (
                " (f32 upcast)" if dtype != torch.float32 else "")
            row["library_ms"] = cuda_ms(lambda: torch.linalg.lu_factor(a32),
                                        5)
            row["library_graph_ms"], row["library_graph_error"] = \
                try_graph_ms(lambda: torch.linalg.lu_factor_ex(a32), 5)
            b, by = bound_ms(panel_flops(m, 256),
                             2.0 * a.element_size() * m * 256)
            row.update(bound_ms=b, bound_by=by,
                       latency_bound_ms=lu_panel_latency_ms(m, 256))
            rows.append(row)
    return ok, rows


def getrf_rows(libs, seed):
    ok, rows = True, []
    for flush in (0, largest_flush(seed)):
        sizes, ceil, _spd, gen, _rhs = path_stacks(seed, flush)
        sub = plain_subset(sizes)
        szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        for dname, dtype in DTYPES:
            a = to_card(gen, dtype)
            pl, ppv = pk.ragged_getrf_plain(a[sub], [sizes[i] for i in sub],
                                            pk.ragged_blk())
            fns = {"parent": lambda: parent_ragged_getrf(
                       libs["ragged_getrf"], a, szc),
                   "change": lambda: pk.ragged_getrf(a, szc)}
            row = {"kernel": "ragged_getrf", "dtype": dname, "flush": flush,
                   "shape": "%dx%dx%d" % a.shape, "s_max": max(sizes),
                   "cluster": ragged_getrf_cluster(ceil)}
            outs = {}
            for who, fn in fns.items():
                kl, kpv = fn()
                outs[who] = (kl, kpv)
                piv_eq = bool(torch.equal(kpv[sub], ppv))
                c_ok, err, pad = ragged_compare(dtype, kl[sub], pl,
                                                [sizes[i] for i in sub])
                row.update({"pivots_bitwise_" + who: piv_eq,
                            "err_" + who: err, "pad_bitwise_" + who: pad})
                ok &= piv_eq and c_ok
            row["pivots_equal_trees"] = bool(torch.equal(
                outs["parent"][1], outs["change"][1]))
            row["bitwise_trees"] = bool(torch.equal(outs["parent"][0],
                                                    outs["change"][0]))
            del outs
            timed(row, fns, 5)
            aid = identity_padded(a, sizes).float()
            row["library"] = "torch.linalg.lu_factor_ex (identity pad, f32" \
                + (" upcast)" if dtype != torch.float32 else ")")
            row["library_ms"] = cuda_ms(
                lambda: torch.linalg.lu_factor_ex(aid), 5)
            row["library_graph_ms"], row["library_graph_error"] = \
                try_graph_ms(lambda: torch.linalg.lu_factor_ex(aid), 5)
            del aid
            live2 = sum(s * s for s in sizes)
            b, by = bound_ms(
                2.0 / 3.0 * sum(s ** 3 for s in sizes),
                a.element_size() * (live2 + a.numel())
                + 4.0 * a.shape[0] * (1 + ceil),
                PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
            row.update(bound_ms=b, bound_by=by,
                       latency_bound_ms=ragged_lu_latency_ms(max(sizes)))
            rows.append(row)
            del a
    return ok, rows


def phase_kernels(libs, seed):
    rng = np.random.default_rng(seed)
    ok, rows = True, []
    for part in (lambda: lu_rows(libs, rng), lambda: getrf_rows(libs, seed)):
        p_ok, p_rows = part()
        ok &= p_ok
        rows += p_rows
    return {"phase": "kernels", "ok": bool(ok), "rows": rows}


#: run in each tree (only what both trees' chip_smoke.py have): the cold
#: mixed phase, gesv_mixed cold once more under the profiler, then the
#: serving stream's first flush as a ragged gesv on the card and through
#: the queue
SOLVES = """
import hashlib
import inspect
import json
import numpy as np
import torch
import chip_smoke as cs
import slate_tpu_torch as st
from slate_tpu_torch.batch import drivers
seed = %d
results, system = {}, {}
args = (seed, results, system)
nargs = len(inspect.signature(cs.phase_mixed_cold).parameters)
cold = cs.phase_mixed_cold(*args[:nargs])
cs.fresh_tune_cache()
a_np, b_np = cs.permuted_boosted_system(np.random.default_rng(seed),
                                        cs.N_COLD, cs.NRHS)
A = st.Matrix(a_np, mb=cs.NB_COLD)
B = st.Matrix(b_np, mb=cs.NB_COLD)
F, X, iters = st.gesv_mixed(A, B)
digest = hashlib.sha256(F.pivots.cpu().numpy().tobytes()).hexdigest()[:16]
prof = cs.profile_call(lambda: st.gesv_mixed(A, B), top=40)
panel_ms = sum(t["device_ms"] for t in prof["top"]
               if any(k in t["kernel"] for k in
                      ("lu_base", "lu_block_kernel", "lu_trail")))
del A, B, F, X
sizes, ceil, spd, gen, rhs = cs.path_stacks(seed)
szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
S = torch.as_tensor(gen, device="cuda")
R = torch.as_tensor(rhs, device="cuda")
x = drivers.ragged_dispatch("gesv", S, szc, R, device="cuda")
a64 = S.double()
r = torch.linalg.norm(a64 @ x.double() - R.double()) / (
    torch.linalg.norm(a64) * torch.linalg.norm(x.double()))
flush = {"ms": cs.cuda_ms(lambda: drivers.ragged_dispatch(
    "gesv", S, szc, R, device="cuda"), 10), "backward_error": float(r)}
mats = [np.ascontiguousarray(gen[i, :n, :n]) for i, n in enumerate(sizes)]
rhss = [np.ascontiguousarray(rhs[i, :n]) for i, n in enumerate(sizes)]
cs.serve_run("gesv", mats, rhss, "ragged")
_, rec, _ = cs.serve_run("gesv", mats, rhss, "ragged")
m = cold["gesv_mixed"]
print("SOLVES " + json.dumps({
    "cold_ok": cold["ok"], "cold_wall_s": m["wall_s"],
    "cold_iters": m["iters"], "cold_backward_error": m["backward_error"],
    "cold_x_rel_diff_f32": m["x_rel_diff_f32"],
    "cold_lu_panel_launches": m["launches"]["lu_panel"],
    "cold_gesv_f32_wall_s": m["gesv_f32_wall_s"],
    "cold_gmres_wall_s": cold["gesv_mixed_gmres"]["wall_s"],
    "cold_pivots_digest": digest,
    "cold_profile": {"wall_s": prof["wall_s"],
                     "busy_s": prof["device_busy_s"],
                     "idle_share": prof["idle_share"],
                     "lu_panel_ms": panel_ms,
                     "lu_panel_share": panel_ms / 1e3
                     / prof["device_busy_s"],
                     "top": prof["top"][:8]},
    "ragged_gesv_flush": flush, "gesv_queue_flush": rec}))
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
        ok &= rec["cold_ok"] and rec["cold_lu_panel_launches"] == 16 \
            and rec["ragged_gesv_flush"]["backward_error"] <= 1e-6
        runs.append(rec)
    digests = {r.get("cold_pivots_digest") for r in runs}
    return {"phase": "solves", "ok": bool(ok and len(digests) == 1),
            "cold_pivots_equal": len(digests) == 1, "runs": runs}


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

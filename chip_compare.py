#!/usr/bin/env python3
"""Parent against change on one card, in one run: the triangular inverse
(`trtri_lower`), the ragged batched Cholesky (`ragged_potrf`), the
trailing update of the LU panel split (`_rank_update`), the Cholesky
block (`chol_panel`), the LU solves and the serving stream's ragged
potrf.

    git archive <parent> | tar -x -C smoke_archive/parent
    python3 chip_compare.py --parent smoke_archive/parent

  1. kernels  the parent tree's trtri_lower.cu, ragged_potrf.cu,
              rank_update.cu and chol_panel.cu are compiled from its
              sources into libraries of their own and called through
              their C entries on the same inputs as this tree's
              wrappers, in the order parent, change, change, parent:
              trtri_lower on Cholesky factors at n = 512, 256, 128,
              back to back and replayed as a CUDA graph;
              ragged_potrf (f32 and bf16) on the serving stream's first
              flush (64 x 608^2) and on the flush that holds its
              order-1024 request (64 x 1024^2); _rank_update at the
              split's shapes of a 16384 x 512 panel (f32 and bf16),
              timed as a replayed CUDA graph (the card's time) and back
              to back; chol_panel at n = 1024, 512, 256, back to back.
              Each result is held against the plain version first
              (trtri and Cholesky 1e-5 of the scale; ragged f32 1e-5,
              bf16 2^-7 of the scale on four elements, its largest
              among them, and every pad bitwise; the update f32 1e-4,
              bf16 2^-7 normwise);
  2. solves   gesv and gesv_mixed at n = 16384 as chip_smoke.py's
              phases run them (their checks included), then the serving
              stream's potrf leg on the ragged route (256 requests
              through CoalescingQueue(max_batch=64), a warm-up pass and
              a measured one: matrices/s, p50/p99), one process per
              tree, in the order parent, change, change, parent.

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
from slate_tpu_torch.testing import spd_system

from chip_smoke import (cuda_ms, graph_ms, identity_padded, largest_flush,
                        path_stacks, plain_subset, ragged_compare, rel_diff,
                        scaled_err, to_card)

N = 16384
ORDER = ("parent", "change", "change", "parent")

#: the parent's C entries
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_LIBS = {"rank_update": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
               "chol_panel": [_P, _P, _I, _I, _P],
               "trtri_lower": [_P, _P, _I, _I, _P],
               "ragged_potrf": [_P, _P, _P, _I, _I, _I, _I, _P]}


def build_parent(tree):
    """The parent's two libraries, compiled from its sources."""
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
        getattr(lib, name).argtypes = PARENT_LIBS[name]
        lib.slate_set_device(torch.cuda.current_device())
        libs[name] = lib
    return libs


def _stream():
    return torch.cuda.current_stream().cuda_stream


def parent_rank_update(lib, a22, l21, u12):
    out = torch.empty_like(a22)
    m2, w2 = a22.shape
    bf16 = a22.dtype == torch.bfloat16
    scratch = torch.empty((w2, l21.shape[1]), dtype=a22.dtype,
                          device=a22.device) if bf16 else None
    _build.check(lib.rank_update(a22.data_ptr(), l21.data_ptr(),
                                 u12.data_ptr(), out.data_ptr(), m2, w2,
                                 l21.shape[1], int(bf16),
                                 None if scratch is None
                                 else scratch.data_ptr(),
                                 _stream()), "parent rank_update")
    return out


def parent_chol(lib, a):
    work = a.clone()
    out = torch.zeros_like(work)
    _build.check(lib.chol_panel(work.data_ptr(), out.data_ptr(),
                                a.shape[0], 0, _stream()),
                 "parent chol_panel")
    return out


def parent_trtri(lib, L):
    L = L.contiguous()
    out = torch.zeros_like(L)
    _build.check(lib.trtri_lower(L.data_ptr(), out.data_ptr(), L.shape[0],
                                 0, _stream()), "parent trtri_lower")
    return out


def parent_ragged_potrf(lib, a, sizes):
    out = torch.empty_like(a)
    _build.check(lib.ragged_potrf(a.data_ptr(), out.data_ptr(),
                                  sizes.data_ptr(), a.shape[0], a.shape[1],
                                  pk.ragged_blk(),
                                  int(a.dtype == torch.bfloat16), _stream()),
                 "parent ragged_potrf")
    return out


def trtri_rows(libs, seed):
    ok, rows = True, []
    gen = torch.Generator("cuda").manual_seed(seed + 23)
    for n in (512, 256, 128):
        L = torch.linalg.cholesky(spd_system(gen, n, 1)[0])
        ref = pk.trtri_lower_plain(L)
        fns = {"parent": lambda: parent_trtri(libs["trtri_lower"], L),
               "change": lambda: pk._trtri_lower_launch(L, False)}
        row = {"kernel": "trtri_lower", "dtype": "float32",
               "shape": "%dx%d" % (n, n)}
        for who, fn in fns.items():
            row["err_" + who] = scaled_err(fn(), ref)
            ok &= row["err_" + who] <= 1e-5
        for i, who in enumerate(ORDER):
            row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], 10)
            row["graph_ms_%d_%s" % (i, who)] = graph_ms(fns[who])
        eye = torch.eye(n, device="cuda")
        lib = lambda: torch.linalg.solve_triangular(L, eye, upper=False)
        row["library_ms"] = cuda_ms(lib, 10)
        row["library_graph_ms"] = graph_ms(lib)
        rows.append(row)
    return ok, rows


def ragged_rows(libs, seed):
    ok, rows = True, []
    for flush in (0, largest_flush(seed)):
        sizes, ceil, spd, _gen, _rhs = path_stacks(seed, flush)
        sub = plain_subset(sizes)
        szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            a = to_card(spd, dtype)
            pp = pk.ragged_potrf_plain(a[sub], [sizes[i] for i in sub],
                                       pk.ragged_blk())
            fns = {"parent": lambda: parent_ragged_potrf(
                       libs["ragged_potrf"], a, szc),
                   "change": lambda: pk.ragged_potrf(a, szc)}
            row = {"kernel": "ragged_potrf", "dtype": dname,
                   "shape": "%dx%dx%d" % a.shape, "flush": flush}
            for who, fn in fns.items():
                k_ok, err, pad = ragged_compare(dtype, fn()[sub], pp,
                                                [sizes[i] for i in sub])
                row["err_" + who], row["pad_bitwise_" + who] = err, pad
                ok &= k_ok
            for i, who in enumerate(ORDER):
                row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], 5)
            aid = identity_padded(a, sizes).float()
            row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(aid),
                                        5)
            del aid, a
            rows.append(row)
    return ok, rows


def phase_kernels(libs, seed):
    rng = np.random.default_rng(seed)
    ok, rows = True, []
    for part in (trtri_rows, ragged_rows):
        p_ok, p_rows = part(libs, seed)
        ok &= p_ok
        rows += p_rows
    for dtype, dims in ((torch.float32, ((N - 256, 256, 256),
                                         (N - 128, 128, 128))),
                        (torch.bfloat16, ((N - 256, 256, 256),
                                          (N - 128, 128, 128),
                                          (N - 64, 64, 64)))):
        lim = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for m2, w1, w2 in dims:
            ops = [torch.as_tensor(rng.standard_normal(sh, dtype=np.float32),
                                   device="cuda").to(dtype)
                   for sh in ((m2, w2), (m2, w1), (w1, w2))]
            ref = pk.rank_update_plain(*ops)
            fns = {"parent": lambda: parent_rank_update(
                       libs["rank_update"], *ops),
                   "change": lambda: pk._rank_update(*ops)}
            row = {"kernel": "rank_update", "dtype": str(dtype)[6:],
                   "shape": "%dx%dx%d" % (m2, w1, w2)}
            for who, fn in fns.items():
                row["rel_" + who] = rel_diff(fn(), ref)
                ok &= row["rel_" + who] <= lim
            for i, who in enumerate(ORDER):
                row["ms_%d_%s" % (i, who)] = graph_ms(fns[who])
                row["eager_ms_%d_%s" % (i, who)] = cuda_ms(fns[who], 20)
            rows.append(row)
    gen = torch.Generator("cuda").manual_seed(seed)
    for n in (1024, 512, 256):
        s = spd_system(gen, n, 1)[0]
        ref = pk.chol_panel_plain(s)
        fns = {"parent": lambda: parent_chol(libs["chol_panel"], s),
               "change": lambda: pk._chol_panel_launch(s)}
        row = {"kernel": "chol_panel", "dtype": "float32",
               "shape": "%dx%d" % (n, n)}
        for who, fn in fns.items():
            row["err_" + who] = scaled_err(fn(), ref)
            ok &= row["err_" + who] <= 1e-5
        for i, who in enumerate(ORDER):
            row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], 10)
        row["library_ms"] = cuda_ms(lambda: torch.linalg.cholesky(s), 10)
        rows.append(row)
    return {"phase": "kernels", "ok": bool(ok), "rows": rows}


#: run in each tree: chip_smoke.py's gesv and gesv_mixed phases, then
#: the serving stream's potrf on the ragged route (warm-up, measured)
SOLVES = """
import json, sys
import chip_smoke as cs
seed = %d
results, system = {}, {}
g = cs.phase_gesv(seed, results, system)
m = cs.phase_mixed(results, system)
del system
sizes, xs, spds = cs.serve_stream(seed, cs.SERVE_REQS)
cs.serve_run("potrf", spds, None, "ragged")
outs, rec, launches = cs.serve_run("potrf", spds, None, "ragged")
berr = max(cs.chol_berr(L, a) for L, a in zip(outs, spds))
print("SOLVES " + json.dumps({
    "gesv_wall_s": g["wall_s"], "gesv_ok": g["ok"],
    "gesv_backward_error": g["backward_error"],
    "gesv_rank_update_launches": g["launches"]["rank_update"],
    "gesv_mixed_wall_s": m["wall_s"], "gesv_mixed_ok": m["ok"],
    "gesv_mixed_iters": m["iters"],
    "gesv_mixed_rank_update_launches": m["launches"]["rank_update"],
    "serve_potrf_ragged": {k: rec[k] for k in (
        "wall_s", "matrices_per_s", "p50_ms", "p99_ms", "dispatches")},
    "serve_potrf_launches": launches["ragged_potrf"],
    "serve_potrf_backward_error": berr,
    "serve_potrf_ok": berr <= 1e-6 and launches["ragged_potrf"] > 0}))
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
        ok &= rec["gesv_ok"] and rec["gesv_mixed_ok"] \
            and rec["serve_potrf_ok"]
        runs.append(rec)
    return {"phase": "solves", "ok": bool(ok), "runs": runs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the parent commit's tree")
    ap.add_argument("--seed", type=int, default=0)
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
    for name, fn in (("kernels", lambda: phase_kernels(
                          build_parent(trees["parent"]), args.seed)),
                     ("solves", lambda: phase_solves(trees, args.seed))):
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

#!/usr/bin/env python3
"""Parent against change on one card, in one run: the Givens chain
apply (`givens_chain_apply`), the recursive LU panel (`lu_panel_rec`:
its base case, leaf solve and product update), the rank-1 LU panel
(`lu_panel`, which shares the old base case), and the solves on their
paths.

    git archive <parent> | tar -x -C smoke_archive/parent
    python3 chip_compare.py --parent smoke_archive/parent

  1. kernels  the parent tree's givens_chain.cu, lu_panel_rec.cu and
              lu_panel.cu are compiled from its sources into libraries
              of their own and called through their C entries on the
              same inputs as this tree's wrappers, in the order parent,
              change, change, parent, back to back (`ms`) and replayed
              from a CUDA graph (`graph_ms`): the chain on Z 2048 x 2048,
              512 x 512 and a transposed 512 x 512 view, each bitwise
              against the plain version, beside Z @ G; lu_panel_rec at
              f32 16384x128 and bf16 16384x64 (one dispatch) and at
              16384x512 in both types (the tall split, its sub-panels
              through either tree's panel kernels), each tree's panel
              bitwise the other's, pivots bitwise against the plain
              version (one dispatch; the split's bf16 update on the
              tensor cores rounds otherwise) and the residual within
              chip_smoke.RES_LIMIT; lu_panel bf16 4096x256 the same way;
              then, this tree only and replayed from a CUDA graph,
              qr_panel f32 4096x128 against torch.geqrf and ragged_trsm
              f32 / bf16 on the serving stream's first flush (64 x 608^2,
              K = 1) against torch.linalg.solve_triangular;
  2. solves   in one process per tree, in the order parent, change,
              change, parent: gesv and gesv_mixed at n = 16384 as
              chip_smoke.py's phases run them (their checks included)
              and gesv once more under torch.profiler (busy time, idle
              share, the base case's share); heev at n = 2048 and svd at
              512 through their QR iterations with the chain routed to
              the kernel (chip_smoke.py's systems and accuracy checks).

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

from chip_smoke import (DTYPES, RAGGED_LIMIT, RES_LIMIT, cuda_ms, graph_ms,
                        identity_padded, lu_residual, path_stacks,
                        plain_subset, qr_residual, scaled_err, to_card)

N = 16384
ORDER = ("parent", "change", "change", "parent")

#: the parent's C entries
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_LIBS = {
    "lu_panel_rec": {"lu_rec_base": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
                     "lu_rec_solve_leaf": [_P, _I, _I, _I, _I, _I, _I, _P],
                     "lu_rec_mm_update": [_P, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _P]},
    "lu_panel": {"lu_panel": [_P, _P, _I, _I, _P, _P, _I, _P]},
    "givens_chain": {"givens_chain": [_P, _L, _L, _P, _L, _L, _P, _P, _I,
                                      _I, _P]},
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


def parent_chain(lib, Z, cs, sn):
    out = torch.empty_like(Z)
    _build.check(lib.givens_chain(Z.data_ptr(), Z.stride(0), Z.stride(1),
                                  out.data_ptr(), out.stride(0),
                                  out.stride(1), cs.data_ptr(), sn.data_ptr(),
                                  Z.shape[0], Z.shape[1], _stream()),
                 "parent givens_chain")
    return out


def parent_panel_rec(lib, a, ib):
    """One panel dispatch through the parent's kernels: the same
    recursion, the parent's base case signature."""
    m, w = a.shape
    out = a.clone(memory_format=torch.contiguous_format)
    piv = torch.zeros(w, dtype=torch.int32, device=a.device)
    scr_f = torch.empty(2 * 1024 + 4 * w, dtype=torch.float32,
                        device=a.device)
    scr_i = torch.empty(1 + 2 * 1024, dtype=torch.int32, device=a.device)
    ptr, pptr, s = out.data_ptr(), piv.data_ptr(), _stream()
    bf16 = int(a.dtype == torch.bfloat16)

    def base(c0, wseg):
        _build.check(lib.lu_rec_base(ptr, pptr, m, w, c0, wseg,
                                     scr_f.data_ptr(), scr_i.data_ptr(),
                                     bf16, s), "parent lu_rec_base")

    def leaf(c0, ws, c1, c2):
        _build.check(lib.lu_rec_solve_leaf(ptr, w, c0, ws, c1, c2, bf16, s),
                     "parent lu_rec_solve_leaf")

    def mm(r0, r1, k0, k1, c0, c1):
        _build.check(lib.lu_rec_mm_update(ptr, w, r0, r1, k0, k1, c0, c1,
                                          bf16, s), "parent lu_rec_mm_update")

    pk._rec_drive(m, w, ib, base, leaf, mm)
    return out, piv


def parent_lu_panel(lib, a):
    m, w = a.shape
    out = a.clone(memory_format=torch.contiguous_format)
    piv = torch.zeros(w, dtype=torch.int32, device=a.device)
    scr_f = torch.empty(2 * 1024 + 4 * w, dtype=torch.float32,
                        device=a.device)
    scr_i = torch.empty(1 + 2 * 1024, dtype=torch.int32, device=a.device)
    _build.check(lib.lu_panel(out.data_ptr(), piv.data_ptr(), m, w,
                              scr_f.data_ptr(), scr_i.data_ptr(),
                              int(a.dtype == torch.bfloat16), _stream()),
                 "parent lu_panel")
    return out, piv


class parent_panels:
    """Inside the block, lu_panel_rec's one-dispatch panels go through
    the parent's kernels (so the tall split's sub-panels do too)."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved = pk._lu_panel_rec_cuda
        pk._lu_panel_rec_cuda = lambda a, ib: parent_panel_rec(self.lib, a,
                                                               ib)

    def __exit__(self, *exc):
        pk._lu_panel_rec_cuda = self.saved


def timed(row, fns, reps):
    """ms and graph_ms of each tree's call, in the order ORDER."""
    for i, who in enumerate(ORDER):
        row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], reps)
        row["graph_ms_%d_%s" % (i, who)] = graph_ms(fns[who], reps)


def chain_rows(libs, rng):
    from slate_tpu_torch.linalg.svd import _givens_chain_matrix
    ok, rows = True, []
    for n_rows, n, trans in ((2048, 2048, False), (512, 512, False),
                             (512, 512, True)):
        th = rng.standard_normal(n - 1)
        cs = torch.as_tensor(np.cos(th), dtype=torch.float32, device="cuda")
        sn = torch.as_tensor(np.sin(th), dtype=torch.float32, device="cuda")
        Z = torch.as_tensor(rng.standard_normal((n, n_rows) if trans
                                                else (n_rows, n)),
                            dtype=torch.float32, device="cuda")
        if trans:
            Z = Z.T
        ref = pk.givens_chain_apply_plain(Z, cs, sn)
        fns = {"parent": lambda: parent_chain(libs["givens_chain"], Z, cs,
                                              sn),
               "change": lambda: pk._givens_chain_launch(Z, cs, sn)}
        row = {"kernel": "givens_chain_apply", "dtype": "float32",
               "shape": "%dx%d%s" % (n_rows, n, " transposed" if trans
                                     else "")}
        for who, fn in fns.items():
            row["bitwise_" + who] = bool(torch.equal(fn(), ref))
            ok &= row["bitwise_" + who]
        timed(row, fns, 20)
        G = _givens_chain_matrix(cs, sn, n)
        row["library_ms"] = cuda_ms(lambda: Z @ G, 20)
        row["library_graph_ms"] = graph_ms(lambda: Z @ G)
        rows.append(row)
    return ok, rows


def panel_rows(libs, rng):
    ok, rows = True, []
    lib = libs["lu_panel_rec"]
    for (dname, dtype), w in ((DTYPES[0], 128), (DTYPES[1], 64),
                              (DTYPES[0], 512), (DTYPES[1], 512)):
        a = torch.as_tensor(rng.standard_normal((N, w), dtype=np.float32),
                            device="cuda").to(dtype)
        pp, ppiv = pk.lu_panel_rec_plain(a)

        def parent():
            with parent_panels(lib):
                return pk.lu_panel_rec(a)

        fns = {"parent": parent, "change": lambda: pk.lu_panel_rec(a)}
        split = N * w > pk._rec_max_elems(dtype, None)
        row = {"kernel": "lu_panel_rec", "dtype": dname,
               "shape": "%dx%d" % (N, w), "split": split}
        got = {}
        for who, fn in fns.items():
            kp, kpiv = got[who] = fn()
            row["pivots_bitwise_" + who] = bool(torch.equal(kpiv, ppiv))
            row["residual_" + who] = lu_residual(a, kp, kpiv)
            # the split's trailing update rounds otherwise than the
            # plain product (bf16 on the tensor cores): held to the
            # residual only, as chip_smoke.py holds it
            ok &= (split or row["pivots_bitwise_" + who]) \
                and row["residual_" + who] <= RES_LIMIT[dtype]
        # the same arithmetic in both trees: equal, pivots and values
        row["parent_equals_change"] = all(
            torch.equal(x, y) for x, y in zip(got["parent"], got["change"]))
        ok &= row["parent_equals_change"]
        timed(row, fns, 5 if w < 512 else 3)
        rows.append(row)
    a = torch.as_tensor(rng.standard_normal((4096, 256), dtype=np.float32),
                        device="cuda").to(torch.bfloat16)
    pp, ppiv = pk.lu_panel_plain(a)
    fns = {"parent": lambda: parent_lu_panel(libs["lu_panel"], a),
           "change": lambda: pk.lu_panel(a)}
    row = {"kernel": "lu_panel", "dtype": "bfloat16", "shape": "4096x256"}
    for who, fn in fns.items():
        kp, kpiv = fn()
        row["pivots_bitwise_" + who] = bool(torch.equal(kpiv, ppiv))
        row["residual_" + who] = lu_residual(a, kp, kpiv)
        ok &= row["pivots_bitwise_" + who] \
            and row["residual_" + who] <= RES_LIMIT[torch.bfloat16]
    timed(row, fns, 5)
    rows.append(row)
    return ok, rows


def retime_rows(rng, seed):
    """qr_panel f32 and ragged_trsm against their library calls, as
    CUDA graphs (their kernels are the same in both trees)."""
    ok, rows = True, []
    a = torch.as_tensor(rng.standard_normal((4096, 128), dtype=np.float32),
                        device="cuda")
    kp, kt = pk._qr_panel_launch(a)
    res = qr_residual(a, kp, kt)
    ok &= res <= 1e-5
    rows.append({"kernel": "qr_panel", "dtype": "float32",
                 "shape": "4096x128", "residual": res,
                 "graph_ms": graph_ms(lambda: pk._qr_panel_launch(a), 10),
                 "ms": cuda_ms(lambda: pk._qr_panel_launch(a), 10),
                 "library_graph_ms": graph_ms(lambda: torch.geqrf(a), 10),
                 "library_ms": cuda_ms(lambda: torch.geqrf(a), 10)})
    sizes, ceil, spd, _gen, rhs = path_stacks(seed)
    sub = plain_subset(sizes)
    szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    for dname, dtype in DTYPES:
        L = pk.ragged_potrf(to_card(spd, dtype), szc)
        b = to_card(rhs, dtype)
        kx = pk.ragged_trsm(L, b, szc)
        px = pk.ragged_trsm_plain(L[sub], b[sub], [sizes[i] for i in sub],
                                  pk.ragged_blk())
        err = scaled_err(kx[sub], px)
        ok &= err <= RAGGED_LIMIT[dtype]
        Lid, b32 = identity_padded(L, sizes).float(), b.float()

        def lib():
            return torch.linalg.solve_triangular(Lid, b32, upper=False)

        rows.append({"kernel": "ragged_trsm", "dtype": dname,
                     "shape": "%dx%dx%d, K = 1" % L.shape, "err": err,
                     "graph_ms": graph_ms(lambda: pk.ragged_trsm(L, b, szc)),
                     "ms": cuda_ms(lambda: pk.ragged_trsm(L, b, szc), 20),
                     "library_graph_ms": graph_ms(lib),
                     "library_ms": cuda_ms(lib, 20)})
    return ok, rows


def phase_kernels(libs, seed):
    rng = np.random.default_rng(seed)
    ok, rows = True, []
    for part in (lambda: chain_rows(libs, rng), lambda: panel_rows(libs, rng),
                 lambda: retime_rows(rng, seed)):
        p_ok, p_rows = part()
        ok &= p_ok
        rows += p_rows
    return {"phase": "kernels", "ok": bool(ok), "rows": rows}


#: run in each tree: chip_smoke.py's gesv and gesv_mixed phases, gesv
#: under the profiler, then heev and svd through their QR iterations
SOLVES = """
import json
import torch
import chip_smoke as cs
import slate_tpu_torch as st
seed = %d
results, system = {}, {}
g = cs.phase_gesv(seed, results, system)
m = cs.phase_mixed(results, system)
cs.fresh_tune_cache([torch.float32])
prof = cs.profile_call(lambda: st.gesv(system["A"], system["B"],
                                       system["opts"]), top=40)
base_ms = sum(t["device_ms"] for t in prof["top"] if "lu_base" in t["kernel"])
del system
gen = torch.Generator(device="cuda").manual_seed(seed)
g2 = torch.randn((cs.N_EIG, cs.N_EIG), generator=gen, device="cuda")
a = (g2 + g2.T) / 2
A = st.HermitianMatrix(st.Uplo.Lower, a, mb=cs.MB_EIG)
cs.fresh_tune_cache()
w_ref, _ = st.heev(A)
cs.route_chain("steqr2", torch.float32, cs.N_EIG)
heev_s, (w, V) = cs.wall_s(lambda: st.heev(
    A, {st.Option.MethodEig: st.MethodEig.QRIteration}))
heev_ok, heev_chk = cs.eig_checks(a.double(), w, V, w_ref,
                                  float(w_ref.abs().max()),
                                  cs.STAGED_EIG_LIMIT)
gen = torch.Generator(device="cuda").manual_seed(seed + 1)
b = torch.randn((cs.N_SVD, cs.N_SVD), generator=gen, device="cuda")
B = st.Matrix(b, mb=cs.MB_SVD)
cs.fresh_tune_cache()
s_ref = st.svd(B).s
cs.route_chain("bdsqr", torch.float32, cs.N_SVD)
svd_s, r = cs.wall_s(lambda: st.svd(
    B, {st.Option.MethodSVD: st.MethodSVD.QRIteration}))
u, vh = r.U.to_dense().double(), r.Vh.to_dense().double()
recon = float(torch.linalg.norm(u * r.s.double()[None, :] @ vh - b.double())
              / torch.linalg.norm(b.double()))
serr = float((r.s.double() - s_ref.double()).abs().max() / s_ref.max())
svd_ok = max(recon, serr) <= cs.EIG_LIMIT
print("SOLVES " + json.dumps({
    "gesv_wall_s": g["wall_s"], "gesv_ok": g["ok"],
    "gesv_backward_error": g["backward_error"],
    "gesv_launches": g["launches"],
    "gesv_mixed_wall_s": m["wall_s"], "gesv_mixed_ok": m["ok"],
    "gesv_mixed_iters": m["iters"],
    "gesv_profile": {"wall_s": prof["wall_s"],
                     "busy_s": prof["device_busy_s"],
                     "idle_share": prof["idle_share"],
                     "lu_base_ms": base_ms,
                     "lu_base_share": base_ms / 1e3 / prof["device_busy_s"],
                     "top": prof["top"][:6]},
    "heev_qr_wall_s": heev_s, "heev_ok": heev_ok, "heev_checks": heev_chk,
    "svd_qr_wall_s": svd_s, "svd_ok": svd_ok,
    "svd_checks": {"reconstruction": recon, "values_vs_auto": serr}}))
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
        ok &= rec["gesv_ok"] and rec["gesv_mixed_ok"] and rec["heev_ok"] \
            and rec["svd_ok"]
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

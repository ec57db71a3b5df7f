#!/usr/bin/env python3
"""Parent against change on one card, in one run: the swap composition
(`compose_swaps`), the tridiagonal and bidiagonal QR passes
(`steqr_sweep`, `bdsqr_sweep`), and the calls on their paths.

    git archive <parent> | tar -x -C smoke_archive/parent
    python3 chip_compare.py --parent smoke_archive/parent

  1. kernels  the parent tree's compose_swaps.cu and qr_sweep.cu are
              compiled from its sources into libraries of their own and
              called through their C entries on the same inputs as this
              tree's wrappers, in the order parent, change, change,
              parent, back to back (`ms`) and replayed from a CUDA graph
              (`graph_ms`): compose_swaps on LU swap sequences over
              16384 rows (gesv's 512 swaps, the recursive panel's split
              sizes 256 ... 32, getrs' 16384), on 512 targets below
              their steps and 512 outside the rows, and on the ragged
              gesv's (64, 608) and (64, 1024) swap stacks (the serving
              stream's first flush and the flush of its order-1024
              request, factored by ragged_getrf), each tree BITWISE
              against compose_swaps_plain (the parent skips targets
              outside the rows, XLA does not: there it is reported, not
              held); one full-width steqr_sweep pass at n = 2048 and one
              bdsqr_sweep pass at n = 512, each tree bitwise against the
              plain version over 3 passes, and this tree's multi-pass
              launch of the path's cap (32 passes), a pass; each row with
              its bound and latency floor (the sweep's: the 4-operation
              one and the bitwise floor, chip_smoke.sweep_floor_ms);
  2. solves   in one process per tree, in the order parent, change,
              change, parent: gesv_mixed at n = 16384 (tiles 512, f32
              and bf16 panels routed to the recursive kernel, as
              chip_smoke.py's phase) once warm and once under
              torch.profiler (compose_swaps' device time, launches and
              share of busy time; wall, busy, idle); heev QRIteration at
              n = 2048 (chip_smoke.py's matrix, the chain routed to
              givens_chain_apply) once warm and once under the profiler:
              the wall, the sweep's device time, passes (the chain's
              launches, one a pass), sweep launches and host reads, and
              digests of the eigenvalues and the eigenvectors, equal
              between the trees; svd QRIteration at n = 512 (chip_smoke's
              matrix, the chain routed) the same way: passes (half the
              chain's launches), sweep launches, host reads and digests
              of s, U and Vh. A tree that reads the count once a pass
              reads it once more before the first (host reads = passes
              + 1); one that reads once a launch, once a launch.

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

from chip_smoke import (N, SWAP_WIDTHS, SWEEPS, bound_ms, compose_latency_ms,
                        cuda_ms, graph_ms, largest_flush, latency_ms,
                        lu_swaps, path_stacks, sweep_bound, sweep_floor_ms,
                        to_card, tridiag, DEP_OP_CYCLES)

ORDER = ("parent", "change", "change", "parent")

#: the parent's C entries
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_LIBS = {
    "compose_swaps": {"compose_swaps": [_P, _I, _I, _I, _P, _P]},
    "qr_sweep": {"steqr_sweep": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P],
                 "bdsqr_sweep": [_P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P,
                                 _P]},
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


def parent_compose(lib, piv, m):
    """The swaps composed by the parent's kernel, as its wrapper called
    it."""
    piv = piv.to(torch.int32).contiguous()
    batch = piv.shape[0] if piv.dim() == 2 else 1
    perm = torch.empty(*piv.shape[:-1], m, dtype=torch.int64,
                       device=piv.device)
    _build.check(lib.compose_swaps(piv.data_ptr(), batch, piv.shape[-1], m,
                                   perm.data_ptr(), _stream()),
                 "parent compose_swaps")
    return perm


def parent_sweep(lib, name, d, e):
    """One pass through the parent's `name` kernel (steqr_sweep: 2
    rotation vectors, bdsqr_sweep: 4), as its wrapper called it."""
    n = d.shape[0]
    dout, eout = torch.empty_like(d), torch.empty_like(e)
    rots = [torch.empty(n - 1, dtype=torch.float32, device=d.device)
            for _ in range(2 if name == "steqr_sweep" else 4)]
    cnt = torch.empty((), dtype=torch.int32, device=d.device)
    _build.check(getattr(lib, name)(
        d.data_ptr(), e.data_ptr(), n, float(torch.finfo(torch.float32).eps),
        dout.data_ptr(), eout.data_ptr(), *[r.data_ptr() for r in rots],
        cnt.data_ptr(), _stream()), "parent " + name)
    return (dout, eout, *rots, cnt)


def timed(row, fns, reps):
    """ms and graph_ms of each tree's call, in the order ORDER."""
    for i, who in enumerate(ORDER):
        row["ms_%d_%s" % (i, who)] = cuda_ms(fns[who], reps)
        row["graph_ms_%d_%s" % (i, who)] = graph_ms(fns[who], reps)


def ragged_swaps(seed):
    """The ragged gesv's swap stacks of the two flushes: ragged_getrf's
    pivots on the serving stream's stacks, with their ceilings."""
    out = []
    for flush in (0, largest_flush(seed)):
        sizes, ceil, _spd, gen, _rhs = path_stacks(seed, flush)
        a = to_card(gen, torch.float32)
        szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        out.append(("ragged.%d" % ceil, pk.ragged_getrf(a, szc)[1], ceil))
        del a
    return out


def compose_rows(lib, seed):
    rng = np.random.default_rng(seed)
    cases = [("lu.%d" % w, torch.as_tensor(lu_swaps(rng, N, w),
                                           device="cuda"), N)
             for w in SWAP_WIDTHS + (N,)]
    cases += [("any.512", torch.as_tensor(
        rng.integers(0, N, 512).astype(np.int32), device="cuda"), N),
              ("out_of_range.512", torch.as_tensor(
                  rng.integers(-2 * N, 2 * N, 512).astype(np.int32),
                  device="cuda"), N)]
    cases += ragged_swaps(seed)
    ok, rows = True, []
    for label, piv, m in cases:
        ref = pk.compose_swaps_plain(piv, m)
        fns = {"parent": lambda: parent_compose(lib, piv, m),
               "change": lambda: pk.lu_pivots_to_permutation(piv, m)}
        row = {"kernel": "compose_swaps", "case": label,
               "shape": "%s swaps over %d" % ("x".join(
                   map(str, piv.shape)), m)}
        for who, fn in fns.items():
            row["bitwise_plain_" + who] = bool(torch.equal(fn(), ref))
        ok &= row["bitwise_plain_change"] and (
            row["bitwise_plain_parent"] or label == "out_of_range.512")
        timed(row, fns, 50)
        B = piv.shape[0] if piv.dim() == 2 else 1
        b, by = bound_ms(0.0, B * (4.0 * piv.shape[-1] + 8.0 * m))
        row.update(bound_ms=b, bound_by=by, library_ms=None,
                   latency_bound_ms=compose_latency_ms(piv.shape[-1]))
        rows.append(row)
    return ok, rows


def sweep_rows(lib, seed, name):
    """The sweep `name` (a key of chip_smoke.SWEEPS) at its path's
    order, the parent's kernel beside this tree's."""
    run, plain, multi, _mp, k, floor, n, _path, _line = SWEEPS[name]
    d0, e0 = tridiag(np.random.default_rng(seed), n)
    fns = {"parent": lambda: parent_sweep(lib, name, d0, e0),
           "change": lambda: run(d0, e0)}
    row = {"kernel": name, "shape": "n = %d, one pass" % n}
    ok = True
    for who, step in (("parent", lambda d, e: parent_sweep(lib, name, d, e)),
                      ("change", run)):
        d, e, same = d0, e0, []
        for _ in range(3):
            got = step(d, e)
            same.append(all(torch.equal(a, b) for a, b in
                            zip(got, plain(d, e))))
            d, e = got[0], got[1]
        row["bitwise_plain_" + who] = same
        ok &= all(same)
    timed(row, fns, 20)
    ran = multi(d0, e0, k)[-1].tolist()
    row["multi_pass_graph_ms_a_pass"] = graph_ms(
        lambda: multi(d0, e0, k), 3) / max(ran[0], 1)
    row["multi_pass_ran"] = ran
    b, by = sweep_bound(n - 1, n, len(got) - 3)
    row.update(bound_ms=b, bound_by=by, library_ms=None,
               latency_bound_ms=latency_ms(n - 1, 4 * DEP_OP_CYCLES))
    row["bitwise_floor_ms"], row["floor_cycles_per_step"] = \
        sweep_floor_ms(floor, d0, e0)
    return ok, [row]


def phase_kernels(libs, seed):
    ok, rows = True, []
    for part in (lambda: compose_rows(libs["compose_swaps"], seed),
                 lambda: sweep_rows(libs["qr_sweep"], seed, "steqr_sweep"),
                 lambda: sweep_rows(libs["qr_sweep"], seed, "bdsqr_sweep")):
        p_ok, p_rows = part()
        ok &= p_ok
        rows += p_rows
    return {"phase": "kernels", "ok": bool(ok), "rows": rows}


#: run in each tree (only what both trees' chip_smoke.py have): gesv_mixed
#: at n = 16384 warm and under the profiler, then heev QRIteration at
#: n = 2048 and svd QRIteration at n = 512, each warm and under the
#: profiler
SOLVES = """
import hashlib
import json
import numpy as np
import torch
import chip_smoke as cs
import slate_tpu_torch as st
from slate_tpu_torch.ops import kernels as pk
seed = %d


def digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def share(prof, subs):
    hits = [t for t in prof["top"] if any(s in t["kernel"] for s in subs)]
    ms = sum(t["device_ms"] for t in hits)
    return {"device_ms": ms, "calls": sum(t["calls"] for t in hits),
            "busy_share": ms / 1e3 / prof["device_busy_s"]}


out = {}
cs.fresh_tune_cache([torch.float32, torch.bfloat16])
a_np, b_np = cs.permuted_boosted_system(np.random.default_rng(seed), cs.N,
                                        cs.NRHS)
A, B = st.Matrix(a_np, mb=cs.NB), st.Matrix(b_np, mb=cs.NB)
del a_np, b_np
opts = {st.Option.BlockSize: cs.NB}
st.gesv_mixed(A, B, opts)
pk.reset_launch_counts()
wall, (F, X, iters) = cs.wall_s(lambda: st.gesv_mixed(A, B, opts))
launches = pk.launch_counts()
prof = cs.profile_call(lambda: st.gesv_mixed(A, B, opts), top=400)
out["gesv_mixed"] = {
    "wall_s": wall, "iters": int(iters),
    "backward_error": cs.berr(A, X, B),
    "compose_swaps_launches": launches["compose_swaps"],
    "pivots_digest": digest(F.pivots),
    "profile": {"wall_s": prof["wall_s"], "busy_s": prof["device_busy_s"],
                "idle_share": prof["idle_share"], "top": prof["top"][:6]},
    "compose_swaps": share(prof, ("compose_swaps",))}
del A, B, F, X
gen = torch.Generator(device="cuda").manual_seed(seed)
g = torch.randn((cs.N_EIG, cs.N_EIG), generator=gen, device="cuda")
E = st.HermitianMatrix(st.Uplo.Lower, (g + g.T) / 2, mb=cs.MB_EIG)
del g
cs.route_chain("steqr2", torch.float32, cs.N_EIG)
eopts = {st.Option.MethodEig: st.MethodEig.QRIteration}
st.heev(E, eopts)
pk.reset_launch_counts()
wall, (w, V) = cs.wall_s(lambda: st.heev(E, eopts))
launches = pk.launch_counts()
prof = cs.profile_call(lambda: st.heev(E, eopts), top=400)
passes = launches["givens_chain_apply"]
out["heev_qr_iteration"] = {
    "wall_s": wall, "passes": passes,
    "sweep_launches": launches["steqr_sweep"],
    "w_digest": digest(w), "v_digest": digest(V.to_dense()),
    "profile": {"wall_s": prof["wall_s"], "busy_s": prof["device_busy_s"],
                "idle_share": prof["idle_share"], "top": prof["top"][:6]},
    "sweep": share(prof, ("steqr_sweep",)),
    "chain": share(prof, ("givens_chain",))}
del E, w, V
gen = torch.Generator(device="cuda").manual_seed(seed + 1)
S = st.Matrix(torch.randn((cs.N_SVD, cs.N_SVD), generator=gen,
                          device="cuda"), mb=cs.MB_SVD)
cs.route_chain("bdsqr", torch.float32, cs.N_SVD)
sopts = {st.Option.MethodSVD: st.MethodSVD.QRIteration}
st.svd(S, sopts)
pk.reset_launch_counts()
wall, res = cs.wall_s(lambda: st.svd(S, sopts))
launches = pk.launch_counts()
prof = cs.profile_call(lambda: st.svd(S, sopts), top=400)
out["svd_qr_iteration"] = {
    "wall_s": wall, "passes": launches["givens_chain_apply"] // 2,
    "sweep_launches": launches["bdsqr_sweep"],
    "s_digest": digest(res.s), "u_digest": digest(res.U.to_dense()),
    "vh_digest": digest(res.Vh.to_dense()),
    "profile": {"wall_s": prof["wall_s"], "busy_s": prof["device_busy_s"],
                "idle_share": prof["idle_share"], "top": prof["top"][:6]},
    "sweep": share(prof, ("bdsqr_sweep",)),
    "chain": share(prof, ("givens_chain",))}
print("SOLVES " + json.dumps(out))
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
        for part in ("heev_qr_iteration", "svd_qr_iteration"):
            h = rec[part]
            # one launch a pass: the count read after every pass and
            # once before; multi-pass launches: once a launch
            h["host_reads"] = h["passes"] + 1 \
                if h["sweep_launches"] == h["passes"] else h["sweep_launches"]
            ok &= h["passes"] > 0
        ok &= rec["gesv_mixed"]["backward_error"] <= 1e-6
        runs.append(rec)
    same = {k: len({r.get(part, {}).get(k) for r in runs}) == 1
            for part, k in (("gesv_mixed", "pivots_digest"),
                            ("heev_qr_iteration", "w_digest"),
                            ("heev_qr_iteration", "v_digest"),
                            ("svd_qr_iteration", "s_digest"),
                            ("svd_qr_iteration", "u_digest"),
                            ("svd_qr_iteration", "vh_digest"))}
    return {"phase": "solves", "ok": bool(ok and all(same.values())),
            "equal_between_trees": same, "runs": runs}


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

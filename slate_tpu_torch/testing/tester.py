"""Parameter-sweep tester CLI (counterpart of
``slate_tpu/testing/tester.py``; the reference's test/ ``tester``
binary on TestSweeper, SURVEY §4 tier 2).

Sweeps routine x dim x dtype x block size x grid, times each config,
computes GFLOP/s and a residual check (reference-style error bounds,
or --ref y to compare against numpy/scipy on the host: the
ScaLAPACK-compare role).

Usage:
    python -m slate_tpu_torch.testing.tester gemm potrf \\
        --dim 256:1024:*2 --type s,d --nb 64,128 --grid 1x1 --check y \\
        [--device cuda]

Differences from the reference:

  * the device: ``--device`` (default ``cuda``) names where the inputs
    and the drivers run; without a card and without ``--device cpu``
    the tester raises (``utils.backend.resolve_device``). There is no
    probe-and-fall-back-to-the-CPU;
  * the inputs: drawn from a ``torch.Generator`` on that device, seeded
    with `seed` (the reference draws with numpy on the host), by the
    same formulas (Gaussian; ``a a^H / n + 4 I`` for SPD; ``(a + a^H)
    / 2`` for Hermitian), in f64 and then cast;
  * the check: the reference's error ratios, computed with torch on the
    device that holds the result (the reference computes them in numpy
    on the host, minutes of host O(n^3) work a routine at n = 16384).
    The clock starts before the inputs are made and stops once the
    result is on the host, as the reference's does. ``--ref y`` computes
    its reference on the host with numpy / scipy, as the reference;
  * the grid: a ``p x q`` grid larger than the ``torch.distributed``
    world is skipped with a note (the reference skips grids larger than
    its device count). Inside a world of p q ranks every rank runs the
    sweep on the global matrices, and the drivers take ``Option.Grid``
    + ``MethodFactor.Tiled``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch

DTYPES = {"s": np.float32, "d": np.float64,
          "c": np.complex64, "z": np.complex128}

_TORCH = {np.float32: torch.float32, np.float64: torch.float64,
          np.complex64: torch.complex64, np.complex128: torch.complex128}


def _parse_dims(spec: str):
    out = []
    for part in spec.split(","):
        if ":" in part:
            lo, hi, step = part.split(":")
            lo, hi = int(lo), int(hi)
            if step.startswith("*"):
                f = int(step[1:])
                v = lo
                while v <= hi:
                    out.append(v)
                    v *= f
            else:
                out.extend(range(lo, hi + 1, int(step)))
        else:
            out.append(int(part))
    return out


def _gflops(routine: str, m: int, n: int, k: int) -> float:
    f = {
        "gemm": 2.0 * m * n * k,
        "potrf": m ** 3 / 3.0,
        "posv": m ** 3 / 3.0 + 2.0 * m * m * k,
        "getrf": 2.0 * m ** 3 / 3.0,
        "gesv": 2.0 * m ** 3 / 3.0 + 2.0 * m * m * k,
        "geqrf": 2.0 * m * n * n - 2.0 * n ** 3 / 3.0,
        "gels": 2.0 * m * n * n,
        "trsm": 1.0 * m * m * k,
        "herk": 1.0 * m * m * k,
        "heev": 4.0 * m ** 3 / 3.0,
        "svd": 4.0 * m * n * min(m, n),
        "hesv": m ** 3 / 3.0 + 2.0 * m * m * k,
        # band routines: FLOPs depend on kd; the sweep reports time
        # only (gflops column 0), like the reference tester's norm rows
    }.get(routine, 0.0)
    return f / 1e9


def _mk_band(a, kd):
    """Zero a outside the band |i - j| <= kd (no index-array scratch)."""
    return a.tril(kd).triu(-kd)


def _norm(x) -> float:
    return float(torch.linalg.norm(x))


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def run_one(routine: str, n: int, dtype, nb: int, check: bool,
            ref: bool, seed: int = 42, grid=None, device=None) -> Dict:
    """Run one (routine, n, dtype, nb[, grid]) config on `device` (the
    card unless named). With a ProcessGrid the drivers get Option.Grid
    + MethodFactor.Tiled: the reference tester's ``-p -q`` grid sweep
    (test.cc:685)."""
    import slate_tpu_torch as st
    from ..core.methods import MethodFactor
    from ..core.options import Option
    from ..utils.backend import resolve_device

    dev = resolve_device(device if grid is None else grid.device)
    opts = None
    if grid is not None:
        opts = {Option.Grid: grid, Option.MethodFactor: MethodFactor.Tiled}

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tdt = _TORCH[np.dtype(dtype).type]
    real = np.float64 if dtype in (np.float64, np.complex128) \
        else np.float32
    eps = float(np.finfo(real).eps)

    def draw(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device=dev)

    def mk(shape, herm=False, spd=False):
        a = draw(shape)
        if tdt.is_complex:
            a = a + 1j * draw(shape)
        if spd:
            a = a @ a.conj().T / shape[0] + 4 * torch.eye(
                shape[0], dtype=a.dtype, device=dev)
        elif herm:
            a = (a + a.conj().T) / 2
        return a.to(tdt)

    def M(x, **kw):
        return st.Matrix(x, mb=nb, device=dev, **kw)

    def cond(x):
        return max(np.linalg.cond(x), 1.0)

    nrhs = 10
    t0 = time.perf_counter()
    err = None
    if routine == "gemm":
        a, b, c = mk((n, n)), mk((n, n)), mk((n, n))
        C = st.gemm(1.0, M(a), M(b), 0.0, M(c), opts)
        out = C.to_dense()
        _host(out)
        t = time.perf_counter() - t0
        if check:
            err = _norm(out - a @ b) / (_norm(a) * _norm(b) * n * eps)
        if ref:
            # --ref y: direct comparison to the numpy result (the
            # reference tester's ScaLAPACK-compare role)
            ab = _host(a) @ _host(b)
            err = np.linalg.norm(_host(out) - ab) / (
                np.linalg.norm(ab) * n * eps + 1e-300)
    elif routine in ("potrf", "posv"):
        a = mk((n, n), spd=True)
        A = st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, device=dev)
        if routine == "potrf":
            L = st.potrf(A, opts)
            out = L.to_dense()
            _host(out)
            t = time.perf_counter() - t0
            if check:
                err = _norm(out @ out.conj().T - a) / (_norm(a) * n * eps)
            if ref:
                lref = np.linalg.cholesky(_host(a))
                err = np.linalg.norm(np.tril(_host(out)) - lref) / (
                    np.linalg.norm(lref) * n * eps + 1e-300)
        else:
            b = mk((n, nrhs))
            _, X = st.posv(A, M(b), opts)
            x = X.to_dense()
            _host(x)
            t = time.perf_counter() - t0
            if check:
                err = _norm(b - a @ x) / (_norm(a) * _norm(x) * n * eps)
            if ref:
                ah = _host(a)
                xr = np.linalg.solve(ah, _host(b))
                err = np.linalg.norm(_host(x) - xr) / (
                    np.linalg.norm(xr) * n * eps * cond(ah))
    elif routine in ("getrf", "gesv"):
        a = mk((n, n))
        if routine == "getrf":
            F = st.getrf(M(a), opts)
            out = F.LU.to_dense()
            _host(out)
            t = time.perf_counter() - t0
            if check:
                L = out.tril(-1) + torch.eye(n, dtype=out.dtype,
                                             device=dev)
                U = out.triu()
                # P A from the swap sequence (the reference swaps the
                # rows one by one in a Python loop)
                piv = _host(F.pivots)[:n]
                perm = np.arange(n)
                for j in range(n):
                    perm[[j, piv[j]]] = perm[[piv[j], j]]
                pa = a[torch.as_tensor(perm, device=dev)]
                err = _norm(L @ U - pa) / (_norm(a) * n * eps)
            if ref:
                # external reference via SOLVES: element-wise factor
                # comparison against scipy assumes identical pivot
                # choices, which near-tie magnitudes legitimately
                # break. Solving the same rhs through both factor
                # stacks compares the factorizations' actual function
                # while staying pivot-choice-independent.
                import scipy.linalg as _sla
                b = mk((n, nrhs))
                ah = _host(a)
                xr = _sla.lu_solve(_sla.lu_factor(ah), _host(b))
                x = st.getrs(F, M(b), opts).to_numpy()
                err = np.linalg.norm(x - xr) / (
                    np.linalg.norm(xr) * n * eps * cond(ah) + 1e-300)
        else:
            b = mk((n, nrhs))
            _, X = st.gesv(M(a), M(b), opts)
            x = X.to_dense()
            _host(x)
            t = time.perf_counter() - t0
            if check:
                err = _norm(b - a @ x) / (_norm(a) * _norm(x) * n * eps)
            if ref:
                ah = _host(a)
                xr = np.linalg.solve(ah, _host(b))
                err = np.linalg.norm(_host(x) - xr) / (
                    np.linalg.norm(xr) * n * eps * cond(ah))
    elif routine in ("geqrf", "gels"):
        m2 = n
        a = mk((m2, n))
        if routine == "geqrf":
            F = st.geqrf(M(a), opts)
            R = F.QR.to_dense().triu()
            _host(R)
            t = time.perf_counter() - t0
            if check:
                eye = torch.eye(m2, dtype=tdt, device=dev)
                Q = st.unmqr(st.Side.Left, F, M(eye),
                             trans=False).to_dense()
                err = _norm(Q @ R - a) / (_norm(a) * n * eps)
        else:
            b = mk((m2, nrhs))
            X = st.gels(M(a), M(b), opts)
            x = X.to_dense()[:n]
            _host(x)
            t = time.perf_counter() - t0
            if check:
                # normal-equations residual for LS solutions
                rr = b - a @ x
                err = _norm(a.conj().T @ rr) / (
                    _norm(a) ** 2 * _norm(x) * n * eps)
            if ref:
                ah = _host(a)
                xr = np.linalg.lstsq(ah, _host(b), rcond=None)[0]
                err = np.linalg.norm(_host(x) - xr) / (
                    np.linalg.norm(xr) * n * eps * cond(ah))
    elif routine == "heev":
        a = mk((n, n), herm=True)
        A = st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, device=dev)
        w, V = st.heev(A, opts)
        v = V.to_dense()
        _host(v)
        t = time.perf_counter() - t0
        if check:
            err = _norm(a @ v - v * w[None, :].to(v.dtype)) / (
                _norm(a) * n * eps)
        if ref:
            wr = np.linalg.eigvalsh(_host(a))
            err = np.linalg.norm(_host(w)[:n] - wr) / (
                np.linalg.norm(wr) * n * eps + 1e-300)
    elif routine == "svd":
        a = mk((n, n))
        s, U, Vh = st.svd(M(a), opts)
        u, vh = U.to_dense(), Vh.to_dense()
        _host(u), _host(vh)
        t = time.perf_counter() - t0
        if check:
            rec = (u * s[None, :].to(u.dtype)) @ vh
            err = _norm(rec - a) / (_norm(a) * n * eps)
        if ref:
            sr = np.linalg.svd(_host(a), compute_uv=False)
            err = np.linalg.norm(_host(s)[: len(sr)] - sr) / (
                np.linalg.norm(sr) * n * eps + 1e-300)
    elif routine == "hesv":
        a = mk((n, n), herm=True)        # indefinite
        b = mk((n, nrhs))
        A = st.HermitianMatrix(st.Uplo.Lower, a, mb=nb, device=dev)
        _, X = st.hesv(A, M(b), opts)
        x = X.to_dense()
        _host(x)
        t = time.perf_counter() - t0
        if check:
            err = _norm(b - a @ x) / (_norm(a) * _norm(x) * n * eps)
        if ref:
            ah = _host(a)
            xr = np.linalg.solve(ah, _host(b))
            err = np.linalg.norm(_host(x) - xr) / (
                np.linalg.norm(xr) * n * eps * cond(ah))
    elif routine in ("gbsv", "pbsv"):
        kd = max(min(nb // 2, n // 4), 1)
        a = _mk_band(mk((n, n)), kd)
        eye = torch.eye(n, dtype=tdt, device=dev)
        if routine == "pbsv":
            a = ((a + a.conj().T) / 2 + 4 * np.sqrt(n) * eye).to(tdt)
            A = st.HermitianBandMatrix(st.Uplo.Lower, kd, a, mb=nb,
                                       device=dev)
            solve = st.pbsv
        else:
            a = (a + 4 * eye).to(tdt)
            A = st.BandMatrix(kd, kd, a, mb=nb, device=dev)
            solve = st.gbsv
        b = mk((n, nrhs))
        _, X = solve(A, M(b), opts)
        x = X.to_dense()
        _host(x)
        t = time.perf_counter() - t0
        if check:
            err = _norm(b - a @ x) / (_norm(a) * _norm(x) * n * eps)
        if ref:
            import scipy.linalg as _sla
            ah, bh = _host(a), _host(b)
            if routine == "pbsv":
                ab = np.zeros((kd + 1, n), ah.dtype)
                for i in range(kd + 1):
                    ab[i, : n - i] = np.diagonal(ah, -i)
                xr = _sla.solveh_banded(ab, bh, lower=True)
            else:
                ab = np.zeros((2 * kd + 1, n), ah.dtype)
                for i in range(-kd, kd + 1):
                    row = kd - i
                    if i >= 0:
                        ab[row, i:] = np.diagonal(ah, i)
                    else:
                        ab[row, : n + i] = np.diagonal(ah, i)
                xr = _sla.solve_banded((kd, kd), ab, bh)
            err = np.linalg.norm(_host(x) - xr) / (
                np.linalg.norm(xr) * n * eps * cond(ah))
    elif routine == "gbmm":
        kd = max(min(nb // 2, n // 4), 1)
        a = _mk_band(mk((n, n)), kd)
        b = mk((n, n))
        A = st.BandMatrix(kd, kd, a, mb=nb, device=dev)
        C = st.gbmm(1.0, A, M(b), 0.0, M(torch.zeros_like(b)), opts)
        out = C.to_dense()
        _host(out)
        t = time.perf_counter() - t0
        if check or ref:
            # the plain product IS the external reference here
            err = _norm(out - a @ b) / (
                _norm(a) * _norm(b) * n * eps + 1e-300)
    else:
        # ValueError (not SystemExit) so sweep() records one FAILED row
        # and the rest of the sweep still runs
        raise ValueError(f"unknown routine {routine}")

    if err is not None:
        err = float(err)
    k_inner = n if routine == "gemm" else nrhs
    gf = _gflops(routine, n, n, k_inner) / t if t > 0 else 0.0
    status = "pass" if (err is None or err < 100) else "FAILED"
    return dict(routine=routine, n=n, dtype=np.dtype(dtype).name, nb=nb,
                time=t, gflops=gf, error=err, status=status)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("routines", nargs="+")
    p.add_argument("--dim", default="256")
    p.add_argument("--type", default="s", dest="types")
    p.add_argument("--nb", default="64")
    p.add_argument("--grid", default="1x1",
                   help="p x q process grid (over the ranks of the "
                        "torch.distributed world)")
    p.add_argument("--check", default="y")
    p.add_argument("--ref", default="n")
    p.add_argument("--device", default="cuda",
                   help="where the drivers run (default: the card)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write a Perfetto/Chrome trace JSON of the "
                        "sweep (obs event bus: driver spans, phases, "
                        "tuner decisions) to PATH")
    return p


def run(args, out=None):
    """The sweep of parsed arguments, with its trace; returns the
    rows. The table goes to `out` (default: the current stdout)."""
    out = out or sys.stdout
    from ..utils.backend import resolve_device
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(f"# device: {dev} ({name})", file=out)
    if args.trace_out:
        from .. import obs
        obs.enable()
    rows = sweep(args.routines, args.dim, args.types, args.nb,
                 args.grid, args.check == "y", args.ref == "y", out=out,
                 device=dev)
    if args.trace_out:
        from ..obs import export as obs_export
        obs_export.write_trace(args.trace_out, clear=True)
        print(f"# trace written: {args.trace_out}", file=out)
    return rows


def main(argv=None):
    rows = run(parser().parse_args(argv))
    nfail = sum(r["status"] == "FAILED" for r in rows)
    print(f"\n{'All tests passed' if nfail == 0 else f'{nfail} FAILED'}")
    return 1 if nfail else 0


def _parse_grids(spec: str, device=None, out=None):
    """'1x1,2x2' -> ProcessGrid list (None for 1 x 1); grids needing
    more ranks than the torch.distributed world holds are skipped with
    a note (the reference Jenkinsfile-mpi runs the same sweep at
    --np 4)."""
    import torch.distributed as dist

    from ..parallel.mesh import make_grid
    grids = []
    nd = dist.get_world_size() if dist.is_initialized() else 1
    for part in spec.split(","):
        p, q = (int(x) for x in part.lower().split("x"))
        if p * q > nd:
            print(f"# grid {p}x{q} skipped: only {nd} ranks",
                  file=out or sys.stdout)
            continue
        grids.append(make_grid(p, q, device=device) if p * q > 1
                     else None)
    return grids or [None]


def sweep(routines, dim_spec, type_spec, nb_spec, grid_spec,
          check=True, ref=False, out=None, device=None):
    """The full sweep loop, reusable by run_tests.py; returns result
    row dicts (each also carries 'grid')."""
    out = out or sys.stdout
    dims = _parse_dims(dim_spec)
    nbs = [int(x) for x in nb_spec.split(",")]
    types = [DTYPES[t] for t in type_spec.split(",")]
    grids = _parse_grids(grid_spec, device, out)

    header = (f"{'routine':10s} {'type':8s} {'n':>7s} {'nb':>5s} "
              f"{'grid':>6s} {'time(s)':>9s} {'gflops':>9s} "
              f"{'error':>10s}  status")
    print(header, file=out)
    print("-" * len(header), file=out)
    rows = []
    for routine in routines:
        for dtype in types:
            for n in dims:
                for nb in nbs:
                    for grid in grids:
                        gname = "1x1" if grid is None \
                            else f"{grid.p}x{grid.q}"
                        try:
                            r = run_one(routine, n, dtype, nb, check,
                                        ref, grid=grid, device=device)
                        except Exception as e:   # noqa: BLE001
                            r = dict(routine=routine, n=n,
                                     dtype=np.dtype(dtype).name, nb=nb,
                                     time=0.0, gflops=0.0, error=None,
                                     status="FAILED",
                                     detail=f"{type(e).__name__}: {e}")
                        r["grid"] = gname
                        err = "-" if r["error"] is None \
                            else f"{r['error']:.2e}"
                        shown = r["status"] if r["status"] == "pass" \
                            else (r.get("detail", r["status"])[:40]
                                  or "FAILED")
                        print(f"{r['routine']:10s} {r['dtype']:8s} "
                              f"{n:7d} {nb:5d} {gname:>6s} "
                              f"{r['time']:9.3f} {r['gflops']:9.1f} "
                              f"{err:>10s}  {shown}", file=out)
                        if r["status"] != "pass":
                            r["status"] = "FAILED"
                        rows.append(r)
    return rows


if __name__ == "__main__":
    sys.exit(main())

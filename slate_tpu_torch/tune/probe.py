"""Microbenchmark driver (counterpart of ``slate_tpu/tune/probe.py``):
measures candidate configurations on the device and writes the winners
into the persistent cache (tune/cache.py).

Timing discipline, as in the reference:

  * warm-up and steady state are separated: the first call of every
    candidate is not timed. It absorbs what a first call costs once:
    the ``nvcc`` build of a hand kernel's library, cuBLAS / cuSOLVER
    handle and workspace set-up, the caching allocator's first blocks;
  * the reported figure is the minimum over reps (the noise floor);
  * too-fast guards: when one call is below ``min_time``, calls are
    chained until the measured span is above it, and the per-call time
    is the span divided by the chain length.

Each measured span ends with ``torch.cuda.synchronize()`` on the
output's device (the reference's ``block_until_ready``); on the CPU the
host clock alone measures it.

Inputs are drawn from a seeded ``torch.Generator`` on the target device,
so they differ from the reference's ``jax.random`` draws; the
decisions do not depend on them. Probing is never automatic: it runs
only through :func:`autotune`. The drivers only READ the cache
(tune/select.py), so a cold start stays probe-free.

``probe_ooc_panel`` times the streamed Cholesky (linalg/ooc.py) on
host-resident input at the frozen panel width and at each candidate
width; ``autotune(ops=("ooc",))`` persists a winner as the
``ooc/panel_cols`` every streaming driver resolves.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from ..ops.kernels import _torch_dtype
from . import cache as _cache
from . import stats

#: a probed winner must beat the default baseline by this relative
#: margin before it is persisted: noise-level "wins" (including over a
#: candidate configuration identical to the default) stay uncached
WIN_MARGIN = 0.02


def _sync(out) -> None:
    """Wait until the device work behind the tensor `out` is done: a
    CUDA synchronize on its device; nothing on the CPU."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure(fn, warmup: int = 1, reps: int = 3,
            min_time: float = 0.02) -> float:
    """Steady-state seconds per call of zero-arg `fn` (module doc)."""
    for _ in range(max(warmup, 1)):
        _sync(fn())                          # build, set-up, first fill
    # size the chain so one rep's span is measurable
    t0 = time.perf_counter()
    _sync(fn())
    once = time.perf_counter() - t0
    k = max(1, int(min_time / max(once, 1e-9)))
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = fn()
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / k)
    return best


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _spd(n: int, dtype, device=None):
    """(x, S): a Gaussian n x n matrix and S = x x^T / n + 4 I, drawn in
    f32 on `device` from a seeded generator, then cast to `dtype`."""
    from ..utils.backend import resolve_device
    dev = resolve_device(device)
    x = torch.randn((n, n), generator=_generator(dev), device=dev,
                    dtype=torch.float32)
    s = x @ x.T / n + 4.0 * torch.eye(n, dtype=torch.float32, device=dev)
    dt = _torch_dtype(dtype)
    return x.to(dt), s.to(dt)


def _tiled(data: torch.Tensor, mtype, uplo, nb: int):
    from ..core.tiles import TiledMatrix
    return TiledMatrix.from_dense(data, nb, nb, mtype=mtype, uplo=uplo,
                                  device=data.device)


def _blocksize_runner(op: str, n: int, dtype, device=None):
    """Build the op's timed closure factory: cand -> zero-arg fn. The
    candidate block size enters through the channel the driver tunes
    on: getrf / geqrf through Option.BlockSize; potrf through the tile
    geometry (Tiled method). The potrf winner is ADVISORY (tile-size
    guidance for callers): the potrf driver takes its block size from
    the caller's tiles, so a cached potrf "nb" is never auto-selected.
    cand=None measures the driver's own default configuration (no
    explicit block size), the before baseline."""
    from ..core.enums import MatrixType, Uplo
    from ..core.methods import MethodFactor
    from ..core.options import Option
    from .. import linalg
    x, spd = _spd(n, dtype, device)

    if op == "potrf":
        def mk(cand):
            A = _tiled(spd, MatrixType.Hermitian, Uplo.Lower, cand or 256)
            opts = {Option.MethodFactor: MethodFactor.Tiled}
            return lambda: linalg.potrf(A, opts).data
        return mk
    if op == "getrf":
        def mk(cand):
            G = _tiled(x, MatrixType.General, Uplo.General, min(256, n))
            opts = {Option.BlockSize: cand} if cand else None
            return lambda: linalg.getrf(G, opts).LU.data
        return mk
    if op == "geqrf":
        def mk(cand):
            G = _tiled(x, MatrixType.General, Uplo.General, min(256, n))
            # cand=None is the true Auto default (Fused up to the
            # fused_max_n crossover); candidates pin Tiled with an
            # explicit width, and a Tiled winner is cached together
            # with fused_max_n=0 so the driver routes to it (autotune)
            opts = ({Option.BlockSize: cand,
                     Option.MethodFactor: MethodFactor.Tiled}
                    if cand else None)
            return lambda: linalg.geqrf(G, opts).QR.data
        return mk
    raise KeyError("probe_blocksize: unknown op %r" % op)


def probe_blocksize(op: str, n: int, dtype, candidates: Sequence[int],
                    reps: int = 3, device=None) -> List[Dict]:
    """Time `op` at size n for the driver's OWN default configuration
    (entry {"nb": None}, measured with cached entries bypassed: the
    cold-cache baseline every winner must beat) plus every candidate
    nb. Returns fastest first."""
    from ..obs import events as obs
    from . import select as _select
    t0 = time.perf_counter()
    mk = _blocksize_runner(op, n, dtype, device)
    out = []
    with obs.span("tune::probe::%s" % op, cat="tune"):
        with _select.disabled():
            out.append({"nb": None, "seconds": measure(mk(None),
                                                       reps=reps)})
        for cand in candidates:
            t = measure(mk(int(cand)), reps=reps)
            out.append({"nb": int(cand), "seconds": t})
    stats.add_probe_time(time.perf_counter() - t0)
    return sorted(out, key=lambda d: d["seconds"])


def probe_method_eig(n: int, dtype, reps: int = 2,
                     device=None) -> List[Dict]:
    """Time heev's Auto default route (the library eigensolver: the
    baseline a cached decision must beat) against the staged pipelines
    (MethodEig.DC: two-stage divide and conquer; MethodEig.QRIteration:
    two-stage QR iteration) at size n. Fastest first; "auto" winning
    means keep the default. Runs under select.disabled(), so Auto is the
    frozen default and not a previously cached reroute."""
    from ..core.enums import MatrixType, Uplo
    from ..core.methods import MethodEig
    from ..core.options import Option
    from ..obs import events as obs
    from .. import linalg
    from . import select as _select
    t0 = time.perf_counter()
    _, spd = _spd(n, dtype, device)
    A = _tiled(spd, MatrixType.Hermitian, Uplo.Lower, min(128, n))
    candidates = [
        ("auto", None),
        ("dc", {Option.MethodEig: MethodEig.DC}),
        ("qr_iteration", {Option.MethodEig: MethodEig.QRIteration}),
    ]
    out = []
    with obs.span("tune::probe::heev", cat="tune"), _select.disabled():
        for label, mopts in candidates:
            t = measure(lambda mo=mopts: linalg.heev(A, mo).values,
                        reps=reps)
            out.append({"method": label, "seconds": t})
    stats.add_probe_time(time.perf_counter() - t0)
    return sorted(out, key=lambda d: d["seconds"])


def probe_lu_panel(m: int, w: int, dtype, reps: int = 3,
                   device=None) -> List[Dict]:
    """Time the LU panel-route candidates at (m, w): the cold-default
    route (entry {"method": None}: lu._lu_panel with cached entries
    bypassed, the baseline a winner must beat), the column loop
    ("fori"), and the two hand kernels (the rank-1 "pallas" and the
    recursive "pallas_rec") where their entry gates take the panel: a
    CUDA tensor of a type and shape the kernel takes. Off the card the
    gates reject, as the reference's do off the TPU. A build or launch
    error of a kernel propagates. Fastest first; a persisted winner
    reroutes _lu_panel for the whole (backend, device, dtype, bucket)
    class, and through it every LU consumer."""
    from ..linalg.lu import _lu_panel, lu_panel_fori
    from ..obs import events as obs
    from ..ops import kernels as pk
    from ..utils.backend import resolve_device
    from . import select as _select
    t0 = time.perf_counter()
    dev = resolve_device(device)
    p = torch.randn((m, w), generator=_generator(dev), device=dev,
                    dtype=torch.float32).to(_torch_dtype(dtype))
    out = []
    with obs.span("tune::probe::lu_panel", cat="tune"):
        with _select.disabled():
            out.append({"method": None,
                        "seconds": measure(lambda: _lu_panel(p)[0],
                                           reps=reps)})
        out.append({"method": "fori",
                    "seconds": measure(lambda: lu_panel_fori(p)[0],
                                       reps=reps)})
        for label, gate, fn in (
                ("pallas", pk.lu_panel_eligible, pk.lu_panel),
                ("pallas_rec", pk.lu_panel_rec_eligible, pk.lu_panel_rec)):
            if not gate(m, w, p.dtype, p.device):   # the entry's gate
                continue
            out.append({"method": label,
                        "seconds": measure(lambda fn=fn: fn(p)[0],
                                           reps=reps)})
    stats.add_probe_time(time.perf_counter() - t0)
    return sorted(out, key=lambda d: d["seconds"])


def probe_ooc_panel(n: int, candidates: Sequence[int], reps: int = 2,
                    device=None) -> List[Dict]:
    """Time the streamed Cholesky (potrf_ooc, numpy in and out, so a
    call ends with its factor on the host) at the frozen default width
    (entry {"panel_cols": None}, resolved with cached entries bypassed:
    the cold-cache baseline) and at each candidate panel width: the
    best of `reps` timed calls after one untimed call. The matrix
    (_spd, f32) is formed on `device` and copied to host memory: a host
    product at the sizes this probe is for would take minutes. Fastest
    first."""
    from ..linalg.ooc import potrf_ooc
    from ..obs import events as obs
    from . import select as _select
    t0 = time.perf_counter()
    x, s = _spd(n, torch.float32, device)
    del x
    a = s.cpu().numpy()
    del s
    out = []

    def timed(cand):
        best = float("inf")
        potrf_ooc(a, panel_cols=cand, device=device)     # first call
        for _ in range(max(reps, 1)):
            t1 = time.perf_counter()
            potrf_ooc(a, panel_cols=cand, device=device)
            best = min(best, time.perf_counter() - t1)
        return best

    with obs.span("tune::probe::ooc", cat="tune"):
        with _select.disabled():
            out.append({"panel_cols": None, "seconds": timed(None)})
        for cand in candidates:
            out.append({"panel_cols": int(cand),
                        "seconds": timed(int(cand))})
    stats.add_probe_time(time.perf_counter() - t0)
    return sorted(out, key=lambda d: d["seconds"])


def autotune(ops: Iterable[str] = ("getrf", "geqrf"), n: int = 1024,
             dtype=None, nb_candidates: Optional[Sequence[int]] = None,
             write: bool = True, reps: int = 3, device=None,
             ooc_candidates: Optional[Sequence[int]] = None) -> Dict:
    """Probe each op at size n on `device` (the card unless named) and
    (optionally) persist the winners. Returns {op: {"chosen": {...},
    "results": [...]}}. Accepted op names: getrf / geqrf (block size,
    auto-selected by the drivers), potrf (tile-size guidance, ADVISORY:
    see _blocksize_runner), heev (method routing), lu_panel (the
    panel-route method at height n: the library LU vs the column loop vs
    the hand kernels; n is the panel HEIGHT here), ooc (the streaming
    panel width: the reference's candidates n/8, n/4, n/2 unless
    `ooc_candidates` names others).

    Never-regress contract: every probe measures the driver's own
    default configuration as a baseline candidate, and a winner is
    persisted ONLY when it beat that baseline by more than WIN_MARGIN
    ("chosen" is empty otherwise), so a probe can never leave the cache
    slower than a cold start."""
    ops = tuple(ops)
    dtype = _torch_dtype(dtype or torch.float32)
    if nb_candidates is None:
        nb_candidates = [c for c in (64, 128, 256, 512, 1024)
                         if c <= max(n, 64)]
    report: Dict[str, Dict] = {}
    c = _cache.get_cache()

    def beats_default(results, key, default_label=None):
        base = next(r["seconds"] for r in results
                    if r[key] == default_label)
        best = results[0]
        return best[key] != default_label \
            and best["seconds"] < (1.0 - WIN_MARGIN) * base

    for op in ops:
        if op == "heev":
            results = probe_method_eig(n, dtype, reps=reps, device=device)
            chosen = {"method_eig": results[0]["method"]} \
                if beats_default(results, "method", "auto") else {}
        elif op == "lu_panel":
            # panel probes key the cache by the panel HEIGHT bucket (the
            # _lu_panel lookup key); width = the reference's cap for the
            # shape class
            w = min(max(n // 16, 64), 512)
            results = probe_lu_panel(n, w, dtype, reps=reps, device=device)
            chosen = {"method_lu_panel": results[0]["method"]} \
                if beats_default(results, "method") else {}
        elif op == "ooc":
            cands = ooc_candidates
            if cands is None:
                cands = [p for p in (max(n // 8, 32), max(n // 4, 64),
                                     max(n // 2, 128))
                         if p <= n] or [n]
            # the default width is measured as the baseline: a
            # candidate equal to it would only race it against noise
            from ..linalg.ooc import _panel_cols
            from . import select as _select
            with _select.disabled():
                base = _panel_cols(None, n, dtype)
            results = probe_ooc_panel(
                n, sorted(set(cands) - {base}), reps=reps, device=device)
            chosen = {"panel_cols": results[0]["panel_cols"]} \
                if beats_default(results, "panel_cols") else {}
        else:
            results = probe_blocksize(op, n, dtype, nb_candidates,
                                      reps=reps, device=device)
            chosen = {"nb": results[0]["nb"]} \
                if beats_default(results, "nb") else {}
            if chosen and op == "geqrf":
                # the winner is a Tiled configuration: route the bucket
                # to it (Auto would otherwise take the Fused crossover
                # below fused_max_n and never read nb)
                chosen["fused_max_n"] = 0
        report[op] = {"chosen": chosen, "results": results}
        if write and chosen:
            c.put(op, dtype, n, chosen, meta={"n": n, "results": results})
    if write:
        report["_cache_path"] = c.save()
    return report

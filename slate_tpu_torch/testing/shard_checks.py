"""Worker bodies of the sharded out-of-core runs, shared by the tests and
``chip_smoke.py`` (the model of testing/grid_checks.py):

    python -m slate_tpu_torch.testing.shard_checks <rank> <rendezvous>
        <ranks> <suite> [--device D] [--backend B] [--ckpt DIR]
        [--n N] [--w W]

launched by :func:`testing.multiproc.launch`. Every check runs a sharded
driver and, on the same rank, its single-engine twin, and emits one
record: whether the two are bitwise equal, a digest of each result (so
the parent holds every rank to rank 0 without moving the arrays),
counters, and on rank 0 the arrays themselves (``.npy`` paths, read back
by :func:`grid_checks.load`).

Suites: ``shard`` (the three drivers on 2 x 2, 1 x 4 and 4 x 1: budgets,
lookahead, the graph route, fused sweeps, bf16 frames, the staging and
broadcast counts, crash and resume, the ``ppermute`` retry, the
MethodOOC routing of the drivers, and exchange()'s host staging),
``elastic`` (2 x 2: uniform and skewed installed speeds, a measured
straggler, crash and resume across a remap), ``shrink`` (2 x 2 with
per-rank checkpoints; a ``kill`` rule in ``SLATE_RESIL_FAULTS`` ends one
rank), ``survivors`` (whatever world is launched, resuming from
``--ckpt``), and ``chip`` / ``chip_shrink`` / ``chip_survivors``
(``chip_smoke.py``'s ranks on one card: ``--n`` (:data:`CHIP_N`) in
panels of ``--w`` (:data:`CHIP_W`)). The inputs are seeded
numpy arrays (:func:`inputs`), the same in the parent. Nothing here
imports JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

from . import multiproc as mp
from .grid_checks import GRIDS

#: panel width of the CPU suites; the elastic suite's narrower panels
#: give ten of them, two remap boundaries at the frozen remap_every 4
W, W_ELASTIC = 32, 16
#: the chip suite: order, panel width, per-rank budget in panels, the
#: straggler's sleep a step it owns, the step the shrink run kills at
CHIP_N, CHIP_W, CHIP_BUDGET_PANELS = 16384, 2048, 2
CHIP_SLOW_S, KILL_STEP = 0.5, 3


def _spd(rng, n, dtype=np.float64):
    x = rng.standard_normal((n, n)).astype(dtype)
    return x @ x.T / n + 4.0 * np.eye(n, dtype=dtype)


def inputs(suite: str) -> Dict[str, np.ndarray]:
    """The seeded numpy inputs of a suite (the parent builds the same)."""
    rng = np.random.default_rng(2024)
    if suite == "shard":
        x = {"spd": _spd(rng, 160), "spd32": _spd(rng, 160, np.float32),
             "sq": rng.standard_normal((160, 160)),
             "wide": rng.standard_normal((96, 160)),
             "tall": rng.standard_normal((200, 64)),
             "sq100": rng.standard_normal((100, 100)),
             "b": rng.standard_normal((160, 3)),
             "tallb": rng.standard_normal((200, 2)),
             "tree": rng.standard_normal((16, 4))}
        # cross-panel pivots in every panel
        x["lu"] = x["sq"] * (1.0 + np.arange(160))[:, None]
        g = rng.standard_normal((160, 160)).astype(np.float32)
        x["lu32"] = (g + 0.1 * 160 * np.eye(160, dtype=np.float32)) \
            * (1.0 + np.arange(160, dtype=np.float32))[:, None]
        return x
    if suite in ("elastic", "shrink", "survivors"):
        return {"spd": _spd(rng, 160, np.float32),
                "sq": rng.standard_normal((160, 160)).astype(np.float32)}
    if suite.startswith("chip"):
        return {}
    raise ValueError("unknown suite %r" % suite)


def digest(x) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.ascontiguousarray(x)
    h = hashlib.sha256()
    h.update(("%s%s" % (x.dtype.str, x.shape)).encode())
    h.update(memoryview(x).cast("B"))
    return h.hexdigest()


class _Out:
    """One check's record: arrays saved on rank 0 only (their digests
    everywhere), scalars as they are."""

    def __init__(self, suite: str, rank: int) -> None:
        self.suite, self.rank = suite, rank
        self.dir = mp.outdir()

    def put(self, tag: str, arrays=None, **fields) -> None:
        rec = dict(fields)
        for k, v in (arrays or {}).items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            rec["sha_" + k] = digest(v)
            if self.rank == 0:
                path = os.path.join(self.dir, "%s.%s.%s.npy" % (
                    self.suite, tag, k))
                np.save(path, v)
                rec[k] = {"npy": path}
        mp.emit(tag, **rec)


def _same(x, y) -> bool:
    return all(np.array_equal(a, b) for a, b in zip(_tup(x), _tup(y)))


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


class _Obs:
    """The bus on around one run: the counters it left."""

    def __enter__(self):
        from ..obs import events, metrics
        events.enable()
        events.clear()
        metrics.reset()
        return self

    def __exit__(self, *exc):
        from ..obs import events, metrics
        self.counters = metrics.snapshot()["counters"]
        self.events = [(e.name, dict(e.args or {}))
                       for e in events.events()]
        events.disable()
        events.clear()
        metrics.reset()

    def count(self, name: str) -> int:
        return sum(1 for n, _ in self.events if n == name)


def _fault_run(fn, plan_rules):
    """fn() under a fault plan: (result or None, the raised fault's
    (site, step) or None, the plan's fired count)."""
    from ..resil import faults
    plan = faults.install(faults.FaultPlan(plan_rules))
    try:
        return fn(), None, plan.fired()
    except faults.InjectedFault as e:
        return None, (e.site, e.ctx.get("step")), plan.fired()
    finally:
        faults.clear()


# -- suite "shard" -----------------------------------------------------------

def _potrf(grid, x, out: _Out, tag: str) -> None:
    from ..dist import shard_ooc as so
    from ..dist.tree import schedule_ppermutes
    from ..linalg import ooc, stream
    from ..parallel import collectives as coll
    from ..resil import guard
    dev = grid.device
    a = x["spd"]
    n = a.shape[0]
    nt = n // W
    spill, big = int(1.5 * n * W * 8), 64 * n * W * 8
    L0 = ooc.potrf_ooc(a, W, 0, device=dev)
    variants = {
        "b0": dict(cache_budget_bytes=0),
        "spill": dict(cache_budget_bytes=spill),
        "d1": dict(lookahead=1, cache_budget_bytes=0),
        "d2_spill": dict(lookahead=2, cache_budget_bytes=spill),
        "graph_d0": dict(scheduler="graph", cache_budget_bytes=0),
        "graph_d2_spill": dict(scheduler="graph", lookahead=2,
                               cache_budget_bytes=spill),
        "fused_d0": dict(visit_fuse="fused"),
        "fused_d1": dict(visit_fuse="fused", lookahead=1),
        "fanin4": dict(fanin=4)}
    same, shas = {}, {}
    for name, kw in variants.items():
        L = so.shard_potrf_ooc(a, grid, panel_cols=W, **kw)
        same[name] = _same(L, L0)
        shas[name] = digest(L)
    # the staging and broadcast counts (eviction-free: exact)
    sched = so.CyclicSchedule(nt, grid)
    heights = {k: n - k * W for k in range(nt)}
    counts = {}
    for name, kw in (("big", {}), ("big_d1", dict(lookahead=1)),
                     ("big_graph_d1", dict(lookahead=1,
                                           scheduler="graph"))):
        c0 = coll.counts()
        with _Obs() as ob:
            L = so.shard_potrf_ooc(a, grid, panel_cols=W,
                                   cache_budget_bytes=big, **kw)
        c = ob.counters
        counts[name] = {
            "h2d": int(c.get("ooc.h2d_bytes", 0)),
            "expect": sched.staged_bytes(heights, W, n - (nt - 1) * W, 8,
                                         depth=kw.get("lookahead", 0)),
            "bcast_panels": int(c.get("ooc.shard.bcast_panels", 0)),
            "bcast_bytes": int(c.get("ooc.shard.bcast_bytes", 0)),
            "bcast_ahead": int(c.get("ooc.shard.bcast_ahead", 0)),
            "wait_s": float(c.get("ooc.shard.bcast_wait_seconds", 0)),
            "inflight_s": float(c.get("ooc.shard.bcast_inflight_seconds",
                                      0)),
            "permutes": coll.counts_delta(c0)["collective-permute"],
            "permutes_expected": nt * schedule_ppermutes(grid.nprocs, 2),
            "spills": stream.last_stats()["spills"],
            "wait_spans": ob.count("shard::bcast_wait"),
            "overlap_instants": ob.count("shard::overlap"),
            "step_obs": ob.count("shard::step_obs"),
            "step_obs_h2d": sum(a_["h2d_bytes"] for n_, a_ in ob.events
                                if n_ == "shard::step_obs"),
            "graphs": int(c.get("sched.graphs", 0)),
            "bitwise": _same(L, L0)}
    # crash and resume (depth 0: epoch 3; depth 1: the in-flight panel
    # 3 is not durable, epoch 2)
    resume = {}
    for name, depth in (("d0", 0), ("d1", 1)):
        ck = os.path.join(out.dir, "ck_%s_%s_%d" % (tag, name, grid.rank))
        run = lambda: so.shard_potrf_ooc(  # noqa: E731
            a, grid, panel_cols=W, lookahead=depth, ckpt_path=ck,
            ckpt_every=1)
        _, raised, _ = _fault_run(run, [
            {"site": "step", "match": {"op": "shard_potrf_ooc",
                                       "step": 3}, "times": 1}])
        import json
        with open(os.path.join(ck, "host%d" % grid.index,
                               "meta.json")) as f:
            epoch = json.load(f)["epoch"]
        L = run()
        resume[name] = {"raised": list(raised or ()), "epoch": epoch,
                        "bitwise": _same(L, L0)}
    # resume from a near-complete checkpoint stages only the replays and
    # the one live panel
    ck = os.path.join(out.dir, "ck_%s_tail_%d" % (tag, grid.rank))
    run = lambda: so.shard_potrf_ooc(a, grid, panel_cols=W,  # noqa: E731
                                     ckpt_path=ck, ckpt_every=1)
    _fault_run(run, [{"site": "step", "match": {
        "op": "shard_potrf_ooc", "step": nt - 1}, "times": 1}])
    with _Obs() as ob:
        L = run()
    tail = n - (nt - 1) * W
    mine = sched.is_mine(nt - 1)
    resume["tail"] = {
        "h2d": int(ob.counters.get("ooc.h2d_bytes", 0)),
        "expect": (nt - 1) * n * W * 8 + (nt * tail * tail * 8
                                          if mine else 0),
        "bitwise": _same(L, L0)}
    # an injected ppermute fault: the traversal is retried in lockstep
    guard.reset_counts()
    L, raised, fired = _fault_run(
        lambda: so.shard_potrf_ooc(a, grid, panel_cols=W, lookahead=1),
        [{"site": "ppermute", "match": {"op": "shard_bcast"},
          "after": 2, "times": 1}])
    retry = {"fired": fired, "retries": guard.counts().get(
        "resil.retries", 0), "bitwise": _same(L, L0)}
    guard.reset_counts()
    # bf16 frames: f32 default bitwise explicit "f32", half the bytes,
    # depth 1 bitwise depth 0, bf16-update accuracy
    a32 = x["spd32"]
    bf = {}
    for name, prec in (("default", None), ("f32", "f32"),
                       ("bf16", "bf16")):
        with _Obs() as ob:
            bf[name] = so.shard_potrf_ooc(a32, grid, panel_cols=W,
                                          cache_budget_bytes=big,
                                          precision=prec)
        bf[name + "_bytes"] = int(ob.counters.get(
            "ooc.shard.bcast_bytes", 0))
        bf[name + "_casts"] = int(ob.counters.get(
            "ooc.cast_demote_bytes", 0)) + int(ob.counters.get(
                "ooc.cast_promote_bytes", 0))
    Lb1 = so.shard_potrf_ooc(a32, grid, panel_cols=W,
                             cache_budget_bytes=big, precision="bf16",
                             lookahead=1)
    precision = {
        "f32_bitwise": _same(bf["default"], bf["f32"]),
        "bytes": [bf["f32_bytes"], bf["bf16_bytes"]],
        "bf16_casts": bf["bf16_casts"],
        "bf16_d1_bitwise": _same(bf["bf16"], Lb1),
        "bf16_err": float(np.abs(bf["bf16"] - bf["f32"]).max()),
        "stream_bitwise": _same(bf["f32"], ooc.potrf_ooc(
            a32, W, big, device=dev))}
    out.put(tag + ".potrf", arrays={"l": L0, "l_bf16": bf["bf16"]},
            same=same, shas=shas, counts=counts, resume=resume,
            retry=retry, precision=precision,
            my_panels=sched.my_panels())


def _geqrf(grid, x, out: _Out, tag: str) -> None:
    from ..dist import shard_ooc as so
    from ..linalg import ooc
    dev = grid.device
    same, shas, arrays = {}, {}, {}
    for shape in ("sq", "wide", "tall"):
        g = x[shape]
        ref = ooc.geqrf_ooc(g, W, cache_budget_bytes=0, device=dev)
        arrays[shape + "_qr"], arrays[shape + "_tau"] = ref
        for name, kw in (("b0", {}), ("d1", dict(lookahead=1)),
                         ("graph_d2", dict(scheduler="graph",
                                           lookahead=2)),
                         ("fused_d1", dict(visit_fuse="fused",
                                           lookahead=1)),
                         ("big", dict(cache_budget_bytes=64 * 200 * W
                                      * 8))):
            kw.setdefault("cache_budget_bytes", 0)
            r = so.shard_geqrf_ooc(g, grid, panel_cols=W, **kw)
            same[shape + "." + name] = _same(r, ref)
            shas[shape + "." + name] = digest(r[0]) + digest(r[1])
    g = x["sq"]
    ref = ooc.geqrf_ooc(g, W, cache_budget_bytes=0, device=dev)
    ck = os.path.join(out.dir, "ckq_%s_%d" % (tag, grid.rank))
    run = lambda: so.shard_geqrf_ooc(g, grid, panel_cols=W,  # noqa: E731
                                     ckpt_path=ck, ckpt_every=2)
    _, raised, _ = _fault_run(run, [{"site": "step", "match": {
        "op": "shard_geqrf_ooc", "step": 2}, "times": 1}])
    resume = {"raised": list(raised or ()), "bitwise": _same(run(), ref)}
    out.put(tag + ".geqrf", arrays=arrays, same=same, shas=shas,
            resume=resume)


def _getrf(grid, x, out: _Out, tag: str) -> None:
    from ..dist import shard_ooc as so
    from ..linalg import ooc, stream
    dev = grid.device
    same, shas, arrays = {}, {}, {}
    for shape in ("lu", "wide", "tall", "sq100"):
        g = x[shape]
        m, n = g.shape
        ref = ooc.getrf_tntpiv_ooc(g, W, cache_budget_bytes=0, device=dev)
        arrays[shape + "_lu"], arrays[shape + "_piv"] = ref
        for name, kw in (("b0", {}), ("d1", dict(lookahead=1)),
                         ("spill", dict(cache_budget_bytes=int(
                             1.5 * m * W * 8))),
                         ("graph_d2", dict(scheduler="graph",
                                           lookahead=2)),
                         ("fused_d1", dict(visit_fuse="fused",
                                           lookahead=1))):
            kw.setdefault("cache_budget_bytes", 0)
            r = so.shard_getrf_ooc(g, grid, panel_cols=W, **kw)
            same[shape + "." + name] = _same(r, ref)
            shas[shape + "." + name] = digest(r[0]) + digest(r[1])
    # full-height staging exactly the schedule's; the frame's extra row
    g = x["lu"]
    n = g.shape[0]
    nt = n // W
    with _Obs() as ob:
        r = so.shard_getrf_ooc(g, grid, panel_cols=W,
                               cache_budget_bytes=64 * n * W * 8)
    sched = so.CyclicSchedule(nt, grid)
    c = ob.counters
    counts = {"h2d": int(c.get("ooc.h2d_bytes", 0)),
              "expect": sched.staged_bytes({k: n for k in range(nt)}, W,
                                           W, 8),
              "bcast_bytes": int(c.get("ooc.shard.bcast_bytes", 0)),
              "bcast_expect": nt * (n + 1) * W * 8,
              "invalidations": stream.last_stats()["invalidations"],
              "bitwise": _same(r, ooc.getrf_tntpiv_ooc(
                  g, W, cache_budget_bytes=0, device=dev))}
    # bf16: the byte-split pivot pair decodes alike on every rank
    g32 = x["lu32"]
    lub, pb = so.shard_getrf_ooc(g32, grid, panel_cols=W,
                                 cache_budget_bytes=0, precision="bf16")
    perm = ooc._swaps_to_perm(pb, g32.shape[0])
    L = np.tril(lub, -1) + np.eye(g32.shape[0], dtype=np.float32)
    resid = float(np.abs(g32[perm] - L @ np.triu(lub)).max()
                  / np.abs(g32).max())
    bf16 = {"resid": resid, "sha": digest(lub) + digest(pb)}
    out.put(tag + ".getrf", arrays=arrays, same=same, shas=shas,
            counts=counts, bf16=bf16)


def _routing(grid, x, out: _Out, tag: str) -> None:
    """The drivers' MethodOOC arbitration with this grid: a cold cache
    keeps the stream (no frame issued), explicit and tuned Sharded take
    the sharded stream (bitwise), the shard_min_panels floor, strings,
    explicit Stream, the composites' factor phases, and the errors."""
    from ..core.exceptions import SlateError
    from ..core.methods import MethodOOC
    from ..linalg import ooc
    from ..tune import cache as tcache
    dev = grid.device
    a, b = x["spd"], x["b"]
    L0 = ooc.potrf_ooc(a, W, device=dev)
    rec = {}
    with _Obs() as ob:
        L = ooc.potrf_ooc(a, W, grid=grid, device=dev)
    rec["cold_stream"] = _same(L, L0) and \
        ob.counters.get("ooc.shard.bcast_panels", 0) == 0
    saved = dict(tcache.FROZEN)
    try:
        tcache.FROZEN[("ooc", "shard_method")] = "sharded"
        with _Obs() as ob:
            L = ooc.potrf_ooc(a, W, grid=grid, device=dev)
        # nt = 5 < 2 panels a rank on four ranks: the floor holds
        rec["floor_stream"] = _same(L, L0) and \
            ob.counters.get("ooc.shard.bcast_panels", 0) == 0
        tcache.FROZEN[("ooc", "shard_min_panels")] = 0
        with _Obs() as ob:
            L = ooc.potrf_ooc(a, W, grid=grid, device=dev)
        rec["tuned_sharded"] = _same(L, L0) and \
            ob.counters.get("ooc.shard.bcast_panels", 0) == 5
        with _Obs() as ob:
            L = ooc.potrf_ooc(a, W, grid=grid, method=MethodOOC.Stream,
                              device=dev)
        rec["explicit_stream"] = _same(L, L0) and \
            ob.counters.get("ooc.shard.bcast_panels", 0) == 0
    finally:
        tcache.FROZEN.clear()
        tcache.FROZEN.update(saved)
    with _Obs() as ob:
        L = ooc.potrf_ooc(a, W, grid=grid, method="sharded", device=dev)
    rec["string_sharded"] = _same(L, L0) and \
        ob.counters.get("ooc.shard.bcast_panels", 0) == 5
    L1, X1 = ooc.posv_ooc(a, b, W, grid=grid, method="sharded",
                          device=dev)
    L2, X2 = ooc.posv_ooc(a, b, W, device=dev)
    rec["posv"] = _same((L1, X1), (L2, X2))
    g = x["lu"]
    r0 = ooc.getrf_tntpiv_ooc(g, W, device=dev)
    rec["getrf_auto_pivot"] = _same(ooc.getrf_ooc(
        g, W, grid=grid, method="sharded", pivot="auto", device=dev), r0)
    (lu, piv), X = ooc.gesv_ooc(g, b, W, grid=grid, method="sharded",
                                device=dev)
    rec["gesv"] = _same((lu, piv), r0) and _same(
        X, ooc.getrs_ooc(r0[0], r0[1], b, W, device=dev))
    try:
        ooc.getrf_ooc(g, W, grid=grid, method="sharded", pivot="partial",
                      device=dev)
        rec["partial_raises"] = False
    except SlateError:
        rec["partial_raises"] = True
    qr, X = ooc.gels_ooc(x["tall"], x["tallb"], W, grid=grid,
                         method="sharded", device=dev)
    qr0, X0 = ooc.gels_ooc(x["tall"], x["tallb"], W, device=dev)
    rec["gels"] = _same(qr, qr0) and _same(X, X0)
    out.put(tag + ".routing", **rec)


def _exchange(grid, x, out: _Out, tag: str) -> None:
    """exchange()'s host staging (forced on CPU tensors) against the
    direct path: the tree all-reduce and ring_shift give the same bits
    and the same collective counts; the staged bytes are counted."""
    from ..dist.tree import round_schedule, row_block
    from ..parallel import collectives as coll
    xt = torch.as_tensor(x["tree"], device=grid.device)
    blk = xt[row_block(grid, 16)]
    res = {}
    for staged in (False, True):
        coll.STAGE_ON_HOST = staged
        coll.reset_staged_bytes()
        c0 = coll.counts()
        try:
            y = coll.tree_allreduce(grid, blk, fanin=2)
            r = coll.ring_shift(grid, blk, "q", 1)
        finally:
            coll.STAGE_ON_HOST = None
        res[staged] = (y, r, coll.counts_delta(c0), coll.staged_bytes())
    d, s = res[False], res[True]
    nb = blk.numel() * blk.element_size()
    rounds = len(round_schedule(grid.nprocs, 2))
    shift = 1 if grid.q > 1 else 0
    out.put(tag + ".exchange", arrays={"tree": d[0]},
            same=bool(torch.equal(d[0], s[0]) and torch.equal(d[1], s[1])),
            counts_equal=d[2] == s[2], direct_staged=d[3],
            staged_bytes=s[3], staged_expect=2 * nb * (rounds + shift))


# -- suite "elastic" ---------------------------------------------------------

def _elastic(grid, x, out: _Out, tag: str) -> None:
    from ..dist import elastic
    from ..dist import shard_ooc as so
    from ..linalg import ooc
    from ..resil import faults
    dev = grid.device
    a, g = x["spd"], x["sq"]
    w = W_ELASTIC
    L0 = ooc.potrf_ooc(a, w, 0, device=dev)
    rec = {}

    def run(**kw):
        return so.shard_potrf_ooc(a, grid, panel_cols=w,
                                  cache_budget_bytes=0, **kw)

    def remaps():
        return elastic.remap_records()

    rec["static"] = _same(run(ownership="static"), L0)
    for name, speeds in (("uniform", [1.0] * 4),
                         ("skew", [1.0, 1.0, 1.0, 0.25])):
        elastic.reset_remap_records()
        elastic.install_speeds(speeds)
        try:
            L = run(ownership="elastic")
            Lf = run(ownership="elastic", visit_fuse="fused")
        finally:
            elastic.install_speeds(None)
        rec[name] = {"bitwise": _same(L, L0), "fused": _same(Lf, L0),
                     "records": remaps()}
    # geqrf and getrf re-owned mid-stream, tail panels read live
    elastic.install_speeds([1.0, 1.0, 1.0, 0.25])
    try:
        elastic.reset_remap_records()
        q = so.shard_geqrf_ooc(g, grid, panel_cols=w, cache_budget_bytes=0,
                               ownership="elastic")
        lu = so.shard_getrf_ooc(g, grid, panel_cols=w,
                                cache_budget_bytes=0, ownership="elastic")
        rec["qr_lu"] = {
            "geqrf": _same(q, ooc.geqrf_ooc(g, w, cache_budget_bytes=0,
                                            device=dev)),
            "getrf": _same(lu, ooc.getrf_tntpiv_ooc(
                g, w, cache_budget_bytes=0, device=dev)),
            "records": remaps()}
    finally:
        elastic.install_speeds(None)
    # a measured straggler: rank 3 sleeps in every step it owns
    elastic.reset_remap_records()
    L, _, _ = _fault_run(lambda: run(ownership="elastic"), [
        {"site": "step", "match": {"op": "shard_potrf_ooc", "host": 3,
                                   "mine": True},
         "kind": "slow", "times": 10 ** 6, "slow_s": 0.25}])
    rec["straggler"] = {"bitwise": _same(L, L0), "records": remaps()}
    # crash after the first remap boundary, resumed elastic
    for name, own, step in (("crash_elastic", "elastic", 6),
                            ("crash_static", "static", 5)):
        ck = os.path.join(out.dir, "cke_%s_%d" % (name, grid.rank))
        elastic.install_speeds([1.0, 1.0, 1.0, 0.25])
        try:
            elastic.reset_remap_records()
            _, raised, _ = _fault_run(
                lambda: run(ownership=own, ckpt_path=ck, ckpt_every=1),
                [{"site": "step", "match": {"op": "shard_potrf_ooc",
                                            "step": step}, "times": 1}])
            crashed = remaps()
            elastic.reset_remap_records()
            L = run(ownership="elastic", ckpt_path=ck, ckpt_every=1)
        finally:
            elastic.install_speeds(None)
        rec[name] = {"raised": list(raised or ()),
                     "bitwise": _same(L, L0), "crashed_records": crashed,
                     "records": remaps()}
    faults.clear()
    out.put(tag + ".elastic", arrays={"l": L0}, **rec)


# -- suites "shrink" and "survivors" -----------------------------------------

def _shrink(grid, x, out: _Out, tag: str, ckpt: str) -> None:
    """Checkpoint every panel; the fault plan of the launch kills one
    rank at KILL_STEP."""
    from ..dist import shard_ooc as so
    L = so.shard_potrf_ooc(x["spd"], grid, panel_cols=W_ELASTIC,
                           cache_budget_bytes=0, ckpt_path=ckpt,
                           ckpt_every=1)
    out.put(tag + ".shrink", sha=digest(L))


def _survivors(grid, x, out: _Out, tag: str, ckpt: str) -> None:
    from ..dist import shard_ooc as so
    with _Obs() as ob:
        L = so.shard_potrf_ooc(x["spd"], grid, panel_cols=W_ELASTIC,
                               cache_budget_bytes=0, ckpt_path=ckpt,
                               ckpt_every=1)
    sched = [e for n_, e in ob.events if n_ == "shard::schedule"]
    out.put(tag + ".survivors", arrays={"l": L},
            resume_epoch=sched[0]["resume_epoch"] if sched else None)


# -- suite "chip" ------------------------------------------------------------

def chip_matrix(n: int, dev) -> np.ndarray:
    """The chip suite's SPD matrix, made on `dev` from a fixed seed
    (S = G G^T / n + I, exactly symmetric) and returned on the host; the
    parent makes the same for its one-rank run."""
    gen = torch.Generator(dev).manual_seed(18)
    g = torch.randn((n, n), generator=gen, device=dev)
    s = g @ g.T
    s.div_(n)
    s.diagonal().add_(1.0)
    return ((s + s.T) * 0.5).cpu().numpy()


def chip_lu_matrix(n: int, dev) -> np.ndarray:
    gen = torch.Generator(dev).manual_seed(19)
    g = torch.randn((n, n), generator=gen, device=dev)
    g.diagonal().add_(0.1 * n ** 0.5)
    return g.cpu().numpy()


def _chip(grid, out: _Out, tag: str, n: int = CHIP_N,
          w: int = CHIP_W) -> None:
    """Four ranks on one card: potrf / getrf / geqrf at CHIP_N with a
    budget of CHIP_BUDGET_PANELS panels a rank (digests against the
    parent's one-rank run, staging against the schedule), lookahead 1,
    and the elastic route under a straggler (rank 3)."""
    from ..dist import elastic
    from ..dist import shard_ooc as so
    from ..linalg import stream
    from ..parallel import collectives as coll
    dev = grid.device
    nt = n // w
    budget = CHIP_BUDGET_PANELS * n * w * 4
    a = chip_matrix(n, dev)
    g = chip_lu_matrix(n, dev)
    sched = so.CyclicSchedule(nt, grid)
    rec = {"my_panels": sched.my_panels()}

    def timed(name, fn, heights):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        c0 = coll.counts()
        coll.reset_staged_bytes()
        t0 = time.perf_counter()
        with _Obs() as ob:
            r = fn()
        wall = time.perf_counter() - t0
        c = ob.counters
        rec[name] = {
            "wall_s": wall, "sha": "".join(digest(v) for v in _tup(r)),
            "h2d": int(c.get("ooc.h2d_bytes", 0)),
            "expect": sched.staged_bytes(heights, w, w, 4),
            "spills": stream.last_stats()["spills"],
            "bcast_bytes": int(c.get("ooc.shard.bcast_bytes", 0)),
            "gloo_staged_bytes": coll.staged_bytes(),
            "permutes": coll.counts_delta(c0)["collective-permute"],
            "wait_s": float(c.get("ooc.shard.bcast_wait_seconds", 0)),
            "inflight_s": float(c.get("ooc.shard.bcast_inflight_seconds",
                                      0))}
        inf = rec[name]["inflight_s"]
        rec[name]["overlap_fraction"] = max(
            0.0, 1.0 - rec[name]["wait_s"] / inf) if inf > 0 else 0.0
        return r

    tri = {k: n - k * w for k in range(nt)}
    full = {k: n for k in range(nt)}
    timed("potrf", lambda: so.shard_potrf_ooc(
        a, grid, panel_cols=w, cache_budget_bytes=budget), tri)
    timed("potrf_d1", lambda: so.shard_potrf_ooc(
        a, grid, panel_cols=w, cache_budget_bytes=budget, lookahead=1),
        tri)
    timed("getrf", lambda: so.shard_getrf_ooc(
        g, grid, panel_cols=w, cache_budget_bytes=budget), full)
    timed("geqrf", lambda: so.shard_geqrf_ooc(
        g, grid, panel_cols=w, cache_budget_bytes=budget), full)
    elastic.reset_remap_records()
    _, _, _ = _fault_run(lambda: timed("elastic", lambda: so.shard_potrf_ooc(
        a, grid, panel_cols=w, cache_budget_bytes=budget,
        ownership="elastic"), tri), [
        {"site": "step", "match": {"op": "shard_potrf_ooc", "host": 3,
                                   "mine": True},
         "kind": "slow", "times": 10 ** 6, "slow_s": CHIP_SLOW_S}])
    rec["elastic"]["records"] = elastic.remap_records()
    out.put(tag + ".chip", **rec)


def chip_shrink(grid, out: _Out, tag: str, ckpt: str, survivors: bool,
                n: int = CHIP_N, w: int = CHIP_W) -> None:
    """The chip suite's shrink legs: potrf at CHIP_N with per-rank
    checkpoints every panel (the launch's plan kills one rank), or the
    survivors' resume."""
    from ..dist import shard_ooc as so
    a = chip_matrix(n, grid.device)
    t0 = time.perf_counter()
    with _Obs() as ob:
        L = so.shard_potrf_ooc(a, grid, panel_cols=w,
                               cache_budget_bytes=CHIP_BUDGET_PANELS * n
                               * w * 4, ckpt_path=ckpt, ckpt_every=1)
    sched = [e for n_, e in ob.events if n_ == "shard::schedule"]
    out.put(tag + (".survivors" if survivors else ".shrink"),
            wall_s=time.perf_counter() - t0, sha=digest(L),
            resume_epoch=sched[0]["resume_epoch"] if sched else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("rdzv")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("suite")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n", type=int, default=CHIP_N)
    ap.add_argument("--w", type=int, default=CHIP_W)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ..parallel.mesh import make_grid
    out = _Out(args.suite, args.rank)
    x = inputs(args.suite)
    dev = torch.device(args.device)
    mp.init(args.rank, args.rdzv, args.nprocs, backend=args.backend,
            device=args.device)
    if args.suite == "shard":
        for p, q in GRIDS:
            grid = make_grid(p, q, device=dev)
            tag = "%dx%d" % (p, q)
            for check in (_potrf, _geqrf, _getrf, _routing):
                check(grid, x, out, tag)
        _exchange(make_grid(2, 2, device=dev), x, out, "2x2")
    elif args.suite == "elastic":
        _elastic(make_grid(2, 2, device=dev), x, out, "2x2")
    elif args.suite in ("shrink", "survivors"):
        grid = make_grid(device=dev)
        tag = "%dx%d" % (grid.p, grid.q)
        if args.suite == "shrink":
            _shrink(grid, x, out, tag, args.ckpt)
        else:
            _survivors(grid, x, out, tag, args.ckpt)
    elif args.suite == "chip":
        _chip(make_grid(2, 2, device=dev), out, "2x2", args.n, args.w)
    elif args.suite in ("chip_shrink", "chip_survivors"):
        grid = make_grid(device=dev)
        chip_shrink(grid, out, "%dx%d" % (grid.p, grid.q), args.ckpt,
                    args.suite == "chip_survivors", args.n, args.w)
    else:
        raise ValueError("unknown suite %r" % args.suite)
    mp.emit("done")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

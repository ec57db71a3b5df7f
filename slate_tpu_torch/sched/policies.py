"""Graph constructors reproducing the walks' schedules (counterpart of
``slate_tpu/sched/policies.py``).

:func:`left_looking` builds the single-engine out-of-core stream
(potrf_ooc / geqrf_ooc / getrf_tntpiv_ooc) as a graph: per panel k a
``stage -> update(0..k-1) -> factor -> writeback`` chain, where update
(k, j) also depends on panel j's writeback. Its ``key`` tuples make the
executor's ready order the walk's issue order (runtime.py).

The sharded stream's constructor :func:`sharded_stream` builds the
block-cyclic right-looking walk of dist/shard_ooc.py (its
``_BcastPipeline``): lookahead is a property of the graph, depth d
only moves the slot a panel's factor and broadcast nodes are keyed at
(``max(i - d, 0)``) and how many updates ride the promoted window.
Slots and keys (the intra-slot class orders a slot's nodes)::

    node            slot                     cls
    writeback i     i (d=0) | max(i-d+1, 0)  0   realize record i
    promote U(j,s)  max(j-d, 0)              1   window catch-up
    factor i        max(i-d, 0)              2   owner panel factor
    bcast i         max(i-d, 0)              3   collective issue
    sweep U(j,s)    s                        4   trailing sweep
    tail k          k                        0   m<n tail broadcast

Stage nodes (a trailing panel's first H2D) take their first update's
key with a trailing 0. The ``step`` fault check fires once a panel,
from the first node that processes it: the walk's sequence, so a
seeded plan fails at the same step on either route.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs import events as obs_events
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from ..resil import faults as _faults
from .graph import TaskGraph


def left_looking(op: str, *,
                 panels: Sequence[int],
                 updates: Callable[[int], Sequence[int]],
                 stage: Callable[[int], None],
                 update: Callable[[int, int], None],
                 factor: Callable[[int], None],
                 writeback: Callable[[int], None],
                 has_factor: Optional[Callable[[int], bool]] = None,
                 fused_update: Optional[
                     Callable[[int, Sequence[int]], None]] = None
                 ) -> TaskGraph:
    """The single-engine left-looking stream as a graph.

    The driver supplies its loop body as closures (`stage` /
    `update(k, j)` / `factor` / `writeback`, the walk's code over the
    driver's own engine and state); `panels` is the panel range
    (``range(epoch, nt)`` on resume), `updates(k)` the panels k visits,
    and `has_factor(k)` gates the factor node (geqrf / getrf panels past
    ``kmax`` are only restaged and written). Update (k, j) depends on
    panel j's writeback; below the resume epoch that producer is outside
    the graph (the update reads the durable factor), so the edge is
    absent.

    ``fused_update(k, js)`` turns panel k's visit sweep into ONE
    ``fused_update`` node whenever it has more than one member; a
    single visit keeps its ``update`` node. Without it the graph is the
    per-panel one."""
    g = TaskGraph(op)
    wb: Dict[int, Any] = {}
    for k in panels:
        prev = g.add("stage", partial(stage, k), panel=k, key=(k, 0))
        js = list(updates(k))
        if fused_update is not None and len(js) > 1:
            prev = g.add("fused_update",
                         partial(fused_update, k, js), panel=k,
                         key=(k, 1, 0),
                         deps=[prev] + [wb.get(j) for j in js])
        else:
            for j in js:
                prev = g.add("update", partial(update, k, j), panel=k,
                             step=j, key=(k, 1, j),
                             deps=[prev, wb.get(j)])
        if has_factor is None or has_factor(k):
            prev = g.add("factor", partial(factor, k), panel=k,
                         key=(k, 2), deps=[prev])
        wb[k] = g.add("writeback", partial(writeback, k), panel=k,
                      key=(k, 3), deps=[prev])
    return g


def sharded_stream(op: str, *, sched, bc, st, depth: int, epoch: int,
                   factor_panels: Sequence[int],
                   tail_panels: Sequence[int],
                   payload_shape: Callable,
                   make_payload: Callable,
                   complete: Callable,
                   replay: Callable,
                   apply: Callable,
                   tail: Optional[Callable[[int], None]] = None,
                   applied_through: Optional[Callable[[int], int]]
                   = None,
                   trailing_to: Optional[int] = None,
                   fused_apply: Optional[Callable] = None
                   ) -> TaskGraph:
    """The sharded right-looking walk as a graph (module doc table).

    Takes the closures dist/shard_ooc.py's ``_BcastPipeline`` takes
    (payload_shape / make_payload / complete / replay / apply) and the
    driver's `tail(k)` body of the m < n tail panels. `sched` is the
    CyclicSchedule, `bc` the PanelBroadcaster, `st` the _ShardState
    working set, `depth` the lookahead, `epoch` the agreed resume epoch.

    Segmented construction (dist/elastic.py): the elastic route builds
    the stream as a sequence of these graphs, one a remap segment.
    `applied_through(p)` is the first update step panel p has not
    absorbed (earlier segments' updates are left out), and
    `trailing_to` carries the trailing sweep past the factor range, so
    panels factoring in later segments stay caught up. Replay nodes
    below the epoch are built only for records a consumer still needs.
    With both None the graph is the unsegmented one.

    ``fused_apply(Ss, rec, ps, s)``: each slot's trailing sweep over the
    owned panels (every update consuming record ``s`` outside the
    promoted window) becomes ONE ``fused_update`` node, which stages
    every member, fires each member's ``step`` check in ascending order
    and calls the driver's sweep once. Promoted window updates and
    single-member sweeps stay per panel. Without it the graph is the
    per-panel one."""
    d = max(int(depth), 0)
    ep = int(epoch)
    at = applied_through if applied_through is not None \
        else (lambda _p: 0)
    last = factor_panels[-1] if len(factor_panels) else -1
    g = TaskGraph(op)

    # --- shared bookkeeping the node closures close over ------------
    checked: set = set()
    recs: Dict[int, Any] = {}       # realized update records
    payloads: Dict[int, Any] = {}   # factor -> bcast handoff
    frames: Dict[int, Any] = {}     # bcast -> writeback handoff
    sj: Dict[int, Any] = {}         # stage -> first-update handoff

    def _chk(k: int) -> None:
        if k not in checked:
            checked.add(k)
            # `mine`: this rank owns the panel (a straggler plan
            # scopes its slowdown to owned work, so a re-ownership
            # sheds it)
            _faults.check("step", op=op, step=k,
                          mine=bool(sched.is_mine(k)))

    mine_tr = sorted(j for j in sched.my_panels()
                     if j >= max(1, ep))
    tail_set = set(tail_panels)

    # explicit per-record consumer counts replace _ShardState.upto:
    # a record dies when its last consuming update ran (the walk's
    # liveness exactly — the slot-s sweep is always the last use)
    remaining: Dict[int, int] = {}
    for j in mine_tr:
        for s in range(at(j), min(j, last + 1)):
            remaining[s] = remaining.get(s, 0) + 1

    def slot_wb(i: int) -> int:
        return i if d == 0 else max(i - d + 1, 0)

    def slot_issue(i: int) -> int:
        return max(i - d, 0)

    def ahead(i: int) -> bool:
        # only depth 0 and the very first panel issue synchronously
        # (pipeline obtain()'s pending-miss path); everything else is
        # dispatched ahead — preserves the ooc.shard.bcast_ahead pin
        return d > 0 and not (i == 0 and ep == 0)

    def _promo(p: int, s: int) -> bool:
        # promoted window catch-up (advance()'s _promote) vs trailing
        # sweep (updates()): factor panels absorb their last d steps
        # at issue time, everything else sweeps at the record's slot
        return p <= last and d > 0 and s >= p - d

    # slot-0 sweep prefetch chain (prefetch_next): every owned
    # trailing panel first-touches at slot 0 — promoted panels stage
    # synchronously inside the window, sweep panels chain exact
    # prefetches in sweep order (window tails first, then ascending)
    sweep0 = sorted((p for p in mine_tr if not _promo(p, 0)),
                    key=lambda p: (0 if p <= d else 1, p))
    pref_of = {sweep0[i]: sweep0[i + 1]
               for i in range(len(sweep0) - 1)}

    # fused sweep membership: slot -> its non-promoted
    # owned consumers, in the per-panel sweep's intra-slot key order
    # (window tails first, then ascending). In fused mode EVERY sweep
    # node — the multi-member fused dispatch and the single-member
    # per-panel fallback alike — is constructed at its slot's
    # assembly iteration, so a panel's update chain is built in
    # ascending record order even when its slots alternate between
    # fused and solo (segmented ``applied_through`` maps make the
    # member sets non-monotone across slots).
    sweep_of: Dict[int, List[int]] = {}
    if fused_apply is not None:
        for q in mine_tr:
            for s in range(at(q), min(q, last + 1)):
                if not _promo(q, s):
                    sweep_of.setdefault(s, []).append(q)
        for s in sweep_of:
            sweep_of[s].sort(key=lambda q: (0 if q <= s + d else 1, q))

    # --- node closures ----------------------------------------------
    def _run_stage(p: int) -> None:
        sj[p] = st.take(p)

    def _run_update(p: int, s: int, promo: bool,
                    pref: Optional[int]) -> None:
        if promo:
            _chk(p)
        t0 = time.perf_counter()
        with _ledger.frame("stage"):
            S = sj.pop(p, None)
            if S is None:
                S = st.take(p)
        if pref is not None:
            st.prefetch_panel(pref)
        r = recs[s]
        if promo:
            with obs_events.span("shard::update", cat="shard",
                                 panel=p, step=s, ahead=True), \
                    _ledger.frame("update"):
                S = apply(S, r, p)
        else:
            with obs_events.span("shard::update", cat="shard",
                                 panel=p, step=s), \
                    _ledger.frame("update"):
                S = apply(S, r, p)
        st.stash(p, S)
        remaining[s] -= 1
        if remaining[s] <= 0:
            recs.pop(s, None)
        if not promo:
            obs_metrics.inc("ooc.shard.update_seconds",
                            time.perf_counter() - t0)

    def _run_fused_update(s: int, members: List[int]) -> None:
        # each member's step check, ascending panel order (the
        # once-a-panel rule — the checked-set keeps the
        # members' later per-panel nodes from re-firing it)
        for p in sorted(members):
            _chk(p)
        t0 = time.perf_counter()
        Ss = []
        with _ledger.frame("stage"):
            for p in members:
                S = sj.pop(p, None)
                if S is None:
                    S = st.take(p)
                Ss.append(S)
        r = recs[s]
        with obs_events.span("shard::update", cat="shard", step=s,
                             fused=len(members)), \
                _ledger.frame("update"):
            Ss = fused_apply(Ss, r, list(members), s)
        for p, S in zip(members, Ss):
            st.stash(p, S)
        remaining[s] -= len(members)
        if remaining[s] <= 0:
            recs.pop(s, None)
        if obs_events.enabled():
            obs_metrics.inc("ooc.visits_fused", len(members))
            obs_metrics.inc("ooc.visit_dispatches_saved",
                            len(members) - 1)
        obs_metrics.inc("ooc.shard.update_seconds",
                        time.perf_counter() - t0)

    def _run_factor(i: int) -> None:
        _chk(i)
        with _ledger.frame("stage"):
            S = st.take(i)
        with obs_events.span("shard::factor", cat="shard", panel=i,
                             ahead=ahead(i)), _ledger.frame("factor"):
            payloads[i] = make_payload(i, S)
        st.discard(i)

    def _run_bcast(i: int) -> None:
        _chk(i)
        shape, dtype = payload_shape(i)
        frames[i] = bc.broadcast_async(
            payloads.pop(i, None), sched.owner_flat(i), shape, dtype,
            panel=i, ahead=ahead(i))

    def _run_wb(i: int) -> None:
        _chk(i)
        recs[i] = complete(i, bc.complete(frames.pop(i)))
        if remaining.get(i, 0) <= 0:
            recs.pop(i, None)

    def _run_replay(i: int) -> None:
        _chk(i)
        recs[i] = replay(i)
        if remaining.get(i, 0) <= 0:
            recs.pop(i, None)

    def _run_tail(k: int) -> None:
        _chk(k)
        if k < ep:
            return          # durable on resume, same as the walk
        tail(k)

    # --- assembly (ascending panel order, so every dep exists) ------
    mine_set = set(mine_tr)
    wbn: Dict[int, Any] = {}
    un_last: Dict[int, Any] = {}
    prev_tail = None
    npanels = (tail_panels[-1] + 1) if len(tail_panels) else (last + 1)
    if trailing_to is not None:
        npanels = max(npanels, int(trailing_to))
    for p in range(npanels):
        if p in mine_set:
            prev = un_last.get(p)
            for s in range(at(p), min(p, last + 1)):
                promo = _promo(p, s)
                if fused_apply is not None and not promo:
                    continue     # built at slot s's iteration below
                if promo:
                    key = (max(p - d, 0), 1, p, s, 1)
                else:
                    key = (s, 4, 0 if p <= s + d else 1, p, 1)
                if prev is None:
                    prev = g.add("stage", partial(_run_stage, p),
                                 panel=p,
                                 owner=sched.owner_flat(p),
                                 key=key[:-1] + (0,))
                prev = g.add(
                    "update",
                    partial(_run_update, p, s, promo,
                            pref_of.get(p) if s == 0 else None),
                    panel=p, step=s, owner=sched.owner_flat(s),
                    key=key, deps=[prev, wbn.get(s)])
            un_last[p] = prev
        if p <= last:
            owner = sched.owner_flat(p)
            if p >= ep:
                fnode = None
                if sched.is_mine(p):
                    fnode = g.add("factor", partial(_run_factor, p),
                                  panel=p, owner=owner,
                                  key=(slot_issue(p), 2, p, 0, 0),
                                  deps=[un_last.get(p)])
                bnode = g.add("bcast", partial(_run_bcast, p),
                              panel=p, owner=owner,
                              key=(slot_issue(p), 3, p, 0, 0),
                              deps=[fnode, wbn.get(p - 1)])
                wbn[p] = g.add("writeback", partial(_run_wb, p),
                               panel=p, owner=owner,
                               key=(slot_wb(p), 0, p, 0, 0),
                               deps=[bnode, wbn.get(p - 1)])
            elif applied_through is None or remaining.get(p, 0) > 0:
                # segmented construction: replay only records a
                # pruned-aware consumer still needs (catch-up
                # panels); the unsegmented route keeps every replay
                # node — same fault-check sequence as the walk
                wbn[p] = g.add("writeback", partial(_run_replay, p),
                               panel=p, owner=owner,
                               key=(slot_wb(p), 0, p, 0, 0),
                               deps=[wbn.get(p - 1)])
            # slot p's trailing sweep in fused mode: one
            # fused_update node when the sweep has >1 member; the
            # per-panel fallback for a solo member (already one
            # dispatch). Built here — after record p's writeback/
            # replay node — so every member's chain grows in
            # ascending record order.
            ms = sweep_of.get(p, ())
            if len(ms) > 1:
                fn = g.add(
                    "fused_update",
                    partial(_run_fused_update, p, list(ms)),
                    step=p, owner=sched.owner_flat(p),
                    key=(p, 4, 0 if ms[0] <= p + d else 1, ms[0], 1),
                    deps=[wbn.get(p)] + [un_last.get(q) for q in ms])
                for q in ms:
                    un_last[q] = fn
            elif len(ms) == 1:
                q = ms[0]
                key = (p, 4, 0 if q <= p + d else 1, q, 1)
                prevq = un_last.get(q)
                if prevq is None:
                    prevq = g.add("stage", partial(_run_stage, q),
                                  panel=q,
                                  owner=sched.owner_flat(q),
                                  key=key[:-1] + (0,))
                un_last[q] = g.add(
                    "update",
                    partial(_run_update, q, p, False,
                            pref_of.get(q) if p == 0 else None),
                    panel=q, step=p, owner=sched.owner_flat(p),
                    key=key, deps=[prevq, wbn.get(p)])
        elif p in tail_set:
            prev_tail = g.add("bcast", partial(_run_tail, p),
                              panel=p, owner=sched.owner_flat(p),
                              key=(p, 0, p, 0, 0),
                              deps=[un_last.get(p), wbn.get(last),
                                    prev_tail])
    return g

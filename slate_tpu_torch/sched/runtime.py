"""Graph executor (counterpart of ``slate_tpu/sched/runtime.py``).

:func:`execute` drives a validated :class:`~.graph.TaskGraph` to
completion. The nodes are closures over the walks' own code, so the
runtime owns only the ORDER: ready nodes sit in a min-heap keyed
``(node.key, node.seq)`` and exactly one runs at a time. Policies choose
keys so that the ready order is the walk's issue order, which keeps the
graph route's results bitwise the walk's.

``key[0]`` is a node's *slot* (the panel step of the walk it belongs
to). On each slot change the runtime calls ``end_step(prev_slot)``,
beats the stall watchdog (obs/health.py, the walks' cadence) and calls
``begin_step(slot)``: drivers hang their flight-recorder records and
checkpoint commits on these hooks. Each node runs inside
``ledger.frame(PHASE_OF_KIND[node.kind])``.

With obs on, ``sched.nodes_issued`` counts nodes and
``sched.issue_overhead_seconds`` accrues the loop's wall less the
nodes' wall.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Optional

from ..core.exceptions import slate_assert
from ..obs import events as obs_events
from ..obs import health as _health
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from .graph import PHASE_OF_KIND, TaskGraph


def execute(graph: TaskGraph, *, op: str,
            nt: Optional[int] = None,
            begin_step: Optional[Callable[[int], None]] = None,
            end_step: Optional[Callable[[int], None]] = None) -> None:
    """Run every node of `graph` in dependency + priority order.

    `op` names the driver for the watchdog's heartbeats; `nt` is the
    slot count (the progress denominator). `begin_step` / `end_step`
    fire on slot changes (slot = ``node.key[0]``), bracketing the nodes
    of one slot: one iteration of the walk's panel loop.
    """
    graph.validate()
    nin = {n: n._nin for n in graph.nodes}
    heap = [(n.key, n.seq, n) for n in graph.nodes if nin[n] == 0]
    heapq.heapify(heap)

    obs_on = obs_events.enabled()
    t_loop = time.perf_counter() if obs_on else 0.0
    t_nodes = 0.0
    executed = 0
    cur_slot: Optional[int] = None
    # on an exception (an injected step fault) the in-flight slot's
    # end_step does NOT fire, as in the walk, where the record and the
    # checkpoint commit of an interrupted step are skipped
    while heap:
        _key, _seq, node = heapq.heappop(heap)
        slot = node.key[0] if node.key else 0
        if slot != cur_slot:
            if cur_slot is not None and end_step is not None:
                end_step(cur_slot)
            _health.heartbeat(op, slot, nt)
            if begin_step is not None:
                begin_step(slot)
            cur_slot = slot
        if obs_on:
            t0 = time.perf_counter()
        with _ledger.frame(PHASE_OF_KIND[node.kind]):
            node.run()
        if obs_on:
            t_nodes += time.perf_counter() - t0
        executed += 1
        for m in node._outs:
            nin[m] -= 1
            if nin[m] == 0:
                heapq.heappush(heap, (m.key, m.seq, m))
    slate_assert(
        executed == len(graph.nodes),
        "%r graph deadlocked: %d of %d nodes never became ready"
        % (op, len(graph.nodes) - executed, len(graph.nodes)))
    if cur_slot is not None and end_step is not None:
        end_step(cur_slot)
    if obs_on:
        obs_metrics.inc("sched.nodes_issued", executed)
        obs_metrics.inc(
            "sched.issue_overhead_seconds",
            max(time.perf_counter() - t_loop - t_nodes, 0.0))
        obs_metrics.inc("sched.graphs")

"""Graph constructors reproducing the walks' schedules (counterpart of
``slate_tpu/sched/policies.py``).

:func:`left_looking` builds the single-engine out-of-core stream
(potrf_ooc / geqrf_ooc / getrf_tntpiv_ooc) as a graph: per panel k a
``stage -> update(0..k-1) -> factor -> writeback`` chain, where update
(k, j) also depends on panel j's writeback. Its ``key`` tuples make the
executor's ready order the walk's issue order (runtime.py).

The sharded stream's constructor (the reference's ``sharded_stream``,
the block-cyclic walk of dist/shard_ooc.py) needs the panel
broadcaster of ``dist/``; it comes with ROADMAP queue 1, item 10, and
:func:`sharded_stream` raises until then.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence

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


def sharded_stream(op: str, **_kw) -> TaskGraph:
    """The sharded block-cyclic walk as a graph: not ported; it needs
    the panel broadcaster and the process grid of ``dist/``."""
    from ..linalg.lu import _not_ported
    raise _not_ported("sched.policies.sharded_stream (the sharded OOC "
                      "stream, dist/shard_ooc.py, item 10)")

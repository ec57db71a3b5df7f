"""Task-graph runtime (counterpart of ``slate_tpu/sched/``).

The out-of-core streams' panel loops as explicit dependency graphs:

* :mod:`.graph`: typed nodes (``stage`` / ``factor`` / ``solve`` /
  ``update`` / ``fused_update`` / ``bcast`` / ``writeback``) with
  panel / step / owner labels, declared edges, and cycle and orphan
  validation;
* :mod:`.policies`: the graph constructor that reproduces the
  single-engine left-looking walk (:func:`left_looking`);
* :mod:`.runtime`: :func:`execute`, which issues ready nodes one at a
  time through the same closures the walks run, with a deterministic
  tie-break, so graph results are bitwise the walk's.

The choice rides the FROZEN ``ooc/scheduler`` row ("walk": the loops;
"graph": this runtime). The sharded stream's constructor
(``sharded_stream``) needs the broadcaster of ``dist/`` and comes with
it (ROADMAP queue 1, item 10).
"""

from .graph import (FAULT_SITE_OF_KIND, NODE_KINDS, PHASE_OF_KIND,
                    Node, TaskGraph)
from .policies import left_looking
from .runtime import execute

__all__ = ["NODE_KINDS", "PHASE_OF_KIND", "FAULT_SITE_OF_KIND",
           "Node", "TaskGraph", "execute", "left_looking"]

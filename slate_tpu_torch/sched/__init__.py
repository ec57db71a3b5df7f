"""Task-graph runtime (counterpart of ``slate_tpu/sched/``).

The out-of-core streams' panel loops as explicit dependency graphs:

* :mod:`.graph`: typed nodes (``stage`` / ``factor`` / ``solve`` /
  ``update`` / ``fused_update`` / ``bcast`` / ``writeback``) with
  panel / step / owner labels, declared edges, and cycle and orphan
  validation;
* :mod:`.policies`: the graph constructors that reproduce the
  single-engine left-looking walk (:func:`left_looking`) and the
  sharded block-cyclic walk of dist/shard_ooc.py
  (:func:`sharded_stream`);
* :mod:`.runtime`: :func:`execute`, which issues ready nodes one at a
  time through the same closures the walks run, with a deterministic
  tie-break, so graph results are bitwise the walk's.

The choice rides the FROZEN ``ooc/scheduler`` row ("walk": the loops;
"graph": this runtime).
"""

from .graph import (FAULT_SITE_OF_KIND, NODE_KINDS, PHASE_OF_KIND,
                    Node, TaskGraph)
from .policies import left_looking, sharded_stream
from .runtime import execute

__all__ = ["NODE_KINDS", "PHASE_OF_KIND", "FAULT_SITE_OF_KIND",
           "Node", "TaskGraph", "execute", "left_looking",
           "sharded_stream"]

"""Typed panel-op dependency graphs (counterpart of
``slate_tpu/sched/graph.py``, plain Python, copied with its messages).

A :class:`TaskGraph` is a DAG of :class:`Node` s, each a closure over
the engines and kernels the walks drive, labelled with a kind from the
closed set :data:`NODE_KINDS`:

    stage         host -> device staging of a panel's input
    factor        the in-core panel factor
    solve         a streamed triangular / apply solve step (reserved:
                  no constructor emits one)
    update        a trailing-panel update against a finished panel
    fused_update  one update covering a step's whole visit sweep
    bcast         broadcast of a factored panel (the sharded stream)
    writeback     writeback of results to the host factor

:data:`PHASE_OF_KIND` maps every kind onto the flight recorder's
closed ``PHASES`` column (obs/ledger.py): the runtime runs each node
inside that frame. :data:`FAULT_SITE_OF_KIND` names the fault site
(resil/faults.py ``SITES``) covering the kinds that move data.

Edges are declared at construction (``deps=`` or :meth:`TaskGraph.
add_edge`); :meth:`TaskGraph.validate` rejects cycles (Kahn) and
orphans (a node with no edge at all in a multi-node graph is almost
always a forgotten dependency).

Determinism: the runtime runs nodes one at a time in ``(key, seq)``
min-order among the ready ones. Policies choose the keys so that this
order is the walk's issue order: the graphs run the same operations in
the same sequence on the same operands, which is what the bitwise
checks hold.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.exceptions import slate_assert

#: the CLOSED set of node kinds
NODE_KINDS = ("stage", "factor", "solve", "update", "fused_update",
              "bcast", "writeback")

#: node kind -> obs/ledger.py PHASES column the runtime frames it in
PHASE_OF_KIND = {
    "stage": "stage",
    "factor": "factor",
    "solve": "update",
    "update": "update",
    "fused_update": "update",
    "bcast": "bcast_wait",
    "writeback": "cache",
}

#: node kind -> resil/faults.py SITES entry covering it, for the kinds
#: that move data (None: pure compute). The stage / writeback sites
#: fire inside StreamEngine (h2d / d2h); the per-panel ``step`` site
#: fires from the drivers' stage closures, where the walks check it.
FAULT_SITE_OF_KIND = {
    "stage": "h2d",
    "factor": None,
    "solve": None,
    "update": None,
    "fused_update": None,
    "bcast": "ppermute",
    "writeback": "d2h",
}


class Node:
    """One schedulable unit: a closure plus its labels and edges."""

    __slots__ = ("kind", "run", "panel", "step", "owner", "key",
                 "seq", "deps", "_outs", "_nin")

    def __init__(self, kind: str, run: Callable[[], Any], *,
                 panel: Optional[int] = None,
                 step: Optional[int] = None,
                 owner: Optional[int] = None,
                 key: Tuple[int, ...] = (),
                 seq: int = 0) -> None:
        self.kind = kind
        self.run = run
        self.panel = panel
        self.step = step
        self.owner = owner
        self.key = tuple(key)
        self.seq = seq
        self.deps: List["Node"] = []
        self._outs: List["Node"] = []
        self._nin = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "Node(%s, panel=%r, step=%r, key=%r)" % (
            self.kind, self.panel, self.step, self.key)


class TaskGraph:
    """A DAG of :class:`Node` s with edge-declared dependencies."""

    def __init__(self, op: str = "") -> None:
        self.op = op
        self.nodes: List[Node] = []

    def add(self, kind: str, run: Callable[[], Any], *,
            panel: Optional[int] = None, step: Optional[int] = None,
            owner: Optional[int] = None,
            key: Tuple[int, ...] = (),
            deps: Sequence[Optional[Node]] = ()) -> Node:
        """Append a node; ``deps`` entries that are None are skipped
        (policies write ``deps=[maybe_node]`` unconditionally)."""
        slate_assert(kind in NODE_KINDS,
                     "unknown node kind %r (have %s)"
                     % (kind, list(NODE_KINDS)))
        n = Node(kind, run, panel=panel, step=step, owner=owner,
                 key=key, seq=len(self.nodes))
        self.nodes.append(n)
        for d in deps:
            if d is not None:
                self.add_edge(d, n)
        return n

    def add_edge(self, a: Node, b: Node) -> None:
        """Declare that ``a`` completes before ``b`` runs."""
        slate_assert(a is not b, "self-edge on %r" % (a,))
        if a in b.deps:
            return
        b.deps.append(a)
        a._outs.append(b)
        b._nin += 1

    def validate(self) -> None:
        """Reject cycles (Kahn's algorithm) and orphans (a node with
        no edge at all, in a graph of >= 2 nodes)."""
        if len(self.nodes) >= 2:
            for n in self.nodes:
                slate_assert(
                    n.deps or n._outs,
                    "orphan %s node (panel=%r, step=%r) in %r graph: "
                    "no dependencies in either direction — it would "
                    "run at priority order only"
                    % (n.kind, n.panel, n.step, self.op))
        nin = {n: n._nin for n in self.nodes}
        ready = [n for n in self.nodes if nin[n] == 0]
        done = 0
        while ready:
            n = ready.pop()
            done += 1
            for m in n._outs:
                nin[m] -= 1
                if nin[m] == 0:
                    ready.append(m)
        slate_assert(
            done == len(self.nodes),
            "cycle in %r graph: %d of %d nodes unreachable by "
            "topological order" % (self.op, len(self.nodes) - done,
                                   len(self.nodes)))

    def counts(self) -> Dict[str, int]:
        """Node count per kind."""
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.kind] = out.get(n.kind, 0) + 1
        return out

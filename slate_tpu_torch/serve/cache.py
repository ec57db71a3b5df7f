"""LRU factor cache (counterpart of ``slate_tpu/serve/cache.py``).

Many solves against the SAME operator are the production pattern the
cache serves. Each such solve through the plain queue re-runs the
O(n^3) factorization; this cache keys the CROPPED host factors
(potrf's L, getrf's packed L\\U + pivots) by
``resil.checkpoint.fingerprint``'s strided CRC, so a repeat solve skips
to the O(n^2) solve-only dispatch (batch/drivers potrs / getrs), which
the ragged strategy coalesces across sizes.

Mechanism only: a byte-bounded LRU over CPU tensors, thread-safe, with
local hit / miss / eviction counts (readable with the obs bus off;
serve/server.py publishes the ``serve.cache.*`` obs mirrors at its
decision points). Stored factors are contiguous copies of what the
queue returned, so an entry holds no view of a whole flush's output.

Departure from the reference (ROADMAP queue 3): torch has no read-only
tensors, where the reference write-protects its cached arrays and
hands the cached buffer itself to a factor request. Here the server
hands every potrf / getrf request served from the cache a ``clone()``,
so a caller that writes into its factor cannot corrupt later hits; the
solve-only submissions pass the cached tensor to the queue, which
copies it into its staging pad.

The budget rides the tuned ``serve/cache_mb`` row: FROZEN 0 = no cache
object at all, and the daemon forwards requests unchanged to the queue
(the cold route is bitwise that of direct queue use).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import torch


class FactorCache:
    """Byte-bounded LRU of factor tuples keyed by
    ``(family, fingerprint)``. Values are tuples of CPU tensors:
    ``(L,)`` for the Cholesky family, ``(lu, piv)`` for LU."""

    def __init__(self, budget_mb: float) -> None:
        self.budget_bytes = int(float(budget_mb) * (1 << 20))
        self._lock = threading.Lock()
        #: key -> (factors tuple, nbytes), LRU order (last = MRU)
        self._entries: "OrderedDict[Any, Tuple[tuple, int]]" = \
            OrderedDict()
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key, trace: Optional[str] = None
            ) -> Optional[tuple]:
        """The cached factor tuple (promoted to MRU), or None.

        `trace` (obs/reqtrace.py): the requesting span's trace id. When
        given and the bus is on, the outcome is published as a
        trace-stamped ``serve::cache`` instant. None (tracing off) skips
        even the bus check."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._misses += 1
                out = None
            else:
                self._entries.move_to_end(key)
                self._hits += 1
                out = e[0]
        if trace is not None:
            from ..obs import events as _oe
            if _oe.enabled():
                # published outside the lock
                _oe.instant("serve::cache", cat="serve", trace=trace,
                            outcome="miss" if out is None else "hit")
        return out

    def peek(self, key) -> Optional[tuple]:
        """get() without counting or promotion: the server's chainer
        re-reads the entry it just put and must not skew hit stats."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else e[0]

    def put(self, key, factors: tuple) -> int:
        """Insert one factor tuple, evicting LRU entries until the byte
        budget holds. Returns the number of evictions this insert caused.
        An entry larger than the whole budget is not cached (0
        evictions: never flush a working set for one oversized
        operator); a re-insert of a present key just promotes it."""
        factors = tuple(torch.as_tensor(f).detach().cpu().clone(
            memory_format=torch.contiguous_format) for f in factors)
        nb = sum(f.numel() * f.element_size() for f in factors)
        if nb > self.budget_bytes:
            return 0
        evicted = 0
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return 0
            self._entries[key] = (factors, nb)
            self._bytes += nb
            while self._bytes > self.budget_bytes and \
                    len(self._entries) > 1:
                _k, (_f, old_nb) = self._entries.popitem(last=False)
                self._bytes -= old_nb
                self._evictions += 1
                evicted += 1
        return evicted

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        """Local mirror of the serve.cache.* obs counters (works with
        the bus disabled, like queue.stats())."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "entries": len(self._entries),
                    "bytes": self._bytes,
                    "budget_bytes": self.budget_bytes}

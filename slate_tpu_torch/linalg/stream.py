"""Out-of-core streaming engine (counterpart of
``slate_tpu/linalg/stream.py``), shared by every linalg/ooc.py driver:
a device-memory panel-residency cache and a double-buffered
asynchronous transfer pipeline between host memory and the card.

* ``PanelCache``: a budget-aware device-resident cache of visiting
  panels, keyed ``(buffer, epoch, panel index)``. ``invalidate(buf)``
  bumps the buffer's epoch, so getrf_ooc's host-side row-swap fixups
  retire the cached L panels instead of serving stale rows. The working
  panels (current visit + prefetched next) are pinned against eviction.
  The policy is tunable (``ooc/cache_policy``): the shipped ``mru``
  keeps a stable resident prefix on the cyclic revisits of a
  left-looking stream, where ``lru`` evicts each panel right before its
  reuse; ``lru`` and ``fifo`` are there for measurement.
* ``StreamEngine``: uploads of the next panel run on a transfer thread
  while the current visit computes, and a writer thread returns each
  finished panel to the host factor while the next panel streams in.
  Writeback futures are keyed like cache entries, so a miss that must
  re-read a panel from host memory waits for that panel's writeback
  only.
* ``StreamEngine.stash``: a DIRTY working panel (a state the host copy
  does not hold yet) kept resident under the same budget; evicting it
  spills it through the writer, and a later fetch waits that spill.
  Budget 0 makes every stash an immediate write.

On the card (``device.type == "cuda"``, and only there) a transfer
goes through pinned memory and a stream of its own:

* an engine owns two pinned staging buffers of one panel each for
  uploads (allocated at first use and reused); the uploading thread
  gathers the host view (a column panel of a C-ordered matrix is not
  contiguous) into a buffer, issues ``copy_(non_blocking=True)`` on the
  engine's copy stream and records an event; a buffer is refilled only
  after the event of its last copy has completed. A transfer larger
  than one buffer goes through both in turn, a buffer's worth of rows
  at a time;
* the consumer makes its current stream wait on the upload's event
  before the visit and calls ``record_stream`` on the tensor, which was
  allocated on the copy stream: an evicted entry is then never reused
  by the allocator while a visit still reads it;
* the writer thread waits on an event recorded after the kernel that
  produced the panel, copies it into a pinned buffer on its own stream,
  synchronizes, and copies into the caller's ``out=`` slice of the host
  factor;
* each worker thread sets its device and runs under its stream.

On the CPU the same threads run plain copies. Mixed-precision
residency (``ooc/precision`` bf16): the drivers demote factor panels to
the lo dtype at every staging boundary (``demote_host`` in the revisit
loaders, so uploads carry half the bytes; ``demote_dev`` before
``put``, so residents charge half the budget) and promote back
(``promote_dev``) where full precision returns. Numpy has no bf16, so
``demote_host`` returns a CPU torch tensor. Both directions are counted
(``ooc.cast_demote_bytes`` / ``ooc.cast_promote_bytes``).

Budget contract: ``cache_budget_bytes=0`` disables the cache and every
fetch takes the upload path of an uncached stream, bitwise; the FROZEN
default is 0 (tune/cache.py). "auto" sizes the budget from the card's
free memory minus a working-set reserve of ``RESERVE_PANELS`` panels,
and is 0 off the card.

Observability: ``ooc.h2d_bytes`` / ``ooc.d2h_bytes``, the
``ooc.cache.*`` counters (hits, misses, evictions, invalidations,
served bytes), ``ooc.prefetch.*`` / ``ooc.d2h.*`` overlap, and spans of
every transfer on the event bus.

Left out on purpose: the reference's ``_d2h`` chunks a writeback over
8 threads, a measure for a tunneled transport; here a writeback is one
pinned copy on the writer's stream.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import events as obs_events
from ..obs import ledger as _ledger
from ..obs import metrics as obs_metrics
from ..ops.kernels import _torch_dtype
from ..resil import faults as _faults
from ..resil import guard as _guard
from ..utils.backend import resolve_device

#: working-set reserve of the "auto" budget: two resident (m, w)
#: panels (S + visiting), one prefetched, one in writeback flight
RESERVE_PANELS = 4

#: headroom factor on the card's free memory: the caching allocator
#: needs slack for the visits' temporaries beyond the working panels
AUTO_BUDGET_FRACTION = 0.9

#: most recent finished engine's stats; last writer wins
_last_stats: Dict[str, Any] = {}


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype)).element_size()


def _host_tensor(x) -> torch.Tensor:
    """A CPU torch view of a host array (a numpy array is shared, not
    copied; a read-only one is copied, since torch views must be
    writable)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable:
        x = np.array(x)
    return torch.from_numpy(x)


def _host_nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size() * x.numel()
    return int(np.asarray(x).nbytes)


def _nbytes(arr) -> int:
    return arr.element_size() * arr.numel()


class _Stager:
    """Two pinned host buffers and one stream, for the transfers of one
    direction on the card (module doc). Transfers through one stager
    run one at a time (a lock): the upload thread and the consumer's
    synchronous misses share the upload stager."""

    def __init__(self, capacity: int, device: torch.device) -> None:
        self.capacity = max(int(capacity), 1 << 16)
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: list = [None, None]
        self._events: list = [None, None]
        self._next = 0
        self._lock = threading.Lock()

    def _slot(self, nbytes: int) -> Tuple[int, torch.Tensor]:
        """The next buffer, after its last copy completed, holding at
        least `nbytes` (grown up to the capacity when a transfer needs
        more than its first one did)."""
        i = self._next
        self._next ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
            # slate-lint: exempt[SL301] callers h2d/d2h hold self._lock
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._bufs[i] = buf
        return i, buf

    def _chunks(self, shape, elsize: int):
        rows = shape[0] if len(shape) else 1
        row_bytes = elsize * int(np.prod(shape[1:])) if len(shape) > 1 \
            else elsize
        step = max(1, self.capacity // max(row_bytes, 1))
        return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]

    def h2d(self, x) -> torch.Tensor:
        """`x` (host) on the card, enqueued on this stager's stream."""
        src = _host_tensor(x)
        elsize = src.element_size()
        with self._lock, torch.cuda.stream(self.stream):
            dst = torch.empty(src.shape, dtype=src.dtype,
                              device=self.device)
            if src.dim() == 0 or src.numel() == 0:
                dst.copy_(src)
                return dst
            for r0, r1 in self._chunks(src.shape, elsize):
                part = src[r0:r1]
                nb = part.numel() * elsize
                i, buf = self._slot(nb)
                pin = buf[:nb].view(src.dtype).view(part.shape)
                pin.copy_(part)               # the host gather
                dst[r0:r1].copy_(pin, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self._events[i] = ev
        return dst

    def d2h(self, x: torch.Tensor, out: np.ndarray) -> np.ndarray:
        """`x` (on the card) into the host array `out`, the copy of a
        chunk into `out` overlapping the transfer of the next one.
        Ordered after whatever this stager's stream waits on."""
        dst = _host_tensor(out)
        elsize = x.element_size()
        with self._lock, torch.cuda.stream(self.stream):
            if x.dim() == 0 or x.numel() == 0:
                dst.copy_(x.cpu())
                return out
            prev = None
            for r0, r1 in self._chunks(x.shape, elsize) + [(None, None)]:
                if r0 is not None:
                    part = x[r0:r1]
                    nb = part.numel() * elsize
                    i, buf = self._slot(nb)
                    pin = buf[:nb].view(x.dtype).view(part.shape)
                    pin.copy_(part, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self.stream)
                    self._events[i] = ev
                if prev is not None:
                    j, p0, p1, ppin = prev
                    self._events[j].synchronize()
                    self._events[j] = None
                    dst[p0:p1].copy_(ppin)
                prev = None if r0 is None else (i, r0, r1, pin)
        return out


def _h2d(x, device=None, stager: Optional[_Stager] = None
         ) -> torch.Tensor:
    """Host-to-device copy of a host array (numpy, or a CPU torch tensor
    from ``demote_host``). Through `stager` (the engine's, on the card)
    the copy is enqueued on its stream and the caller orders its use
    (module doc); without one, a plain copy ordered on the current
    stream. On the CPU the result is a copy, never a view of the host
    array (the host factor keeps changing under a stream)."""
    if not obs_events.enabled():
        return _h2d_raw(x, device, stager)
    nb = _host_nbytes(x)
    obs_metrics.inc("ooc.h2d_bytes", nb)
    with obs_events.span("ooc::h2d", cat="staging", bytes=nb):
        return _h2d_raw(x, device, stager)


def _h2d_raw(x, device, stager):
    if stager is not None:
        return stager.h2d(x)
    dev = resolve_device(device)
    src = _host_tensor(x)
    if dev.type == "cpu":
        return src.clone(memory_format=torch.contiguous_format)
    return src.contiguous().to(dev)


def _d2h(x: torch.Tensor, out: Optional[np.ndarray] = None,
         stager: Optional[_Stager] = None) -> np.ndarray:
    """Device-to-host copy of a block into `out`, a caller-provided
    writable view of x's shape (any slice of the host factor: no extra
    full host copy), or a fresh array. Through `stager` on the card
    (the engine's writer); otherwise a plain copy."""
    if obs_events.enabled():
        obs_metrics.inc("ooc.d2h_bytes", _nbytes(x))
    if out is None:
        out = np.empty(tuple(x.shape), _numpy_dtype(x.dtype))
    with obs_events.span("ooc::d2h", cat="staging"):
        if stager is not None:
            return stager.d2h(x, out)
        _host_tensor(out).copy_(x)
    return out


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _suffix_rows(P: torch.Tensor, off: int, rows: int) -> torch.Tensor:
    """Rows [off:off + rows] of a cached full-height panel (a view)."""
    return P[off:off + rows]


def _embed_rows(P: torch.Tensor, off: int, n: int) -> torch.Tensor:
    """Zero-embed a (rows, w) panel at row offset `off` of an (n, w)
    frame: how a just-factored potrf panel (rows k0:) enters the cache
    at the full-height form every later visit slices. Rows above the
    offset are exact zeros, as in the zero-initialized host factor, so
    a cached entry is bitwise the uploaded column it replaces."""
    frame = torch.zeros((n, P.shape[1]), dtype=P.dtype, device=P.device)
    frame[off:off + P.shape[0]] = P
    return frame


# -- mixed-precision residency casts ----------------------------------------
#
# ``ooc.cast_demote_bytes`` counts the full-precision bytes entering a
# demotion, ``ooc.cast_promote_bytes`` the full-precision bytes a
# promotion produces (the reference's accounting).


def demote_dev(arr: torch.Tensor, dtype) -> torch.Tensor:
    """Demote a just-computed device panel to the resident lo dtype."""
    if obs_events.enabled():
        obs_metrics.inc("ooc.cast_demote_bytes", _nbytes(arr))
    return arr.to(_torch_dtype(dtype))


def demote_host(x, dtype) -> torch.Tensor:
    """Demote a host factor slice for staging: the mixed loaders wrap
    every revisit upload in it, halving its H2D bytes. Returns a
    contiguous CPU torch tensor of the lo dtype (numpy has no bf16)."""
    src = _host_tensor(x)
    if obs_events.enabled():
        obs_metrics.inc("ooc.cast_demote_bytes", _host_nbytes(src))
    return src.to(dtype=_torch_dtype(dtype),
                  memory_format=torch.contiguous_format)


def host_demoter(lo) -> Callable:
    """The staging-boundary demotion as ONE loader wrapper for every
    driver: the identity when `lo` is None (the full-precision path,
    bitwise), else demote_host into `lo`."""
    if lo is None:
        return lambda sl: sl
    return lambda sl: demote_host(sl, lo)


def promote_dev(arr: torch.Tensor, dtype) -> torch.Tensor:
    """Promote a lo-resident panel back to full precision."""
    out = arr.to(_torch_dtype(dtype))
    if obs_events.enabled():
        obs_metrics.inc("ooc.cast_promote_bytes", _nbytes(out))
    return out


def _guard_transfer(site: str, fn: Callable, **ctx):
    """Resilience wrapper of one host <-> device transfer. With no
    fault plan installed the success path is exactly ``fn()``; a real
    transient failure (guard.TRANSIENT_TYPES) still takes the bounded
    retry. With a plan the injection point fires first (site ``h2d`` /
    ``d2h`` with the buf / idx context), transient failures are retried
    the same way, and a ``nan`` rule poisons the transferred payload
    (the host view in place for a writeback)."""
    if _faults.active() is None:
        try:
            return fn()
        except Exception as e:
            if not _guard.is_transient(e):
                raise
            return _guard.retry_after_failure(fn, site, e, **ctx)

    def attempt():
        action = _faults.check(site, **ctx)
        out = fn()
        if action == "nan" and out is not None:
            if isinstance(out, np.ndarray):
                out *= np.nan
            else:
                out = out * float("nan")
        return out

    return _guard.retry(attempt, site, **ctx)


class PanelCache:
    """Budget-aware device-resident panel cache (module doc). Keys are
    (buf, epoch, idx), values device tensors, the budget is device
    bytes. Eviction drops the cache's reference; pinning keeps the
    POLICY from discarding the panels about to be reused."""

    def __init__(self, budget_bytes: int, policy: str = "mru",
                 pins: int = 2, resident_dtype=None) -> None:
        self.budget = max(int(budget_bytes), 0)
        self.policy = policy if policy in ("lru", "mru", "fifo") \
            else "mru"
        #: the dtype entries hold under the mixed-precision mode (None:
        #: the driver's dtype); reported in the stats
        self.resident_dtype = None if resident_dtype is None \
            else _torch_dtype(resident_dtype)
        #: optional (key, arr) callback fired for every eviction, UNDER
        #: the cache lock: it only records (the engine's spill hook)
        self.on_evict: Optional[Callable] = None
        self._lock = threading.Lock()
        #: key -> (array, nbytes); order = recency (get moves to end)
        self._entries: "collections.OrderedDict[Tuple, Tuple]" = \
            collections.OrderedDict()
        self._epochs: Dict[str, int] = {}
        #: the working panels the policy must not discard
        self._pins: "collections.deque[Tuple]" = \
            collections.deque(maxlen=max(int(pins), 2))
        self.resident_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.invalidated_bytes = 0
        self.served_bytes = 0
        self.uploaded_bytes = 0

    @property
    def enabled(self) -> bool:
        return self.budget > 0

    def key(self, buf: str, idx: int) -> Tuple:
        with self._lock:
            return (buf, self._epochs.get(buf, 0), idx)

    def get(self, key: Tuple, served_rows: Optional[int] = None):
        """The cached panel for `key` (recency-bumped + pinned), or
        None. `served_rows` scales the hit's byte credit when the
        consumer takes a row sub-view."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            arr, nb = ent
            rows = int(arr.shape[0]) or 1
            self.served_bytes += nb if served_rows is None \
                else nb * min(int(served_rows), rows) // rows
            self._pins.append(key)
            return arr

    def put(self, key: Tuple, arr) -> bool:
        """Insert, evicting per policy to fit the budget (pinned keys
        and the new entry are never victims). False when the cache is
        off, the entry alone exceeds the budget, or only pinned entries
        could make room."""
        if not self.enabled:
            return False
        nb = _nbytes(arr)
        if nb > self.budget:
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            while self.resident_bytes + nb > self.budget:
                victim = self._victim()
                if victim is None:
                    return False
                varr, vnb = self._entries.pop(victim)
                self.resident_bytes -= vnb
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(victim, varr)
            self._entries[key] = (arr, nb)
            self.resident_bytes += nb
            self._pins.append(key)
            return True

    def _victim(self) -> Optional[Tuple]:
        """Eviction choice under self._lock: lru = least recent, mru =
        most recent, fifo = oldest insertion. Pinned keys are
        skipped."""
        pinned = set(self._pins)
        order = list(self._entries)
        if self.policy == "mru":
            order.reverse()
        for k in order:
            if k not in pinned:
                return k
        return None

    def take(self, key: Tuple):
        """Pop one entry and return its array (None when absent),
        counting nothing and firing no on_evict."""
        with self._lock:
            ent = self._entries.pop(key, None)
            if ent is None:
                return None
            self.resident_bytes -= ent[1]
            return ent[0]

    def drop(self, key: Tuple) -> bool:
        """Remove one entry without counting an eviction (the caller
        supersedes the value). No-op when absent."""
        return self.take(key) is not None

    def invalidate(self, buf: str) -> int:
        """Bump `buf`'s epoch and drop its entries (getrf's row-swap
        fixup rewrote the host rows under them). Returns the number
        dropped."""
        with self._lock:
            self._epochs[buf] = self._epochs.get(buf, 0) + 1
            stale = [k for k in self._entries if k[0] == buf]
            for k in stale:
                _, nb = self._entries.pop(k)
                self.resident_bytes -= nb
                self.invalidated_bytes += nb
            self._pins = collections.deque(
                (k for k in self._pins if k[0] != buf),
                maxlen=self._pins.maxlen)
            if stale:
                self.invalidations += 1
            return len(stale)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "budget_bytes": self.budget,
                "policy": self.policy,
                "resident_dtype": None if self.resident_dtype is None
                else str(self.resident_dtype).replace("torch.", ""),
                "entries": len(self._entries),
                "resident_bytes": self.resident_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "invalidated_bytes": self.invalidated_bytes,
                "served_bytes": self.served_bytes,
                "uploaded_bytes": self.uploaded_bytes,
            }


def auto_budget_bytes(n: int, panel_cols: int, itemsize: int,
                      device=None) -> int:
    """The card's free memory (what ``cudaMemGetInfo`` reports, plus
    what the caching allocator holds unused) with allocator headroom,
    minus the working-set reserve of RESERVE_PANELS full panels. 0
    (cache off) off the card: "auto" never invents a budget."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return 0
    free, _total = torch.cuda.mem_get_info(dev)
    limit = int(free) + int(torch.cuda.memory_reserved(dev)) \
        - int(torch.cuda.memory_allocated(dev))
    if limit <= 0:
        return 0
    reserve = RESERVE_PANELS * int(n) * int(panel_cols) * int(itemsize)
    return max(int(limit * AUTO_BUDGET_FRACTION) - reserve, 0)


class StreamEngine:
    """One per driver call (or shared by a composed driver: gels_ooc's
    factor panels cached by geqrf are served to the unmqr apply). See
    the module doc. `stage_bytes` is one panel's bytes, the size of each
    pinned staging buffer on the card."""

    def __init__(self, budget_bytes: int = 0, policy: str = "mru",
                 prefetch_depth: int = 1, pins: int = 2,
                 resident_dtype=None, device=None,
                 stage_bytes: int = 1 << 26) -> None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the worker threads set this device: it needs its index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.cache = PanelCache(budget_bytes, policy, pins=pins,
                                resident_dtype=resident_dtype)
        self.prefetch_depth = max(int(prefetch_depth), 0)
        cuda = self.device.type == "cuda"
        self._up = _Stager(stage_bytes, self.device) if cuda else None
        self._down = _Stager(stage_bytes, self.device) if cuda else None
        init = self._thread_init if cuda else None
        self._h2d_pool = cf.ThreadPoolExecutor(
            1, thread_name_prefix="ooc-h2d", initializer=init) \
            if self.prefetch_depth > 0 else None
        self._d2h_pool = cf.ThreadPoolExecutor(
            1, thread_name_prefix="ooc-d2h", initializer=init)
        self._lock = threading.Lock()
        self._pending: Dict[Tuple, cf.Future] = {}
        self._writes: Dict[Tuple[str, int], list] = {}
        #: dirty working panels (stash): key -> (buf, idx, spill view
        #: factory); evicted dirty panels land in _evicted (under the
        #: cache lock, record-only) and are spilled by _drain_spills
        self._dirty: Dict[Tuple, Tuple] = {}
        self._evicted: list = []
        self.cache.on_evict = self._record_evicted
        self.spills = 0
        self._finished = False
        self.prefetch_issued = 0
        self.prefetch_upload_seconds = 0.0
        self.prefetch_wait_seconds = 0.0
        self.sync_upload_seconds = 0.0
        self.d2h_write_seconds = 0.0
        self.d2h_wait_seconds = 0.0
        self.writes_issued = 0

    def _thread_init(self) -> None:
        torch.cuda.set_device(self.device)

    @property
    def caching(self) -> bool:
        """Call sites switch loaders on this: cached mode wants the
        full-height panel (the insertable form), uncached mode exactly
        the rows the kernel consumes."""
        return self.cache.enabled

    # -- H2D side ---------------------------------------------------

    def _wait_write(self, buf: str, idx: int) -> None:
        """Block until `buf[idx]`'s host writeback (if any) landed: a
        re-read of the host factor must see the final rows. The wait is
        a ``cache`` stall on the flight recorder."""
        with self._lock:
            futs = list(self._writes.get((buf, idx), ()))
        if not futs:
            return
        t0 = time.perf_counter()
        for f in futs:
            f.result()
        _ledger.credit("cache", time.perf_counter() - t0)

    def _copy_stream(self):
        return torch.cuda.stream(self._up.stream) if self._up is not None \
            else contextlib.nullcontext()

    def _stage(self, buf: str, idx: int, host: Callable):
        """One guarded upload of `host()`: (tensor, event). On the card
        the tensor is complete once the event has; the guard's poison
        runs on the copy stream before it."""
        with self._copy_stream():
            arr = _guard_transfer(
                "h2d", lambda: _h2d(host(), self.device, self._up),
                buf=buf, idx=idx)
            ev = None
            if self._up is not None:
                ev = torch.cuda.Event()
                ev.record(self._up.stream)
        with self.cache._lock:
            self.cache.uploaded_bytes += _nbytes(arr)
        return arr, ev

    def _upload(self, buf: str, idx: int, loader: Callable):
        self._wait_write(buf, idx)
        return self._stage(buf, idx, loader)

    def _ready(self, arr, ev):
        """Order the consumer's stream after an upload (module doc)."""
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            arr.record_stream(cur)
        return arr

    def prefetch(self, buf: str, idx: int, loader: Callable,
                 cache: bool = True) -> None:
        """Queue `buf[idx]`'s upload on the transfer thread (no-op when
        cached, pending, or prefetch is off). The loader runs ON the
        worker: it must read host state that stays put until the
        matching fetch (a stale pending entry is fenced by the epoch in
        its key)."""
        if self._h2d_pool is None:
            return
        key = self.cache.key(buf, idx)
        with self._lock:
            if key in self._pending \
                    or len(self._pending) >= self.prefetch_depth:
                return
        if cache and self.cache.enabled:
            with self.cache._lock:
                if key in self.cache._entries:
                    return

        def task():
            t0 = time.perf_counter()
            with obs_events.span("ooc::prefetch", cat="staging",
                                 buf=buf, idx=idx):
                out = self._upload(buf, idx, loader)
            self.prefetch_upload_seconds += time.perf_counter() - t0
            return out

        self.prefetch_issued += 1
        fut = self._h2d_pool.submit(task)
        with self._lock:
            self._pending[key] = fut

    def _take_pending(self, key: Tuple):
        """The ready upload of a pending prefetch of `key`, or None."""
        with self._lock:
            fut = self._pending.pop(key, None)
        if fut is None:
            return None
        t0 = time.perf_counter()
        arr = self._ready(*fut.result())
        dt = time.perf_counter() - t0
        self.prefetch_wait_seconds += dt
        _ledger.credit("stage", dt)
        return arr

    def fetch(self, buf: str, idx: int, loader: Callable,
              view: Optional[Tuple[Any, int]] = None,
              cache: bool = True) -> Any:
        """The visiting panel `buf[idx]`: cache hit, pending prefetch or
        synchronous upload, in that order. `view=(offset, rows)` slices
        a served full-height entry to the rows the kernel consumes;
        with the cache off the loader returns the exact kernel input
        and `view` is ignored."""
        key = self.cache.key(buf, idx)
        use_cache = cache and self.cache.enabled
        if use_cache:
            arr = self.cache.get(
                key, None if view is None else view[1])
            if arr is not None:
                return self._serve(arr, view)
        arr = self._take_pending(key)
        if arr is None:
            t0 = time.perf_counter()
            with _ledger.frame("stage"):
                arr = self._ready(*self._upload(buf, idx, loader))
            self.sync_upload_seconds += time.perf_counter() - t0
        if use_cache:
            self.cache.put(key, arr)
            self._drain_spills()
            return self._serve(arr, view)
        return arr

    @staticmethod
    def _serve(arr, view: Optional[Tuple[Any, int]]):
        if view is None:
            return arr
        off, rows = view
        if off == 0 and rows == arr.shape[0]:
            return arr
        return _suffix_rows(arr, int(off), int(rows))

    def put(self, buf: str, idx: int, arr) -> bool:
        """Insert a just-computed device panel (a factored panel at its
        full-height form) so later visits never re-upload it."""
        if not self.cache.enabled:
            return False
        ok = self.cache.put(self.cache.key(buf, idx), arr)
        self._drain_spills()
        return ok

    def gather_stacked(self, buf: str, idxs: Sequence[int],
                       loaders: Sequence[Callable],
                       view: Optional[Tuple[Any, int]] = None) -> Any:
        """Panels ``buf[idxs]`` as ONE width-concatenated device array:
        a fused visit sweep's stacked operand. Residents and pending
        prefetches are collected per panel through :meth:`fetch`'s hit
        and pending paths; the misses are concatenated on the host and
        uploaded ONCE (the ``h2d`` fault site fires once, keyed by the
        first missing panel), then split back into per-panel cache
        entries (exact), so later steps still hit."""
        parts: list = [None] * len(idxs)
        misses: list = []
        use_cache = self.cache.enabled
        for pos, idx in enumerate(idxs):
            key = self.cache.key(buf, idx)
            if use_cache:
                arr = self.cache.get(
                    key, None if view is None else view[1])
                if arr is not None:
                    parts[pos] = self._serve(arr, view)
                    continue
            arr = self._take_pending(key)
            if arr is not None:
                if use_cache:
                    self.cache.put(key, arr)
                    self._drain_spills()
                    arr = self._serve(arr, view)
                parts[pos] = arr
                continue
            misses.append(pos)
        if misses:
            t0 = time.perf_counter()
            with _ledger.frame("stage"):
                for pos in misses:
                    self._wait_write(buf, idxs[pos])
                blocks = [_host_tensor(loaders[pos]()) for pos in misses]
                host = blocks[0] if len(blocks) == 1 \
                    else torch.cat(blocks, dim=1)
                stacked = self._ready(*self._stage(
                    buf, idxs[misses[0]], lambda: host))
            self.sync_upload_seconds += time.perf_counter() - t0
            if len(misses) == len(idxs) and not use_cache \
                    and view is None:
                return stacked      # the uncached batched upload
            off = 0
            for pos, blk in zip(misses, blocks):
                wj = int(blk.shape[1])
                arr = stacked[:, off:off + wj].contiguous()
                off += wj
                if use_cache:
                    self.cache.put(self.cache.key(buf, idxs[pos]), arr)
                    parts[pos] = self._serve(arr, view)
                else:
                    parts[pos] = arr
            self._drain_spills()
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=1)

    # -- dirty working panels ---------------------------------------

    def _record_evicted(self, key: Tuple, arr) -> None:
        """PanelCache.on_evict hook, under the cache lock: record only;
        _drain_spills schedules the spill outside the lock."""
        self._evicted.append((key, arr))

    def _drain_spills(self) -> None:
        """Spill every evicted DIRTY panel to its registered host view
        through the writer; clean victims are just dropped."""
        while self._evicted:
            key, arr = self._evicted.pop()
            with self._lock:
                ent = self._dirty.pop(key, None)
            if ent is not None:
                buf, idx, view = ent
                self.spills += 1
                self.write(buf, idx, arr, view())

    def stash(self, buf: str, idx: int, arr,
              view: Callable[[], np.ndarray]) -> bool:
        """Hold a DIRTY working panel (`view()` is the writable host
        slice its truth belongs in) resident under the budget; on
        eviction it spills through the writer, and a later fetch of the
        key waits that spill before re-staging from the host view. With
        the cache off this writes through. True when it stayed
        resident."""
        key = self.cache.key(buf, idx)
        if self.cache.enabled:
            self.cache.drop(key)
            if self.cache.put(key, arr):
                with self._lock:
                    self._dirty[key] = (buf, idx, view)
                self._drain_spills()
                return True
        self._drain_spills()
        with self._lock:
            self._dirty.pop(key, None)
        self.write(buf, idx, arr, view())
        return False

    def discard(self, buf: str, idx: int) -> None:
        """Drop a stashed or cached panel whose lifetime ended, without
        a spill."""
        key = self.cache.key(buf, idx)
        with self._lock:
            self._dirty.pop(key, None)
        self.cache.drop(key)

    def invalidate(self, buf: str, cause: Optional[str] = None
                   ) -> int:
        """Epoch-bump `buf` (PanelCache.invalidate) after draining any
        in-flight prefetch of it (the worker may be reading host rows
        the caller is about to rewrite). ``cause`` labels the counters
        ``ooc.<cause>_invalidations`` / ``ooc.<cause>_invalidation_bytes``
        (getrf_ooc's row-swap fixup passes "lu")."""
        with self._lock:
            stale = [(k, f) for k, f in self._pending.items()
                     if k[0] == buf]
            for k, _ in stale:
                del self._pending[k]
        for _, f in stale:
            # the upload is discarded; its error (if any) is moot, the
            # panel is re-read from the rewritten host rows
            try:
                f.result()
            except Exception:   # noqa: BLE001 - discarded upload
                pass
        b0 = self.cache.invalidated_bytes
        n = self.cache.invalidate(buf)
        if obs_events.enabled():
            dropped_bytes = self.cache.invalidated_bytes - b0
            if n and cause:
                obs_metrics.inc("ooc.%s_invalidations" % cause, n)
                obs_metrics.inc("ooc.%s_invalidation_bytes" % cause,
                                dropped_bytes)
            obs_events.instant("ooc::invalidate", cat="staging",
                               buf=buf, dropped=n,
                               bytes=dropped_bytes)
        return n

    # -- D2H side ---------------------------------------------------

    def write(self, buf: str, idx: int, dev, out_view: np.ndarray
              ) -> None:
        """Queue `dev`'s writeback into the host slice `out_view` on the
        writer thread: panel k's writeback overlaps panel k+1's visits.
        On the card the writer's stream first waits on an event recorded
        here, after the kernel that produced `dev`."""
        ready = None
        if self._down is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            dev.record_stream(self._down.stream)

        def task():
            t0 = time.perf_counter()
            with obs_events.span("ooc::writeback", cat="staging",
                                 buf=buf, idx=idx):
                if ready is not None:
                    self._down.stream.wait_event(ready)
                # idempotent host write: the retry may rerun it
                _guard_transfer(
                    "d2h", lambda: _d2h(dev, out=out_view,
                                        stager=self._down),
                    buf=buf, idx=idx)
            self.d2h_write_seconds += time.perf_counter() - t0

        self.writes_issued += 1
        fut = self._d2h_pool.submit(task)
        with self._lock:
            self._writes.setdefault((buf, idx), []).append(fut)

    def wait_writes(self) -> None:
        """Drain the writeback queue (before returning, or before host
        fixups that read the factor)."""
        while True:
            with self._lock:
                futs = [f for fs in self._writes.values() for f in fs]
                self._writes.clear()
            if not futs:
                return
            t0 = time.perf_counter()
            for f in futs:
                f.result()
            dt = time.perf_counter() - t0
            self.d2h_wait_seconds += dt
            _ledger.credit("cache", dt)

    # -- lifecycle --------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        s = self.cache.stats()
        up = self.prefetch_upload_seconds
        s.update({
            "prefetch_issued": self.prefetch_issued,
            "prefetch_upload_seconds": round(up, 6),
            "prefetch_wait_seconds":
                round(self.prefetch_wait_seconds, 6),
            "prefetch_overlap_fraction":
                round(max(0.0, 1.0 - self.prefetch_wait_seconds / up),
                      4) if up > 0 else 0.0,
            "sync_upload_seconds": round(self.sync_upload_seconds, 6),
            "spills": self.spills,
            "writes_issued": self.writes_issued,
            "d2h_write_seconds": round(self.d2h_write_seconds, 6),
            "d2h_wait_seconds": round(self.d2h_wait_seconds, 6),
            "d2h_overlap_fraction":
                round(max(0.0, 1.0 - self.d2h_wait_seconds
                          / self.d2h_write_seconds), 4)
                if self.d2h_write_seconds > 0 else 0.0,
        })
        return s

    def finish(self) -> Dict[str, Any]:
        """Drain both pipelines, publish the ooc.cache.* / overlap
        counters, remember the stats (last_stats) and shut the workers
        down. Idempotent."""
        global _last_stats
        if self._finished:
            return dict(_last_stats)
        self._finished = True
        try:
            self._drain_spills()
            # dirty panels still resident at shutdown spill now: the
            # stash contract is that the host view ends up with the
            # truth whether or not eviction ever fired
            with self._lock:
                leftover = list(self._dirty.items())
                self._dirty.clear()
            for key, (buf, idx, view) in leftover:
                arr = self.cache.take(key)
                if arr is not None:
                    self.spills += 1
                    self.write(buf, idx, arr, view())
            self.wait_writes()
        finally:
            with self._lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for f in pending:
                # prefetches nobody fetched (a stream that raised):
                # their results are discarded with the engine
                try:
                    f.result()
                except Exception:   # noqa: BLE001 - discarded upload
                    pass
            if self._h2d_pool is not None:
                self._h2d_pool.shutdown(wait=True)
            self._d2h_pool.shutdown(wait=True)
            # the pinned buffers go back to the caching host allocator
            # now, for the next engine, not when the collector finds
            # this one
            self._up = self._down = None
        s = self.stats()
        if obs_events.enabled():
            obs_metrics.inc("ooc.cache.hits", s["hits"])
            obs_metrics.inc("ooc.cache.misses", s["misses"])
            obs_metrics.inc("ooc.cache.evictions", s["evictions"])
            obs_metrics.inc("ooc.cache.invalidations",
                            s["invalidations"])
            obs_metrics.inc("ooc.cache.served_bytes",
                            s["served_bytes"])
            obs_metrics.inc("ooc.prefetch.issued",
                            s["prefetch_issued"])
            obs_metrics.observe("ooc.prefetch.overlap_fraction",
                                s["prefetch_overlap_fraction"])
            obs_metrics.observe("ooc.d2h.overlap_fraction",
                                s["d2h_overlap_fraction"])
        _last_stats = s
        return s

    def __enter__(self) -> "StreamEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


def last_stats() -> Dict[str, Any]:
    """Stats of the most recently finished engine."""
    return dict(_last_stats)


#: one-shot flag of the unknown-dtype budget warning below (tests reset
#: it to trigger it again)
_warned_unknown_dtype = False


def engine_for(n: int, panel_cols: int, dtype,
               budget_bytes: Optional[Any] = None,
               device=None, extra_pins: int = 0,
               resident_dtype=None) -> StreamEngine:
    """A driver's engine on `device` (the card unless named), with the
    tunable knobs resolved through tune/select (explicit argument >
    measured cache entry > FROZEN: budget 0, policy mru, prefetch depth
    1). `budget_bytes` takes an int, "auto" (the card's free memory
    minus the working-set reserve, auto_budget_bytes) or None (the
    ``ooc/cache_budget_mb`` tunable, which may itself be "auto").
    `extra_pins` raises the pinned-panel count above two.
    `resident_dtype` declares the mixed-precision residency dtype: the
    "auto" reserve is sized at the RESIDENT itemsize. An unknown dtype
    (both None) warns ONCE and assumes 8 bytes an element."""
    from ..tune.select import resolve
    dev = resolve_device(device)
    if resident_dtype is not None:
        itemsize = _itemsize(resident_dtype)
    elif dtype is not None:
        itemsize = _itemsize(dtype)
    else:
        global _warned_unknown_dtype
        if not _warned_unknown_dtype:
            _warned_unknown_dtype = True
            import warnings
            warnings.warn(
                "stream.engine_for: no dtype supplied — sizing the "
                "'auto' cache budget's working-set reserve at 8 "
                "bytes/element (f64); pass dtype/resident_dtype for "
                "exact panel-count predictions", stacklevel=2)
        itemsize = 8
    if budget_bytes is None:
        mb = resolve("ooc", "cache_budget_mb", n=n, dtype=dtype)
        budget_bytes = mb if isinstance(mb, str) \
            else int(float(mb) * (1 << 20))
    if isinstance(budget_bytes, str):
        if budget_bytes != "auto":
            raise ValueError("cache budget must be bytes or 'auto', "
                             "got %r" % (budget_bytes,))
        budget_bytes = auto_budget_bytes(n, panel_cols, itemsize,
                                         device=dev)
    policy = str(resolve("ooc", "cache_policy", n=n, dtype=dtype))
    depth = int(resolve("ooc", "prefetch_depth", n=n, dtype=dtype))
    full = _itemsize(dtype) if dtype is not None else itemsize
    return StreamEngine(budget_bytes=int(budget_bytes), policy=policy,
                        prefetch_depth=depth,
                        pins=2 + max(int(extra_pins), 0),
                        resident_dtype=resident_dtype, device=dev,
                        stage_bytes=int(n) * int(panel_cols) * full)

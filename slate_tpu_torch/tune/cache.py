"""Persistent tuning cache (counterpart of ``slate_tpu/tune/cache.py``).

Measured-best configurations are keyed by
``(op, backend_kind, device_kind, dtype, size_bucket)`` and stored as
versioned JSON under ``~/.cache/slate_tpu_torch/``. The port reads its
own environment variables, so its cache and the JAX package's never
read each other's files: ``SLATE_TPU_TORCH_TUNE_CACHE`` overrides the
directory and ``SLATE_TPU_TORCH_TUNE=0`` disables lookups. A corrupt
or version-mismatched file is treated as empty.

Cold-start contract: with no measured entry, selection falls back to
FROZEN, the read-only table of shipped defaults, copied row for row
from the JAX package so that both route alike on a cold cache.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional

from . import stats

#: bump when the on-disk layout changes; mismatched files are ignored
SCHEMA_VERSION = 1

_FILE_NAME = "tune_cache_v%d.json" % SCHEMA_VERSION

#: read-only shipped defaults: (op, param) -> value, the same rows as
#: slate_tpu/tune/cache.py FROZEN (the comments there give each row's
#: origin)
FROZEN: Dict[tuple, Any] = {
    ("*", "nb"): 256,
    ("*", "ib"): 128,
    ("*", "lookahead"): 1,
    # the reference's spectral D&C routing rows, kept as mirrors with no
    # reader: its route runs on a TPU only, and heev's Auto on the card
    # takes the library eigensolver, never eigh_dc (linalg/eig.py:112)
    # slate-lint: exempt[SL202] card heev never takes eigh_dc (eig.py:112)
    ("heev", "spectral_dc_min_n"): 2048,
    # slate-lint: exempt[SL202] card heev never takes eigh_dc (eig.py:112)
    ("heev", "dc_leaf"): 256,
    ("geqrf", "fused_max_n"): 4096,
    ("ooc", "panel_cols"): 8192,
    ("ooc", "cache_budget_mb"): 0,
    ("ooc", "cache_policy"): "mru",
    ("ooc", "prefetch_depth"): 1,
    ("ooc", "shard_method"): "stream",
    ("ooc", "shard_fanin"): 2,
    ("ooc", "shard_min_panels"): 2,
    ("ooc", "shard_lookahead"): 0,
    ("ooc", "lu_pivot"): "partial",
    ("ooc", "precision"): "f32",
    ("ooc", "scheduler"): "walk",
    ("ooc", "visit_fuse"): "per_panel",
    ("mesh", "ownership"): "static",
    ("mesh", "remap_every"): 4,
    ("mesh", "remap_threshold"): 1.25,
    ("mesh", "throughput_alpha"): 0.4,
    ("tsqr", "tree_fanin"): 2,
    ("tsqr", "panel_aspect"): 4,
    ("stedc", "leaf"): 32,
    ("batch", "max_batch"): 64,
    ("batch", "max_wait_us"): 2000,
    ("batch", "strategy"): "bucket",
    ("batch", "align"): 8,
    ("ragged", "blk"): 32,
    ("serve", "cache_mb"): 0,
    ("serve", "max_pending"): 4096,
    ("serve", "shed_eta_s"): 30,
    ("serve", "max_queue_age_ms"): 500,
    ("obs", "reqtrace"): "off",
    ("serve", "metrics"): "off",
    ("serve", "slo_ms"): 500,
    ("serve", "slo_burn_pct"): 50,
    ("resil", "max_retries"): 2,
    ("resil", "backoff_us"): 500,
    ("resil", "ckpt_every"): 0,
    ("obs", "ledger"): "off",
    ("obs", "watchdog"): "off",
    ("lu_panel", "ib"): 32,                # lu_panel_rec base width
    ("lu_panel", "max_w"): 256,
    ("steqr2", "chain"): "dense",
    ("steqr2", "chain_blk"): 128,
    ("bdsqr", "chain"): "dense",
    ("qr_panel", "max_w"): 128,
    ("chol_panel", "fused_max"): 1024,
    ("trtri", "fused_max"): 512,
}


def frozen_default(op: str, param: str, fallback=None):
    """Shipped default for (op, param): exact op entry, then the "*"
    row, then the caller's fallback."""
    if (op, param) in FROZEN:
        return FROZEN[(op, param)]
    if ("*", param) in FROZEN:
        return FROZEN[("*", param)]
    return fallback


def enabled() -> bool:
    """Master switch: SLATE_TPU_TORCH_TUNE=0/off/false disables every
    cache lookup."""
    return os.environ.get("SLATE_TPU_TORCH_TUNE", "1").lower() \
        not in ("0", "off", "false", "no")


def cache_dir() -> str:
    env = os.environ.get("SLATE_TPU_TORCH_TUNE_CACHE")
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = xdg if xdg else os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "slate_tpu_torch")


def cache_path() -> str:
    return os.path.join(cache_dir(), _FILE_NAME)


def size_bucket(n: Optional[int]) -> int:
    """Power-of-two size class (floor 256); n=None maps to bucket 0."""
    if n is None:
        return 0
    b = 256
    while b < n:
        b *= 2
    return b


def _backend_device() -> tuple:
    """(backend_kind, device_kind): ("cuda", the card's name) when a
    card is present, else ("cpu", "cpu") — distinct cache rows per
    hardware, so a CPU-tuned table never routes a run on the card."""
    import torch
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(torch.cuda.current_device())
        return "cuda", name.replace(" ", "_").replace("|", "_")
    return "cpu", "cpu"


def dtype_name(dtype) -> str:
    """numpy-style name of a torch or numpy dtype ("float32", ...)."""
    import torch
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    import numpy as np
    return np.dtype(dtype).name


def make_key(op: str, dtype, n: Optional[int]) -> str:
    backend, device = _backend_device()
    dt = dtype_name(dtype) if dtype is not None else "any"
    return "|".join([op, backend, device, dt, str(size_bucket(n))])


class TuneCache:
    """The persistent store: entries[key] = {param: value, ...}. Lazy
    single load per process; put() updates memory, save() writes the
    versioned JSON."""

    def __init__(self, path: Optional[str] = None) -> None:
        self._path = path
        self._lock = threading.Lock()
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None

    @property
    def path(self) -> str:
        return self._path or cache_path()

    @staticmethod
    def _parse(path: str) -> Dict[str, Dict[str, Any]]:
        """Read + validate the versioned JSON; empty dict on missing,
        corrupt, or version-mismatched files (advisory cache)."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}
        if isinstance(raw, dict) and raw.get("version") == SCHEMA_VERSION \
                and isinstance(raw.get("entries"), dict):
            return {str(k): dict(v) for k, v in raw["entries"].items()
                    if isinstance(v, dict)}
        return {}

    def _load(self) -> Dict[str, Dict[str, Any]]:
        if self._entries is None:
            # slate-lint: exempt[SL301] every caller holds self._lock
            self._entries = self._parse(self.path)
        return self._entries

    def lookup(self, op: str, dtype, n: Optional[int]
               ) -> Optional[Dict[str, Any]]:
        """The measured entry for (op, backend, device, dtype, bucket),
        or None."""
        with self._lock:
            e = self._load().get(make_key(op, dtype, n))
        stats.record_cache(e is not None)
        return dict(e) if e is not None else None

    def get_param(self, op: str, param: str, dtype, n: Optional[int]):
        e = self.lookup(op, dtype, n)
        return None if e is None else e.get(param)

    def put(self, op: str, dtype, n: Optional[int],
            values: Dict[str, Any],
            meta: Optional[Dict[str, Any]] = None) -> None:
        key = make_key(op, dtype, n)
        with self._lock:
            entries = self._load()
            entry = dict(entries.get(key, {}))
            entry.update(values)
            if meta is not None:
                entry["_meta"] = meta
            entries[key] = entry

    def save(self) -> str:
        """Write the versioned JSON atomically (tmp + rename), keeping
        entries another process saved since our load."""
        with self._lock:
            entries = self._load()
            path = self.path
            merged = self._parse(path)
            merged.update(entries)
            self._entries = entries = merged
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp.%d" % os.getpid()
            with open(tmp, "w") as f:
                json.dump({"version": SCHEMA_VERSION, "entries": entries},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        return path

    def entries(self) -> Dict[str, Dict[str, Any]]:
        """Copy of every loaded entry (the payload dist/tuneshare.py
        sends)."""
        with self._lock:
            return {k: dict(v) for k, v in self._load().items()}

    def merge(self, entries: Dict[str, Dict[str, Any]]) -> int:
        """BEST-ENTRY merge of another rank's table (reference
        TuneCache.merge). Per key: missing here -> adopt the incoming
        entry; present on both sides -> the entry with the LOWER best
        measured probe time (min over ``_meta.results[*].seconds``)
        wins whole; an incoming entry without probe evidence never
        replaces a local one. In memory only (save() persists).
        Returns the number of keys adopted or replaced."""
        def best_s(e) -> float:
            try:
                return min(float(r["seconds"])
                           for r in e["_meta"]["results"]
                           if "seconds" in r)
            except Exception:
                return float("inf")

        changed = 0
        with self._lock:
            mine = self._load()
            for key, inc in (entries or {}).items():
                if not isinstance(inc, dict):
                    continue
                cur = mine.get(key)
                if cur is None or best_s(inc) < best_s(cur):
                    mine[key] = dict(inc)
                    changed += 1
        return changed

    def clear_memo(self) -> None:
        """Drop the in-process memo so the next access re-reads."""
        with self._lock:
            self._entries = None


_cache = TuneCache()


def get_cache() -> TuneCache:
    return _cache


def reset_cache() -> None:
    """Forget the memoized file contents AND the resolved path (tests
    repoint SLATE_TPU_TORCH_TUNE_CACHE between cases)."""
    _cache._path = None
    _cache.clear_memo()

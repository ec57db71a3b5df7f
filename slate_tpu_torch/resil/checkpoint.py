"""Checkpoint / resume for the out-of-core factorization streams
(counterpart of ``slate_tpu/resil/checkpoint.py``).

An out-of-core factorization keeps its whole state in host memory (the
factor the device-to-host writer fills panel by panel); this module
makes that state durable at a panel cadence, so a crashed stream
resumes mid-factorization instead of restarting:

* the factor (and side arrays: geqrf's taus) is a memory-mapped
  ``.npy`` file, which the writer fills in place;
* after every ``every``-th panel the driver drains its writes and
  :meth:`Checkpointer.commit` s: flush the maps, then atomically
  (tmp + rename) advance ``meta.json`` to the next epoch, so a crash
  at any point leaves a consistent checkpoint;
* :func:`maybe_checkpointer` re-opens a directory whose meta matches
  (driver, shapes, dtypes, panel width, the input's
  :func:`fingerprint`) and reports the committed ``epoch``; anything
  else starts fresh at epoch 0.

The cadence rides the tune subsystem: explicit ``every`` > measured
entry > FROZEN ``resil/ckpt_every`` = 0 (off: no checkpointer, no file
touched). Its callers are the out-of-core factorizations of
linalg/ooc.py (potrf_ooc, geqrf_ooc, getrf_tntpiv_ooc).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 1

_META = "meta.json"


def fingerprint(a, cap: int = 1 << 17) -> str:
    """Cheap input identity: CRC32 of <= `cap` strided samples plus
    the INPUT's shape/dtype — enough to catch "resumed with a
    different matrix" without hashing gigabytes. `a` is a numpy array
    or a torch tensor; a tensor of a numpy dtype gives the string of
    the same numpy array, a bf16 one (which numpy lacks) hashes its
    bytes through an int16 view and names its dtype ``bfloat16``."""
    if isinstance(a, torch.Tensor):
        s = a.detach().reshape(-1)[:: max(a.numel() // cap, 1)] \
            .contiguous().cpu()
        if s.dtype == torch.bfloat16:
            raw, name = s.view(torch.int16).numpy().tobytes(), "bfloat16"
        else:
            s = s.numpy()
            raw, name = s.tobytes(), s.dtype.str
        shape = tuple(a.shape)
    else:
        shape, name = a.shape, np.dtype(a.dtype).str
        raw = np.ascontiguousarray(
            a.reshape(-1)[:: max(a.size // cap, 1)]).tobytes()
    return "%08x:%s:%s" % (zlib.crc32(raw) & 0xFFFFFFFF,
                           "x".join(map(str, shape)), name)


class Checkpointer:
    """One OOC driver invocation's durable snapshot set. Drivers use:
    ``ck.array(name)`` for the memmapped output arrays (the D2H writer
    targets slices of these), ``ck.epoch`` for the resume start,
    ``ck.due(k)`` / ``ck.commit(k + 1)`` at the panel cadence."""

    def __init__(self, path: str, driver: str,
                 arrays: Dict[str, Tuple[Tuple[int, ...], Any]],
                 panel_cols: int, nt: int, every: int,
                 fp: str = "",
                 extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.path = str(path)
        self.driver = driver
        self.every = max(int(every), 1)
        self.nt = int(nt)
        self.epoch = 0
        self.commits = 0
        self._specs = {name: (tuple(shape), np.dtype(dt).str)
                       for name, (shape, dt) in arrays.items()}
        self._meta_core = {"version": SCHEMA_VERSION, "driver": driver,
                           "panel_cols": int(panel_cols),
                           "nt": self.nt, "arrays": self._specs,
                           "fingerprint": fp}
        # algorithm-identity keys beyond the array specs (the OOC-LU
        # drivers' `lu_pivot` mode): part of the identity guard, so a
        # checkpoint written under another mode starts fresh at epoch
        # 0 instead of mixing two pivot disciplines' panels
        if extra_meta:
            self._meta_core.update(
                {str(k): v for k, v in extra_meta.items()})
        self.arrays: Dict[str, np.ndarray] = {}
        os.makedirs(self.path, exist_ok=True)
        meta = self._read_meta()
        if meta is not None:
            self.epoch = int(meta.get("epoch", 0))
            for name, (shape, dt) in self._specs.items():
                self.arrays[name] = np.lib.format.open_memmap(
                    self._file(name), mode="r+")
        else:
            self.epoch = 0
            for name, (shape, dt) in self._specs.items():
                # fresh maps read as zeros (new file pages), matching
                # the zeros-initialized factor the drivers start from
                self.arrays[name] = np.lib.format.open_memmap(
                    self._file(name), mode="w+", shape=shape,
                    dtype=np.dtype(dt))
            self._write_meta(0)
        self._publish_open()

    # -- layout -----------------------------------------------------

    def _file(self, name: str) -> str:
        return os.path.join(self.path, "%s.npy" % name)

    def _read_meta(self) -> Optional[Dict[str, Any]]:
        """The on-disk meta IF it matches this invocation's identity
        (driver, array specs, panel width, fingerprint) and every
        array file exists — else None (start fresh)."""
        try:
            with open(os.path.join(self.path, _META)) as f:
                meta = json.load(f)
        except Exception:
            return None
        core = {k: meta.get(k) for k in self._meta_core}
        # JSON round-trips tuples as lists; normalize before compare
        want = json.loads(json.dumps(self._meta_core))
        if core != want:
            return None
        if not all(os.path.exists(self._file(n)) for n in self._specs):
            return None
        return meta

    def _write_meta(self, epoch: int) -> None:
        meta = dict(self._meta_core, epoch=int(epoch))
        tmp = os.path.join(self.path, _META + ".tmp.%d" % os.getpid())
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, _META))

    # -- driver-facing API ------------------------------------------

    def array(self, name: str) -> np.ndarray:
        return self.arrays[name]

    @property
    def factor(self) -> np.ndarray:
        return self.arrays["factor"]

    @property
    def complete(self) -> bool:
        return self.epoch >= self.nt

    def due(self, k: int) -> bool:
        """Commit after panel k? — every `every` panels and at the
        final panel (so a finished run resumes as a no-op)."""
        return (k + 1) % self.every == 0 or k == self.nt - 1

    def commit(self, epoch: int) -> None:
        """Advance the durable epoch: the caller has drained the D2H
        writer for every panel < epoch; msync the maps, then the
        atomic meta swap makes the progress visible to a resume."""
        for arr in self.arrays.values():
            arr.flush()
        self._write_meta(epoch)
        self.epoch = int(epoch)
        self.commits += 1
        from . import guard
        guard._count("resil.ckpt_commits")
        from ..obs import events as obs_events
        if obs_events.enabled():
            from ..obs import metrics as obs_metrics
            obs_metrics.inc("resil.ckpt_commits")
            obs_metrics.set_gauge("resil.ckpt_bytes",
                                  self.bytes_on_disk())
            obs_events.instant("resil::ckpt_commit", cat="resil",
                              driver=self.driver, epoch=self.epoch)

    def bytes_on_disk(self) -> int:
        """Durable footprint in bytes."""
        total = 0
        for name in self._specs:
            try:
                total += os.path.getsize(self._file(name))
            except OSError:
                pass
        try:
            total += os.path.getsize(os.path.join(self.path, _META))
        except OSError:
            pass
        return total

    def _publish_open(self) -> None:
        from ..obs import events as obs_events
        if not obs_events.enabled():
            return
        obs_events.instant("resil::ckpt_open", cat="resil",
                           driver=self.driver, epoch=self.epoch,
                           nt=self.nt, every=self.every)


def resolve_every(every: Optional[int], n: Optional[int] = None,
                  dtype=None) -> int:
    """The commit cadence: explicit argument > measured tune entry >
    FROZEN ``resil/ckpt_every`` (0 = checkpointing off)."""
    if every is not None:
        return int(every)
    from ..tune.select import resolve
    return int(resolve("resil", "ckpt_every", n=n, dtype=dtype))


def maybe_checkpointer(path: Optional[str], driver: str,
                       a: np.ndarray, panel_cols: int, nt: int,
                       every: Optional[int] = None,
                       extra_arrays: Optional[
                           Dict[str, Tuple[Tuple[int, ...], Any]]
                       ] = None,
                       extra_meta: Optional[Dict[str, Any]] = None
                       ) -> Optional[Checkpointer]:
    """The drivers' entry: None (checkpointing off — the bit-identical
    default) when no path is given or the resolved cadence is 0, else
    a Checkpointer whose ``factor`` array matches `a`'s shape/dtype
    plus any `extra_arrays` (geqrf's taus, the LU streams' pivot
    vectors). `extra_meta` joins the identity guard (the LU streams'
    ``lu_pivot`` mode — a mode-mismatched resume starts fresh)."""
    if path is None:
        return None
    every = resolve_every(every, n=a.shape[-1], dtype=a.dtype)
    if every <= 0:
        return None
    arrays = {"factor": (tuple(a.shape), a.dtype)}
    arrays.update(extra_arrays or {})
    return Checkpointer(path, driver, arrays, panel_cols, nt, every,
                        fp=fingerprint(a), extra_meta=extra_meta)

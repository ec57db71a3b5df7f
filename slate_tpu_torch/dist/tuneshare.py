"""Tuning-table share over the grid (counterpart of
``slate_tpu/dist/tuneshare.py``): rank 0's measured autotuning entries
reach every rank, so one rank probes and every rank routes the same,
over the dist/tree.py engine.

The table is JSON-serialized to a uint8 payload. Rank 0 holds the
payload, every other rank zeros, and an elementwise-max
``tree_allreduce`` (the log-depth exchange schedule, counted like every
other traversal) replicates it: max is exact because the other rows are
all zero. Two rounds: the payload LENGTH first (every rank must agree
on the second round's shape), then the payload. On a grid without a
process group the share is a self-copy through the same code.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..parallel.mesh import ProcessGrid


def _row(grid: ProcessGrid, payload: np.ndarray, width: int
         ) -> torch.Tensor:
    """This rank's (1, width) row: the payload on rank 0, zeros
    elsewhere."""
    row = np.zeros((1, width), np.uint8)
    if grid.index == 0:
        row[0, :payload.shape[0]] = payload
    return torch.as_tensor(row, device=grid.device)


def _bcast_max(grid: ProcessGrid, x: torch.Tensor, fanin: int
               ) -> np.ndarray:
    from ..parallel.collectives import tree_allreduce
    return tree_allreduce(grid, x, op=torch.maximum,
                          fanin=fanin).cpu().numpy()


def broadcast_entries(grid: ProcessGrid,
                      entries: Optional[Dict[str, Dict[str, Any]]] = None,
                      fanin: int = 2) -> Dict[str, Dict[str, Any]]:
    """Broadcast rank 0's tuning entries (default: its loaded cache) to
    every rank; returns the received table. Pure transport: the cache
    is not changed (share_tuning_table merges)."""
    if grid.index == 0:
        if entries is None:
            from ..tune.cache import get_cache
            entries = get_cache().entries()
        payload = np.frombuffer(json.dumps(entries, sort_keys=True)
                                .encode("utf-8"), dtype=np.uint8)
    else:
        payload = np.zeros((0,), np.uint8)
    ln = _bcast_max(grid, _row(grid, np.frombuffer(
        np.int64(payload.shape[0]).tobytes(), dtype=np.uint8), 8), fanin)
    length = int(np.frombuffer(ln[0].tobytes(), dtype=np.int64)[0])
    if length <= 0:
        return {}
    out = _bcast_max(grid, _row(grid, payload, length), fanin)
    received = json.loads(out[0].tobytes().decode("utf-8"))
    return received if isinstance(received, dict) else {}


def share_tuning_table(grid: ProcessGrid, fanin: int = 2,
                       save: bool = False) -> int:
    """Broadcast rank 0's table and best-entry merge it into THIS rank's
    cache (tune.cache.TuneCache.merge). Returns the number of entries
    adopted; save=True persists the merged table."""
    from ..tune.cache import get_cache
    received = broadcast_entries(grid, fanin=fanin)
    cache = get_cache()
    changed = cache.merge(received)
    if save and changed:
        cache.save()
    from ..obs import events as obs_events
    if obs_events.enabled():
        from ..obs import metrics as om
        om.inc("tune.share.broadcasts")
        om.inc("tune.share.entries_adopted", changed)
    return changed

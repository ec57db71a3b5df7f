"""The elastic mesh's remap-record mirror (counterpart of
``slate_tpu/dist/elastic.py:113-132``).

Only the mirror is ported: the process-wide remap / shrink totals and
the last remap's record, readable with the obs bus off. The serving
daemon's admission ladder (``serve/admission.py``) attaches it to every
non-admit escalation, so a shed made during mesh churn can be traced to
the churn. On one device nothing remaps, so the mirror reads zeros and
the payload carries the reference's keys and values. The elastic
schedule itself (``ElasticSchedule``, the shrink-to-fit resume) comes
with the sharded stream, ROADMAP queue 1, item 10b.
"""

from __future__ import annotations

import threading
from typing import Any, Dict

_remap_lock = threading.Lock()
_REMAP_STATS: Dict[str, Any] = {"remaps": 0, "panels_moved": 0,
                                "shrinks": 0, "last": None}


def remap_records() -> Dict[str, Any]:
    """Copy of the mirror: ``remaps`` / ``panels_moved`` / ``shrinks``
    totals and ``last``, the most recent remap's ``{op, boundary,
    moved}`` (or None)."""
    with _remap_lock:
        out = dict(_REMAP_STATS)
        if out["last"] is not None:
            out["last"] = dict(out["last"])
        return out


def reset_remap_records() -> None:
    with _remap_lock:
        _REMAP_STATS.update(remaps=0, panels_moved=0, shrinks=0,
                            last=None)

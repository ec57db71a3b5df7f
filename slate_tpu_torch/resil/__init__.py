"""Resilience (counterpart of ``slate_tpu/resil/``): deterministic fault
injection (`faults`), guarded execution with bounded retries and the
fallback-escalation ladder (`guard`), and panel-granular
checkpoint / resume (`checkpoint`).

Everything is off by default: no plan installed, checkpointing frozen
at ``resil/ckpt_every = 0``, sentinels disabled; the off state adds no
host read and gives the drivers' results bitwise.
"""

from . import checkpoint, faults, guard  # noqa: F401

__all__ = ["checkpoint", "faults", "guard"]

"""Utilities (counterpart of ``slate_tpu/utils/``)."""

from .trace import Timers  # noqa: F401

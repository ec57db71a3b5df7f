"""Tuning cache and selection (counterpart of ``slate_tpu/tune/``)."""

from . import cache, select, stats  # noqa: F401

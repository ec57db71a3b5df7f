"""Observability (counterpart of ``slate_tpu/obs/``): the event bus."""

from . import events  # noqa: F401
from .events import disable, enable, enabled  # noqa: F401

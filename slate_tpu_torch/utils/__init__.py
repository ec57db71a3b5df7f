"""Utilities (counterpart of ``slate_tpu/utils/``)."""

from .printing import print_matrix, sprint_matrix  # noqa: F401
from .trace import Timers  # noqa: F401

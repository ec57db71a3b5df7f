"""User-facing API layers (counterpart of ``slate_tpu/api/``): the
simplified names and the scipy.linalg-compatible shim."""

from . import lapack_compat, simplified  # noqa: F401

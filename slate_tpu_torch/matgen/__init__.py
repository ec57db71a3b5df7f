"""Test-matrix generation (counterpart of ``slate_tpu/matgen/``)."""

from .generate import DISTS, KINDS, generate_matrix  # noqa: F401

"""Refinement iterations a call, as gesv_mixed_gmres returns them,
averaged over the window's calls."""

from portbench import readers

read = readers.refine_iters

"""As ``solve_p90_ms``, in the mixed-precision cells (see gflops.mixed)."""

from portbench import readers

read = readers.solve_p90_ms

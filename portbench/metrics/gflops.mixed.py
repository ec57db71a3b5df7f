"""As ``gflops``, in the mixed-precision cells: kept apart because their
host-paced refinement spreads several times wider from run to run, and
one bound would loosen the float32 cells' guard to theirs."""

from portbench import readers

read = readers.gflops

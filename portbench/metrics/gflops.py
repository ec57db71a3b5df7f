"""2/3 n^3 + 2 n^2 nrhs of every call completed in the window over the
whole window, in GFLOP/s (host clock): the float32 LU cells."""

from portbench import readers

read = readers.gflops

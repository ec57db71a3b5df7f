"""Process start to the first timed call, in s: imports, the CUDA context,
the kernels' build or load, the pool made on the device, the warm-up."""

from portbench import readers

read = readers.setup_s

"""Device operations (kernels, copies, memsets, library launches included)
a traced call: the float32 LU cells."""

from portbench import readers

read = readers.device_ops_per_call

"""Device time a traced call of cuBLAS / cuSOLVER kernels (as
readers.is_library tells them from the port's hand kernels and
PyTorch's own), in ms: the float32 LU cells."""

from portbench import readers

read = readers.library_ms

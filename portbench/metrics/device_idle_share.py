"""One minus the device's busy share of the traced calls (union of kernel,
copy and memset intervals over their wall): the float32 LU cells."""

from portbench import readers

read = readers.device_idle_share

"""As ``device_ops_per_call``, in the mixed-precision cells."""

from portbench import readers

read = readers.device_ops_per_call

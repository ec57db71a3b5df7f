"""As ``device_idle_share``, in the mixed-precision cells."""

from portbench import readers

read = readers.device_idle_share

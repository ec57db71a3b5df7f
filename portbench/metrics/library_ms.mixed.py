"""As ``library_ms``, in the mixed-precision cells."""

from portbench import readers

read = readers.library_ms

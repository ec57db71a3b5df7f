"""The 90th percentile of every call's time in the window, in ms (host
clock, start to the synchronize after it): the float32 LU cells."""

from portbench import readers

read = readers.solve_p90_ms

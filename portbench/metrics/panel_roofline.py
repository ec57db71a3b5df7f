"""The float32 LU panels' least time (roofline/lu.py over the
configuration's schedule, at 67 TFLOP/s and 3.35 TB/s) over their
device time (panel_ms), in %."""

from portbench import readers

read = readers.panel_roofline

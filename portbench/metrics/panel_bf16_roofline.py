"""The bfloat16 LU panels' least time (roofline/lu.py over the
configuration's schedule, at 989 TFLOP/s and 3.35 TB/s) over their
device time (panel_bf16_ms), in %."""

from portbench import readers

read = readers.panel_roofline

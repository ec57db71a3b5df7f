"""Device time a traced call of the bfloat16 LU panels of the
mixed-precision factor, read as panel_ms reads the float32 ones. In ms."""

from portbench import readers

read = readers.panel_ms

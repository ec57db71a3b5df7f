"""Device time a traced call of the float32 LU panels: what was launched
inside the harness's portbench::panel range around the port's
linalg.lu._lu_panel, tied by correlation id, so it reads the same work
whatever implements the panel. In ms."""

from portbench import readers

read = readers.panel_ms

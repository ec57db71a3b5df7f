"""Device time a mixed-precision solve call of its bfloat16 LU panels,
from the port's ``lu::panel`` spans, over every call of the traced
window. In ms; it holds the device's waits on the panels' host loop."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("lu::panel",), "gesv_mixed_gmres")

"""Device time a float32 LU solve call of the solve with the factor,
from the port's ``getrs`` span (the pivots and both triangular
solves). In ms."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("getrs",), "gesv")

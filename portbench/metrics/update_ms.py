"""Device time a float32 LU solve call of the trailing updates, from the
port's ``lu::update`` spans (U12's triangular solve, the trailing
product and its subtraction, each block step). In ms."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("lu::update",), "gesv")

"""Device time a float32 LU solve call of the row swaps, from the port's
``lu::swaps`` spans (each step's swap composition and row gathers) and
its ``lu::reorder`` span (the deferred reorder of the panels and the
factor's assembly). In ms."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("lu::swaps", "lu::reorder"), "gesv")

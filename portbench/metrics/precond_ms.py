"""Device time a mixed-precision solve call of FGMRES's preconditioner
solves, from the port's ``refine::precond`` spans (each: the pad and
downcast of the vector, the bfloat16 factor's getrs, the upcast). In
ms."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("refine::precond",), "gesv_mixed_gmres")

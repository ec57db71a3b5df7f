"""FGMRES inner steps a mixed-precision solve call needed, from the
port's ``refine.fgmres.steps`` histogram: the restart length times the
cycles before the last, plus the fewest steps of the last whose
least-squares residual met the convergence test. ``refine_iters``
reads the cycles times the restart length that the call ran."""

from portbench import spans


def read(ctx):
    return spans.per_call_count("refine.fgmres.steps", "gesv_mixed_gmres")

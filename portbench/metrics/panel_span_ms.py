"""Device time a float32 LU solve call of its panels, from the port's
own ``lu::panel`` spans (CUDA events around ``linalg.lu._lu_panel``'s
body, whatever the route), over every call of the traced window. In
ms; it holds the device's waits inside a panel, which ``panel_ms`` (the
kernels launched in the harness's range) does not."""

from portbench import spans


def read(ctx):
    return spans.per_call_ms(("lu::panel",), "gesv")

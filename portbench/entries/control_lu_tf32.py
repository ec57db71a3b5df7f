"""The control of the LU cells, never run by the benchmark itself: the
plain reference solve (``reference/lu.py``) put in the program's place,
its trailing products in TF32, one precision below the float32 that the
configurations state. ``calibrate.py`` and the tests run it, and the
cells' limit has to call its answers wrong."""

from portbench.reference import lu as ref_lu

SPANS = {}


def prepare(config, traffic, inputs, device):
    a, b = inputs["a"], inputs["b"]
    return a, b, config["block_size"]


def call(handle):
    a, b, nb = handle
    return {"x": ref_lu.solve(a, b, nb, product="tf32")}

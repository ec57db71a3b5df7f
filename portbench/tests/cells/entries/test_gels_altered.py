"""Test only: the gels entry with one entry of X moved by X's largest
magnitude where it is produced."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_test_gels_for_altered",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_gels.py"))
_entry = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_entry)
SPANS = _entry.SPANS
prepare = _entry.prepare


def call(handle):
    out = _entry.call(handle)
    x = out["x"].clone()
    x[0, 0] += x.abs().max()
    out["x"] = x
    return out

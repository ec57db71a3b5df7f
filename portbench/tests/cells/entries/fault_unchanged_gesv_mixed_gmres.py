"""Test only: the gesv_mixed_gmres entry with the fault `unchanged` (_faults.py)."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_faults_for_unchanged_gesv_mixed_gmres",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_faults.py"))
_faults = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_faults)
_entry = _faults.real("gesv_mixed_gmres")
SPANS = _entry.SPANS
prepare = _entry.prepare


def call(handle):
    return _faults.unchanged(handle, _entry)

"""Faults planted under the timed path, for the tests that see the
check call them wrong: each wraps the real entry of the cell."""

import importlib.util
import os

ENTRIES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "..", "..", "..", "entries")


def real(name):
    spec = importlib.util.spec_from_file_location(
        "portbench_fault_real_" + name, os.path.join(ENTRIES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unchanged(handle, entry):
    """The solve returns its state unchanged: X is B as it came in."""
    out = entry.call(handle)
    b = handle[1]
    out["x"] = b.data[:b.m, :b.n].clone()
    return out


def half(handle, entry):
    """Half of the right-hand sides left out: their columns of X are
    never solved (left as B's)."""
    out = entry.call(handle)
    b = handle[1]
    k = b.n // 2
    out["x"] = out["x"].clone()
    out["x"][:, k:] = b.data[:b.m, k:b.n]
    return out


def altered(handle, entry):
    """One answer altered where it is produced: one entry of X moved by
    X's largest magnitude."""
    out = entry.call(handle)
    x = out["x"].clone()
    x[x.shape[0] // 2, 0] += x.abs().max()
    out["x"] = x
    return out

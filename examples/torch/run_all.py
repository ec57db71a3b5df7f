#!/usr/bin/env python
"""Run every example twin of this directory as a smoke test (twin of
examples/run_all.py; reference examples/run_tests.py):

    python examples/torch/run_all.py [--device cuda|cpu]

Each twin runs in this process on `--device` (default: the CUDA card;
without one, every twin fails). There is no fall-back to the CPU.
Exits 1 if any example fails."""

import argparse
import pathlib
import runpy
import sys

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

here = pathlib.Path(__file__).parent
failed = []
for ex in sorted(here.glob("ex*.py")):
    print(f"=== {ex.name} ===", flush=True)
    sys.argv = [str(ex), "--device", args.device]
    try:
        runpy.run_path(str(ex), run_name="__main__")
    except Exception as e:   # noqa: BLE001
        print(f"FAILED: {type(e).__name__}: {e}")
        failed.append(ex.name)
print("\n" + ("All examples passed" if not failed
              else f"FAILED: {failed}"))
sys.exit(1 if failed else 0)

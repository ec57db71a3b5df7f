"""Readings that a cell's limit is set from; never run by the benchmark.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control-seeds 3 --seconds 3

In one process (the set-up is paid once): the program over ``--seeds``
fresh seeds and the control (``entries/control_lu_tf32.py``, the
reference one precision lower) over ``--control-seeds``, each a short
window at the cell's own load, judged as a run judges. One JSON line a
run, then a summary line: the program's largest reading (the lower
one) and the control's smallest (the upper one).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--control", default="control_lu_tf32")
    args = ap.parse_args(argv)
    from portbench import run
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for var, rel in run.CACHE_DIRS.items():
        os.environ[var] = os.path.join(repo, rel)
    import torch
    from portbench import harness
    from portbench.registry import Registry
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    reg = Registry()
    device = torch.device("cuda", 0)
    readings = {"program": [], "control": []}
    plan = [("program", None, args.first_seed + 7919 * i)
            for i in range(args.seeds)]
    plan += [("control", args.control, args.first_seed + 104729 * (i + 1))
             for i in range(args.control_seeds)]
    for side, entry, seed in plan:
        cell = reg.cell(args.workload)
        t = time.perf_counter()
        r = harness.measure(reg, cell, seed, args.seconds, False, device, t,
                            entry=entry)
        v = r["checks"]["berr_max"]["value"]
        readings[side].append(v)
        print(json.dumps({"side": side, "seed": seed, "berr_max": v,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "calls_failed": r["checks"]["calls_failed"]["value"],
                          "run_s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "lower": max(readings["program"], default=None),
                      "upper": min(readings["control"], default=None),
                      "program": readings["program"],
                      "control": readings["control"],
                      "card": torch.cuda.get_device_name(device),
                      "process_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

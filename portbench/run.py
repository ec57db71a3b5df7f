"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared beside its
limit, which also close standard error. Without the cards the cell asks
for, or with ``jax``, ``jaxlib``, ``flax`` or ``slate_tpu`` loaded once
the window has closed, it exits non-zero and prints no result.
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
#: build and kernel caches inside the checkout, at fixed paths, so only
#: a checkout's first run builds (the port's own nvcc libraries go to
#: <checkout>/build by the port's code)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/portbench/triton"}
FORBIDDEN = ("jax", "jaxlib", "flax", "slate_tpu")


def forbidden_modules(names=None):
    """The loaded modules' (or `names`') top-level names (before the
    first dot) that are one of FORBIDDEN, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules if names is None
                                           else names)}
    return sorted(tops & set(FORBIDDEN))


def _finite(v):
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    return v


def main(argv=None, reg=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    repo = os.path.dirname(HERE)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = os.path.join(repo, rel)
    os.environ["USE_FLAX"] = "0"

    from portbench import harness
    from portbench.registry import Registry
    reg = reg or Registry()
    cell = reg.cell(args.workload)
    launcher = reg.module("launch", cell.config.get("launch", "single"))
    try:
        result = launcher.run(
            lambda device: harness.measure(
                reg, cell, args.seed, args.seconds, bool(args.trace),
                device, T_PROCESS0, chips=cell.chips), cell.chips)
    except launcher.NoCard as e:
        print("portbench: %s; no result" % e, file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded %s; no result" % ", ".join(bad),
              file=sys.stderr)
        return 3
    result = _finite(result)
    for name, c in result["checks"].items():
        print("check %s %s limit %s" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

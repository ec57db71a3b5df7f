"""Sweep orchestrator (counterpart of ``slate_tpu/testing/run_tests.py``;
reference test/run_tests.py:41-60): named routine groups, size classes,
grid sweeps and junit XML output, with the same junit names.

Usage:
    python -m slate_tpu_torch.testing.run_tests --quick [--device cuda]
    python -m slate_tpu_torch.testing.run_tests chol lu --medium \\
        --grid 1x1,2x2 --xml results.xml
"""

from __future__ import annotations

import argparse
import sys
import time
import xml.etree.ElementTree as ET

#: named routine groups (reference run_tests.py routine lists)
GROUPS = {
    "blas3": ["gemm", "gbmm"],
    "chol": ["potrf", "posv", "pbsv"],
    "lu": ["getrf", "gesv", "gbsv"],
    "qr": ["geqrf", "gels"],
    "eig": ["heev"],
    "svd": ["svd"],
    "indefinite": ["hesv"],
}
ALL = [r for g in GROUPS.values() for r in g]

#: size classes (reference --quick/--small/--medium/--large)
SIZES = {
    "quick": ("64:128:*2", "32"),
    "small": ("128:256:*2", "32,64"),
    "medium": ("256:1024:*2", "64,128"),
    "large": ("1024:4096:*2", "256,512"),
}


def write_junit(rows, path: str, elapsed: float) -> None:
    suite = ET.Element(
        "testsuite", name="slate_tpu.tester",
        tests=str(len(rows)),
        failures=str(sum(r["status"] == "FAILED" for r in rows)),
        time=f"{elapsed:.3f}")
    for r in rows:
        case = ET.SubElement(
            suite, "testcase",
            classname=f"tester.{r['routine']}",
            name=f"{r['routine']}_{r['dtype']}_n{r['n']}_nb{r['nb']}"
                 f"_g{r['grid']}",
            time=f"{r['time']:.3f}")
        if r["status"] == "FAILED":
            f = ET.SubElement(
                case, "failure",
                message=r.get("detail") or f"error={r['error']}")
            f.text = str(r)
    ET.ElementTree(suite).write(path, encoding="unicode",
                                xml_declaration=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("groups", nargs="*", default=[],
                   help=f"routine groups or names ({','.join(GROUPS)})")
    for s in SIZES:
        p.add_argument(f"--{s}", action="store_true")
    p.add_argument("--dim", default=None, help="explicit dim override")
    p.add_argument("--nb", default=None)
    p.add_argument("--type", default="s", dest="types")
    p.add_argument("--grid", default="1x1")
    p.add_argument("--ref", default="n")
    p.add_argument("--xml", default=None, help="junit XML output path")
    p.add_argument("--device", default="cuda",
                   help="where the drivers run (default: the card)")
    args = p.parse_args(argv)

    size = next((s for s in SIZES if getattr(args, s)), "quick")
    dim, nb = SIZES[size]
    dim = args.dim or dim
    nb = args.nb or nb

    routines = []
    for g in (args.groups or list(GROUPS)):
        if g in GROUPS:
            routines.extend(GROUPS[g])
        elif g in ALL:
            routines.append(g)
        else:
            p.error(f"unknown routine/group {g!r} "
                    f"(groups: {', '.join(GROUPS)}; "
                    f"routines: {', '.join(ALL)})")

    from ..utils.backend import resolve_device
    from .tester import sweep
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rows = sweep(routines, dim, args.types, nb, args.grid,
                 check=True, ref=args.ref == "y", device=dev)
    elapsed = time.perf_counter() - t0
    nfail = sum(r["status"] == "FAILED" for r in rows)
    if args.xml:
        write_junit(rows, args.xml, elapsed)
        print(f"junit written to {args.xml}")
    print(f"\n{len(rows)} configs, "
          f"{'all passed' if nfail == 0 else f'{nfail} FAILED'} "
          f"({elapsed:.1f}s)")
    return 1 if nfail else 0


if __name__ == "__main__":
    sys.exit(main())

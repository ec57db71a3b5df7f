"""CLI entry: ``python -m tools.slate_lint_torch`` (package doc)."""

from __future__ import annotations

import argparse
import os
import sys

from . import REGISTRY, core, generate_reference
from .obs_literals import DOC_PATH


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tools.slate_lint_torch",
        description="Contract-checking static analysis (AST-only, "
                    "no torch import). Exit 0 == no live findings.")
    p.add_argument("--only", metavar="CODE|NAME",
                   help="run one analyzer (by name, code, or code "
                        "prefix, e.g. SL2 / tune-keys)")
    p.add_argument("--baseline", metavar="PATH",
                   help="JSON baseline of tolerated findings")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write the current live findings as a "
                        "baseline and exit 0")
    p.add_argument("--repo", metavar="PATH", default=None,
                   help="tree to analyze (default: this checkout)")
    p.add_argument("--list", action="store_true",
                   help="list registered analyzers and exit")
    p.add_argument("--timings", action="store_true",
                   help="report per-analyzer wall time")
    p.add_argument("--obs-doc", metavar="PATH", nargs="?",
                   const="__default__", default=None,
                   help="write the generated obs series reference "
                        "(default %s; '-' for stdout) and exit"
                        % DOC_PATH)
    args = p.parse_args(argv)

    if args.list:
        for an in REGISTRY.values():
            print("%-16s %-22s %s" % (an.name, "/".join(an.codes),
                                      an.doc))
        return 0

    repo = os.path.abspath(args.repo or core.REPO)

    if args.obs_doc is not None:
        text = generate_reference(repo)
        if args.obs_doc == "-":
            sys.stdout.write(text)
            return 0
        out = os.path.join(repo, DOC_PATH) \
            if args.obs_doc == "__default__" else args.obs_doc
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
        print("slate_lint_torch: wrote %s" % out)
        return 0

    try:
        res = core.run(repo=repo, only=args.only,
                       baseline=args.baseline)
    except ValueError as e:
        print("slate_lint_torch: %s" % e, file=sys.stderr)
        return 2

    for f, why in res.exempted:
        print("slate_lint_torch: exempt %s (%s)" % (f.render(), why))
    for f in res.baselined:
        print("slate_lint_torch: baselined %s" % f.render())
    for f in res.findings:
        print("slate_lint_torch: %s" % f.render())
    if args.timings:
        for name, dt in sorted(res.timings.items(),
                               key=lambda kv: -kv[1]):
            print("slate_lint_torch: timing %-16s %6.1f ms"
                  % (name, dt * 1e3))

    if args.write_baseline:
        core.write_baseline(args.write_baseline, res.findings)
        print("slate_lint_torch: wrote baseline %s (%d entries)"
              % (args.write_baseline, len(res.findings)))
        return 0

    n_an = len(core.select(args.only))
    if res.findings:
        print("slate_lint_torch: %d violation(s) (%d analyzers, %d "
              "exempted, %d baselined)"
              % (len(res.findings), n_an, len(res.exempted),
                 len(res.baselined)))
        return 1
    print("slate_lint_torch: ok (%d analyzers, %d exempted, %d baselined)"
          % (n_an, len(res.exempted), len(res.baselined)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

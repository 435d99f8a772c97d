"""CLI for the invariant linter: ``python -m repro_torch.analysis``.

Exit status 0 iff every finding is suppressed (``# lint: allow[...]``)
or baselined; 1 otherwise.  ``--write-baseline`` grandfathers the
current unsuppressed findings so the rule can land before the cleanup.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import core
# importing the rules registers the checkers
from repro_torch.analysis import rules as _rules  # noqa: F401


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="CPR invariant linter (see docs/analysis.md)")
    ap.add_argument("--rule", action="append", metavar="NAME",
                    help="run only this rule (repeatable; default: all)")
    ap.add_argument("--root", default=None,
                    help="tree to scan (default: the repro_torch package)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="JSON findings baseline to subtract")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current unsuppressed findings as a "
                         "baseline and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="shorthand for --format json")
    ap.add_argument("--format", choices=("text", "json", "sarif"),
                    default=None,
                    help="report format (default text; sarif is the "
                         "GitHub code-scanning dialect)")
    ap.add_argument("--output", default=None, metavar="PATH",
                    help="write the report to PATH instead of stdout")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    fmt = args.format or ("json" if args.as_json else "text")

    if args.list_rules:
        for name in sorted(core.CHECKERS):
            print(f"{name}: {core.CHECKERS[name].description}")
        return 0

    try:
        report = core.run_analysis(root=args.root, rules=args.rule,
                                   baseline=args.baseline)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        core.write_baseline(report, args.write_baseline)
        print(f"wrote {len(report.baseline_records())} baseline record(s) "
              f"to {args.write_baseline}")
        return 0

    out = (open(args.output, "w", encoding="utf-8") if args.output
           else sys.stdout)
    try:
        if fmt == "json":
            json.dump(report.to_json(), out, indent=2)
            out.write("\n")
        elif fmt == "sarif":
            json.dump(report.to_sarif(), out, indent=2)
            out.write("\n")
        else:
            for f in report.findings:
                print(f.render(), file=out)
            bad = len(report.unsuppressed)
            print(f"{report.files_scanned} file(s), "
                  f"{len(report.findings)} finding(s), "
                  f"{bad} unsuppressed", file=out)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""CLI: ``python -m repro_torch.lint PATHS [--strict] [--select L001,..]``.

Report mode (default) prints findings and exits 0.  ``--strict`` exits 1
on any unsuppressed finding — the gate for ``src/repro_torch``.  The
reference's output and exit codes.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.lint.core import RULES, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="the port's static analyzer (L001..L005)")
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unsuppressed finding")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule IDs to run (default: all)")
    args = ap.parse_args(argv)

    select = None
    if args.select:
        select = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = select - set(RULES)
        if unknown:
            ap.error(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                     f"known: {', '.join(sorted(RULES))}")

    findings = run(args.paths, select=select)
    for f in findings:
        print(f.render())
    n = len(findings)
    mode = "strict" if args.strict else "report-only"
    print(f"repro_torch.lint: {n} finding{'s' if n != 1 else ''} ({mode})")
    return 1 if (args.strict and findings) else 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: summarize a trace file (Chrome trace-event JSON or JSONL).

    PYTHONPATH=src python -m repro_torch.obs TRACE_FILE [--json]

Prints per-stage count/p50/p99/total and the critical-path breakdown
per scenario; ``--json`` emits the raw summary dict instead.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.export import format_summary, read_trace, summarize


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="trace file (Chrome JSON or JSONL)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    args = ap.parse_args(argv)

    spans = read_trace(args.trace)
    summary = summarize(spans)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(format_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

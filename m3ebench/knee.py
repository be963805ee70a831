"""Find the highest request rate a stream cell's service sustains.

    python -m m3ebench.knee --workload stream.s4_mix --seed <n> \
        --seconds 8 --rates 60,90,120,150

One process, one set-up; each rate runs a window of ``--seconds`` of
the cell's traffic at that rate and prints one JSON line: offered and
delivered rate, latency p50 / p95 and the median latency of the first
and last fifth of the requests.  A rate is sustained while the service
delivers every request within 5% of the window after it and the last
fifth waits no more than 1.5 times the first (no growing backlog).  Run
each rate in a process of its own (one rate a call) to see it as a
benchmark run does, from a fresh set-up.  The cell's fixed rate is set at
four fifths of the highest sustained rate, once, from such a sweep on
the card; the benchmark's own runs never search for a rate.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from m3ebench import loadgen  # noqa: E402
from m3ebench.spec import Bench  # noqa: E402


def sweep(bench: Bench, name: str, seed: int, seconds: float, rates,
          device: str = "cuda"):
    cell = bench.cell(name)
    traffic = bench.traffic(cell["traffic"])
    if "rate_hz" not in traffic:
        raise ValueError(f"{name} is not an open-loop cell with a rate")
    entry = loadgen.make_entry(bench, bench.config(cell["config"]), traffic,
                               seed, device)
    entry.setup()
    out = []
    try:
        for rate in rates:
            entry.rate = float(rate)
            w = entry.window(seconds)
            lat = np.sort(w.latencies_s)
            fifth = max(1, len(lat) // 5)
            first = float(np.median(w.latencies_s[:fifth]))
            last = float(np.median(w.latencies_s[-fifth:]))
            row = {"rate_hz": float(rate), "requests": int(w.attempted),
                   "delivered_hz": len(w.answers) / seconds,
                   "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                   "p95_ms": float(np.percentile(lat, 95,
                                                 method="higher")) * 1e3,
                   "first_fifth_p50_ms": first * 1e3,
                   "last_fifth_p50_ms": last * 1e3,
                   "window_s": w.seconds,
                   "sustained": bool(len(w.answers) == w.attempted
                                     and w.seconds <= 1.05 * seconds
                                     and last <= 1.5 * first)}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        entry.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m m3ebench.knee")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    a = p.parse_args(argv)
    rows = sweep(Bench.load(ROOT), a.workload, a.seed, a.seconds,
                 [float(r) for r in a.rates.split(",")])
    ok = [r["rate_hz"] for r in rows if r["sustained"]]
    print(json.dumps({"highest_sustained_hz": max(ok) if ok else None,
                      "four_fifths_hz": 0.8 * max(ok) if ok else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's correctness limits are set from.

    python -m m3ebench.control --workload search.s4_mix \
        --seeds 11,12,13 --seconds 3

For each seed, in one process (one set-up a cell): the cell's window at
its own sizes and load, then, over every schedule the window returned,

``fitness_gap`` / ``makespan_over_bound_p90``  the program's, as a run reads
    them (the lower readings);
``control.fitness_gap``  the control: the reference put in the program's
    place in the nearest precision below the configuration's float32,
    bfloat16 (every input and operation rounded), judged against the
    float64 reference;
``stalled.makespan_over_bound_p90``  a search whose step returns its state
    unchanged: it returns the best of its first population, whose
    fitness is the first entry of the history, so its makespan is the
    group's FLOPs over that fitness;
``altered.fitness_gap``  every returned mapping with one job moved to the
    next sub-accelerator where it was produced;
``duplicate_answers`` / ``copied.duplicate_answers``  the program's, and
    with every second answer returning the mapping of the answer before
    it (in the sweep the same group at the same bandwidth: half of a
    batch left out, its rows filled from the rest).

One JSON line a seed.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from m3ebench import judge, loadgen  # noqa: E402
from m3ebench.reference import costmodel, schedule  # noqa: E402
from m3ebench.spec import Bench  # noqa: E402


def readings_of(config: dict, window: loadgen.Window) -> Dict[str, float]:
    """Every reading the limits of one run's numbers are set from."""
    answers = window.answers
    ref = judge.Reference(config)
    numbers, ratio = judge.judge(config, answers, window.attempted, 0)
    ref_fit, _ = ref.evaluate(answers)
    ctl_fit, _ = ref.evaluate(answers, rnd=schedule.to_bfloat16)
    A = len(costmodel.sub_accels(config["sub_accels"]))
    altered = [dataclasses.replace(
        a, best_accel=np.concatenate([[(a.best_accel[0] + 1) % A],
                                      a.best_accel[1:]]).astype(
                                          a.best_accel.dtype))
               for a in answers]
    alt_fit, _ = ref.evaluate(altered)
    got = np.array([a.best_fitness for a in answers])
    copied = [dataclasses.replace(a, best_accel=b.best_accel,
                                  best_prio=b.best_prio)
              for i, b in enumerate(answers[0::2])
              for a in answers[2 * i:2 * i + 2]]
    stalled = []
    for a in answers:
        t = ref.tables(a.group_seed, a.batch_scale)
        lb = schedule.lower_bound(t.lat, t.bw, a.bw_sys)
        stalled.append(t.flops / float(a.history_best[0]) / lb)
    return {"schedules": len(answers),
            "fitness_gap": numbers["fitness_gap"],
            "makespan_over_bound_p90": numbers["makespan_over_bound_p90"],
            "makespan_over_bound_max": float(np.max(1.0 / ratio)),
            "control.fitness_gap": float(np.max(np.abs(ctl_fit - ref_fit)
                                                / ref_fit)),
            "stalled.makespan_over_bound_p90": float(np.percentile(
                stalled, 90, method="higher")),
            "altered.fitness_gap": float(np.max(np.abs(got - alt_fit)
                                                / alt_fit)),
            "duplicate_answers": numbers["duplicate_answers"],
            "copied.duplicate_answers": float(judge.duplicates(copied)),
            "quality_vs_bound": float(np.exp(np.mean(np.log(ratio))))}


def readings(bench: Bench, name: str, seeds: List[int], seconds: float,
             device: str = "cuda") -> List[dict]:
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    out = []
    for seed in seeds:
        entry = loadgen.make_entry(bench, config, traffic, seed,
                                   device)
        entry.setup()
        window = entry.window(seconds)
        entry.close()
        row = {"seed": seed, **readings_of(config, window)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m m3ebench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    rows = readings(Bench.load(ROOT), a.workload,
                    [int(s) for s in a.seeds.split(",")], a.seconds)
    keys = [k for k in rows[0] if k not in ("seed", "schedules")]
    print(json.dumps({"workload": a.workload, "seeds": len(rows),
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

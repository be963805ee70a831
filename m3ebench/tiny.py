"""A copy of the benchmark at small sizes, for its CPU tests: the
configurations with smaller groups and budgets, and limits that suit
them, written under a directory the caller gives."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from m3ebench.spec import HERE, Bench

ROOT = HERE.parent


# the stream's rate and warm stretch at what the CPU serves at these sizes
CPU_STREAM = {"rate_hz": 40.0, "warm_seconds": 0.5}


def tiny_bench(tmp: Path, group_size: int = 30, budget: int = 1000,
               limits: dict | None = None) -> Bench:
    """The benchmark copied to ``tmp`` (``BENCHMARK.json`` and the
    package), its configurations cut to ``group_size`` jobs and
    ``budget`` samples, its stream traffic slowed to what the CPU serves,
    every cell's limits replaced by ``limits``."""
    tmp = Path(tmp)
    here = tmp / "m3ebench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(group_size=group_size, budget=budget)
        path.write_text(json.dumps(cfg))
    for path in (here / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        if traffic["entry"] == "stream":
            traffic.update(CPU_STREAM)
            path.write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(doc))
    if limits is not None:
        for w in doc["workloads"]:
            (here / "limits" / f"{w['name']}.json").write_text(
                json.dumps(limits))
    return Bench(tmp, doc, here)

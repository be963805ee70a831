"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose file the
configuration's entry gives, and a traffic mix, ``traffic/<name>.json``,
which names the program's entry point it drives,
``entries/<entry>.py``'s ``Entry`` (its loop and its ``judge``).  Its
correctness limits are ``limits/<cell>.json``; each metric is read by
``metrics/<metric>.py``'s ``read(ctx)``.  Adding a cell, a
configuration, a traffic mix, an entry or a metric is adding files and
entries.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


class Bench:
    def __init__(self, root: Path, doc: dict, here: Path = HERE):
        self.root, self.doc, self.here = Path(root), doc, Path(here)

    @classmethod
    def load(cls, root: Path) -> "Bench":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(root, json.load(f))

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       + ", ".join(w["name"] for w in self.doc["workloads"]))

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return {k: float(v) for k, v in
                _json(self.here / "limits" / f"{cell}.json").items()}

    def metrics(self, cell: str, traced: bool) -> List[dict]:
        """The end-to-end metrics the cell reports (``traced`` False) or
        its per-layer ones: those that list the cell under ``workloads``,
        and those with no such list whose end-to-end metric the cell
        reports."""
        e2e = [m for m in self.doc["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", ()) or ("workloads" not in m
                                              and m["moves"] in moved)]

    def reader(self, metric: str) -> Callable:
        return _module(self.here / "metrics", metric, "metric").read

    def entry(self, name: str) -> type:
        """The ``Entry`` class of ``entries/<name>.py``."""
        return _module(self.here / "entries", str(name), "entry").Entry


def _module(folder: Path, name: str, what: str):
    path = folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"m3ebench_{what}_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    with open(path) as f:
        return json.load(f)

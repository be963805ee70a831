"""Run one benchmark cell once and print its result line.

    python -m m3ebench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: set-up (imports, the card, the kernels'
build or load, every shape the cell's traffic uses warmed), the measured
window of ``--seconds``, then, with ``--trace 1``, a short profiled
stretch, then the reference's check of every schedule the window
returned.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).  No card, or fewer than the cell asks for: exit 2, no result.
JAX or the JAX package loaded in this process: exit 3, no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from m3ebench import judge, loadgen, trace  # noqa: E402
from m3ebench.spec import Bench  # noqa: E402

# top-level module names that must not be loaded in a run: JAX and the
# JAX package the program was ported from (compared whole, so the port,
# ``repro_torch``, is not one of them)
BANNED = ("jax", "jaxlib", "flax", "repro")
PROFILED_CALLS = 2
NAME_CHARS = 96          # a device op's name in the breakdown, cut


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m m3ebench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be above 0")
    return args


def banned_modules(modules=None) -> List[str]:
    """Loaded top-level module names that are banned, by whole name."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names.intersection(BANNED))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program builds its CUDA kernels into ``build/kernels`` there)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device: str, t_start: float = T_START) -> dict:
    """Set up, measure and judge one cell on ``device``; the result
    line's fields."""
    import torch
    from repro_torch.kernels import _build

    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    cuda = torch.device(device).type == "cuda"
    compiles: List[str] = []
    _build.add_compile_listener(lambda what, s: compiles.append(what))

    t_import = time.perf_counter() - t_start
    entry = loadgen.make_entry(bench, cfg, traffic, seed, device)
    t_built = time.perf_counter() - t_start
    entry.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"m3ebench: set-up {setup_s:.3f} s (imports {t_import:.3f} s, "
          f"entry built {t_built:.3f} s, {len(compiles)} compile events)",
          file=sys.stderr)
    before = len(compiles)
    window = entry.window(seconds)
    in_window = len(compiles) - before
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prof = entry.profile(PROFILED_CALLS) if traced and cuda else None
    judge_answers = entry.judge
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    numbers, ratio = judge_answers(cfg, window.answers, window.attempted,
                                   in_window)
    ctx = SimpleNamespace(config=cfg, traffic=traffic, window=window,
                          ratio=ratio, profile=prof, setup_s=setup_s,
                          busy_s=None, window_s=window.seconds)
    if prof is not None:
        ctx.busy_s = window_busy_s(prof, window)
    metrics = {}
    for m in bench.metrics(name, traced):
        value = bench.reader(m["name"])(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": judge.verdict(numbers, limits),
           "attempted": int(window.attempted),
           "failed": int(numbers.get("missing", 0)
                         + numbers.get("malformed", 0)),
           "metrics": metrics, "device": dev}
    if prof is not None:
        # the traced window itself: the profiled stretch's kernel
        # intervals over its wall (which the profiler stretches)
        dev["busy_s"] = prof["traced_busy_s"]
        dev["window_s"] = prof["traced_window_s"]
        out["breakdown"] = {
            "device_ops": [[k[:NAME_CHARS], v]
                           for k, v in trace.top_ops(prof["device"])],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in prof["idle_gaps"]]}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in numbers.items()}
    return out


def window_busy_s(prof: dict, window: loadgen.Window) -> float:
    """The card's busy seconds in the unprofiled window: each call's (or
    batch size's) busy time from the profiled stretch's kernel
    intervals, over the calls (batches) the window made."""
    if "busy_by_rows_s" in prof:
        return float(sum(prof["busy_by_rows_s"][b] for b in window.batches))
    return float(prof["busy_per_call_s"] * window.calls)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    bench = Bench.load(ROOT)
    cell = bench.cell(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"m3ebench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"m3ebench: the program (repro_torch under {src}) is not "
              f"here: {e}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        print("m3ebench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Trace export + summaries — Chrome trace-event JSON, JSONL, CLI math.

A copy of ``repro.obs.export`` (standard library only): the same spans
give byte-equal files in both packages.

Two on-disk formats:

* **Chrome trace-event JSON** (``write_chrome_trace``): loadable by
  Perfetto / ``chrome://tracing``.  Every span becomes a complete
  ("X") event with microsecond ``ts``/``dur``; workers map to ``pid``
  rows (named via ``process_name`` metadata events) and scenario
  scopes map to ``tid`` rows (``thread_name: "scenario <uid>"``), so
  one horizontal track per request falls out of the viewer for free.
  The span's scope rides in ``args`` too, which keeps the format
  round-trippable through :func:`read_trace`.
* **JSONL** (``write_jsonl``): one span per line with the raw
  :class:`~repro_torch.obs.trace.Span` fields — the grep-friendly format.

:func:`summarize` computes what ``python -m repro_torch.obs <file>`` prints:
per-stage count/p50/p99/total and a per-scenario critical-path
breakdown over the lifecycle stages (``analyze``, ``admit``,
``queue_wait``, ``dispatch``, ``device``, ``route``) — i.e. for the
average scenario, which stage its latency actually went to.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.stats import p50_s, p99_s
from repro_torch.obs.trace import Span

# lifecycle stage names in pipeline order; analyze precedes admit
# because admission consumes *ready* (already analyzed) scenarios
LIFECYCLE_STAGES = ("analyze", "admit", "queue_wait", "dispatch",
                    "device", "route")

_NO_SCOPE_TID = 0                    # tid 0 = batch/infra spans


def _pid_map(spans: Sequence[Span]) -> Dict[str, int]:
    return {w: i for i, w in enumerate(sorted({s.worker for s in spans}))}


def to_chrome_trace(spans: Sequence[Span],
                    meta: Optional[Dict] = None) -> Dict:
    """Build the trace-event dict (caller serializes)."""
    pids = _pid_map(spans)
    events: List[Dict] = []
    for worker, pid in sorted(pids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"worker:{worker}"}})
    seen_tids = set()
    for s in spans:
        pid = pids[s.worker]
        tid = _NO_SCOPE_TID if s.scope is None else int(s.scope) + 1
        if (pid, tid) not in seen_tids:
            seen_tids.add((pid, tid))
            label = ("infra" if s.scope is None
                     else f"scenario {int(s.scope)}")
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": label}})
        args = dict(s.args or {})
        args["scope"] = s.scope
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": round(s.start_s * 1e6, 3),
            "dur": round(max(s.end_s - s.start_s, 0.0) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": dict(meta or {})}


def write_chrome_trace(path: str, spans: Sequence[Span],
                       meta: Optional[Dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, meta=meta), f, indent=1)
    return path


def write_jsonl(path: str, spans: Sequence[Span]) -> str:
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps({
                "name": s.name, "start_s": s.start_s, "end_s": s.end_s,
                "scope": s.scope, "worker": s.worker,
                "args": s.args}) + "\n")
    return path


def _spans_from_chrome(doc: Dict) -> List[Span]:
    pid_names = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = str(ev.get("args", {}).get("name", ""))
            if name.startswith("worker:"):
                name = name[len("worker:"):]
            pid_names[ev.get("pid", 0)] = name
    out = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        scope = args.pop("scope", None)
        start = float(ev["ts"]) / 1e6
        out.append(Span(
            name=ev["name"], start_s=start,
            end_s=start + float(ev.get("dur", 0.0)) / 1e6,
            scope=scope,
            worker=pid_names.get(ev.get("pid", 0), "main"),
            args=args or None))
    return out


def read_trace(path: str) -> List[Span]:
    """Load spans from either export format (sniffed by content: a
    Chrome trace is one JSON object, JSONL is one object per line)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{") and "traceEvents" in text[:4096]:
        return _spans_from_chrome(json.loads(text))
    spans = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        spans.append(Span(name=d["name"], start_s=d["start_s"],
                          end_s=d["end_s"], scope=d.get("scope"),
                          worker=d.get("worker", "main"),
                          args=d.get("args")))
    return spans


def summarize(spans: Iterable[Span]) -> Dict:
    """Per-stage latency stats plus a critical-path breakdown averaged
    over scenarios (spans with a scope)."""
    spans = list(spans)
    by_name: Dict[str, List[float]] = {}
    per_scenario: Dict[object, Dict[str, float]] = {}
    bounds: Dict[object, List[float]] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s.dur_s)
        if s.scope is None:
            continue
        per_scenario.setdefault(s.scope, {})
        stage = per_scenario[s.scope]
        stage[s.name] = stage.get(s.name, 0.0) + s.dur_s
        lo_hi = bounds.setdefault(s.scope, [s.start_s, s.end_s])
        lo_hi[0] = min(lo_hi[0], s.start_s)
        lo_hi[1] = max(lo_hi[1], s.end_s)

    stages = {
        name: {
            "count": len(durs),
            "p50_ms": p50_s(durs) * 1e3,
            "p99_ms": p99_s(durs) * 1e3,
            "total_s": float(sum(durs)),
        }
        for name, durs in sorted(by_name.items())
    }

    # critical path: for each scenario, its end-to-end window and how
    # the lifecycle stages split the time actually attributed to stages
    crit: Dict[str, Dict[str, float]] = {}
    stage_sums = {st: [] for st in LIFECYCLE_STAGES}
    spans_total = []
    for scope, stage in per_scenario.items():
        lo, hi = bounds[scope]
        spans_total.append(hi - lo)
        for st in LIFECYCLE_STAGES:
            stage_sums[st].append(stage.get(st, 0.0))
    attributed = sum(sum(v) for v in stage_sums.values())
    for st in LIFECYCLE_STAGES:
        tot = float(sum(stage_sums[st]))
        crit[st] = {
            "mean_ms": (tot / len(per_scenario) * 1e3
                        if per_scenario else 0.0),
            "share": tot / attributed if attributed > 0 else 0.0,
        }

    return {
        "span_count": len(spans),
        "scenarios": len(per_scenario),
        "workers": sorted({s.worker for s in spans}),
        "end_to_end_p50_ms": p50_s(spans_total) * 1e3,
        "end_to_end_p99_ms": p99_s(spans_total) * 1e3,
        "stages": stages,
        "critical_path": crit,
    }


def format_summary(summary: Dict) -> str:
    """Human-readable rendering of :func:`summarize` output."""
    lines = [
        f"spans: {summary['span_count']}   "
        f"scenarios: {summary['scenarios']}   "
        f"workers: {', '.join(summary['workers']) or '-'}",
        f"end-to-end p50/p99: {summary['end_to_end_p50_ms']:.2f} / "
        f"{summary['end_to_end_p99_ms']:.2f} ms",
        "",
        f"{'stage':24s} {'count':>7s} {'p50 ms':>9s} {'p99 ms':>9s} "
        f"{'total s':>9s}",
    ]
    for name, st in summary["stages"].items():
        lines.append(f"{name:24s} {st['count']:7d} {st['p50_ms']:9.3f} "
                     f"{st['p99_ms']:9.3f} {st['total_s']:9.3f}")
    lines.append("")
    lines.append("critical path (mean per scenario, share of attributed "
                 "stage time):")
    for st, row in summary["critical_path"].items():
        bar = "#" * int(round(row["share"] * 40))
        lines.append(f"  {st:12s} {row['mean_ms']:9.3f} ms  "
                     f"{row['share'] * 100:5.1f}%  {bar}")
    return "\n".join(lines)

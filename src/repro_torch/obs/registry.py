"""Process-wide metrics registry — counters, gauges, histograms.

Mirrors the shape (not the code) of a Prometheus client: named metrics
with labeled series, a text exposition format, and a JSON snapshot for
tests and benchmark reports.  A copy of ``repro.obs.registry``
(standard library only): ``repro_torch.stream.metrics`` publishes its
rollup here after computing its summary dataclass, so a long-lived
service accumulates counters across runs while per-run ``summary()``
dicts stay byte-compatible.  The metric names are the reference's, so
both packages expose the same Prometheus text.

Naming convention (the reference's): ``repro_<subsystem>_<what>``
with a unit suffix where one applies — ``_total`` for counters,
``_seconds`` for time.  Labels are for low-cardinality dimensions only
(priority class, quantile name, worker id, warmup phase); scenario uids
never become labels.

Thread-safety: the registry get-or-creates metrics under its own lock;
each metric guards its series map with its own lock, so concurrent
``inc``/``observe`` from analysis workers and the pipeline thread are
safe and lock hold times stay tiny.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, float("inf"))


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class _Metric:
    """Base: one named metric holding labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = "") -> None:
        self.name = name
        self.help_text = help_text
        self._lock = threading.Lock()
        self._series: Dict[_LabelKey, object] = {}  # @locked:_lock

    def _get(self, labels: Dict[str, str], default):
        """Read-or-create the series value for a label set.

        @holds:_lock (callers inc/set/observe take the lock first)."""
        key = _label_key(labels)
        if key not in self._series:
            self._series[key] = default
        return key

    def series(self) -> Dict[_LabelKey, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            key = self._get(labels, 0.0)
            self._series[key] = float(self._series[key]) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            key = self._get(labels, 0.0)
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._get(labels, 0.0)
            self._series[key] = float(self._series[key]) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Cumulative-bucket histogram per label set (Prometheus layout:
    ``_bucket{le=...}`` counts are cumulative, plus ``_sum``/``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help_text)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != float("inf"):
            bounds = bounds + (float("inf"),)
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        with self._lock:
            key = self._get(labels, None)
            state = self._series[key]
            if state is None:
                state = {"counts": [0] * len(self.buckets),
                         "sum": 0.0, "count": 0}
                self._series[key] = state
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    state["counts"][i] += 1
                    break
            state["sum"] += value
            state["count"] += 1

    def value(self, **labels) -> Optional[Dict]:
        with self._lock:
            state = self._series.get(_label_key(labels))
            return None if state is None else {
                "counts": list(state["counts"]),
                "sum": state["sum"], "count": state["count"]}


class MetricsRegistry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` are
    get-or-create; re-registering a name as a different kind raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # @locked:_lock

    def _register(self, name: str, cls, help_text: str, **kw) -> _Metric:
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help_text, **kw)
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{metric.kind}, requested {cls.kind}")
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._register(name, Counter, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._register(name, Gauge, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(name, Histogram, help_text, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric (tests; a live service never calls this)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict:
        """JSON-ready dump: ``{name: {"kind", "help", "series": [...]}}``
        with one ``{"labels": {...}, "value": ...}`` entry per series."""
        out: Dict = {}
        for m in self.metrics():
            rows = []
            for key, val in sorted(m.series().items()):
                if isinstance(val, dict):           # histogram state
                    val = {"sum": val["sum"], "count": val["count"],
                           "counts": list(val["counts"]),
                           "buckets": [b for b in m.buckets]}
                rows.append({"labels": dict(key), "value": val})
            out[m.name] = {"kind": m.kind, "help": m.help_text,
                           "series": rows}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help_text:
                lines.append(f"# HELP {m.name} {m.help_text}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, val in sorted(m.series().items()):
                if isinstance(val, dict):           # histogram series
                    cum = 0
                    for bound, n in zip(m.buckets, val["counts"]):
                        cum += n
                        bkey = key + (("le", _fmt_value(bound)),)
                        lines.append(f"{m.name}_bucket"
                                     f"{_fmt_labels(bkey)} {cum}")
                    lines.append(f"{m.name}_sum{_fmt_labels(key)} "
                                 f"{val['sum']!r}")
                    lines.append(f"{m.name}_count{_fmt_labels(key)} "
                                 f"{val['count']}")
                else:
                    lines.append(f"{m.name}{_fmt_labels(key)} "
                                 f"{_fmt_value(val)}")
        return "\n".join(lines) + "\n"

    def json(self, **dumps_kw) -> str:
        return json.dumps(self.snapshot(), **dumps_kw)


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every subsystem publishes to."""
    return _DEFAULT_REGISTRY

"""repro_torch.obs — tracing, metrics, and flight recording for the port.

A port of ``repro.obs``, whose modules use the standard library and
numpy only, so they are copies.  One config object, :class:`ObsConfig`,
threads through ``StreamConfig.obs`` / ``SweepConfig.obs`` (as a
dataclass or a plain dict) and turns on three layers:

* **spans** (:mod:`repro_torch.obs.trace`): one tree per scenario,
  ``admit -> analyze -> queue_wait -> dispatch -> device -> route``
  plus memo and sweep spans, exportable as a Perfetto-loadable Chrome
  trace (:mod:`repro_torch.obs.export`, ``python -m repro_torch.obs``);
* **metrics** (:mod:`repro_torch.obs.registry`): process-wide labeled
  counters/gauges/histograms with Prometheus text exposition, fed by
  the stream's metric rollup;
* **flight recorder** (:mod:`repro_torch.obs.flight`): last-N events
  per worker, dumped on exception or deadline miss.

Everything is host-side: spans wrap host work (assembly, the issue of
device work, waits, routing), so an instrumented schedule is bitwise the
uninstrumented one.  Disabled (the default) the whole layer is a handful
of attribute checks per scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.export import (LIFECYCLE_STAGES, format_summary,
                                    read_trace, summarize, to_chrome_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.flight import FlightRecorder, capture
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, get_registry)
from repro_torch.obs.stats import interval_union_s, p50_s, p99_s, quantile_s
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, RunClock, Span,
                                   Tracer, get_tracer)

__all__ = [
    "ObsConfig", "as_obs_config",
    "Tracer", "Span", "RunClock", "NULL_SPAN", "NULL_TRACER",
    "get_tracer",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "FlightRecorder", "capture",
    "p50_s", "p99_s", "quantile_s", "interval_union_s",
    "LIFECYCLE_STAGES", "to_chrome_trace", "write_chrome_trace",
    "write_jsonl", "read_trace", "summarize", "format_summary",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knob.  ``enabled=False`` (the default) keeps every
    instrumented path at its uninstrumented cost."""

    enabled: bool = False
    trace_capacity: int = 65536     # span ring size (oldest evicted)
    clear_per_run: bool = True      # stream service: fresh trace per run
    flight_events: int = 256        # flight-recorder ring per worker
    flight_dir: Optional[str] = None  # dump dir; None -> stderr
    dump_on_deadline_miss: bool = True
    worker: str = "main"            # track label (worker id)

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1, got "
                             f"{self.trace_capacity}")
        if self.flight_events < 1:
            raise ValueError("flight_events must be >= 1, got "
                             f"{self.flight_events}")


def as_obs_config(obs) -> ObsConfig:
    """Coerce the wire-friendly forms (``None`` / dict / ``ObsConfig``)
    to an :class:`ObsConfig`."""
    if obs is None:
        return ObsConfig()
    if isinstance(obs, ObsConfig):
        return obs
    if isinstance(obs, dict):
        return ObsConfig(**obs)
    raise TypeError(f"obs must be None, dict, or ObsConfig, got "
                    f"{type(obs).__name__}")

"""repro_torch.stream — streaming multi-tenant scheduling service.

A port of ``repro.stream``.  Turns the batch (analyze-then-sweep)
workflow into a continuous pipeline: a deterministic arrival-trace
generator (``workloads``), an async host analysis stage (``analysis``),
an admission/batching stage dispatching ready scenarios through the
sweep's row function on the service's device (``service``), and a
result router + service metrics (``metrics``).  Every streamed schedule
is bitwise a standalone ``run_strategy`` / ``run_sweep`` row on the same
device — the pipeline only changes *when* schedules are computed, never
*what* they are.
"""
from repro_torch.stream.workloads import (ARRIVAL_KINDS, PRIORITY_CLASSES,
                                          ScenarioRequest, TraceConfig,
                                          generate_trace)
from repro_torch.stream.analysis import (AnalysisPool, ReadyScenario,
                                         analyze_serial)
from repro_torch.stream.metrics import (StreamMetrics, compute_metrics,
                                        interval_union_s, p99_s)
from repro_torch.stream.service import (PreparedScenario, StreamConfig,
                                        StreamResult, StreamingScheduler)

__all__ = [
    "ARRIVAL_KINDS", "PRIORITY_CLASSES", "ScenarioRequest",
    "TraceConfig", "generate_trace",
    "AnalysisPool", "ReadyScenario", "analyze_serial",
    "StreamMetrics", "compute_metrics", "interval_union_s", "p99_s",
    "PreparedScenario", "StreamConfig", "StreamResult",
    "StreamingScheduler",
]

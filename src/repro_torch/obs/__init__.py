"""repro_torch.obs — span tracing for the port.

Only the tracer (:mod:`repro_torch.obs.trace`, a copy of
``repro.obs.trace``) is ported so far: the schedule memo records its
``memo.lookup`` / ``memo.warm_start`` / ``memo.record`` spans into one.
The reference's config object, exporters, metric registry and flight
recorder are ROADMAP Queue 1 item 13.
"""
from repro_torch.obs.trace import (NULL_SPAN, NULL_TRACER, RunClock, Span,
                                   Tracer, get_tracer)

__all__ = ["Tracer", "Span", "RunClock", "NULL_SPAN", "NULL_TRACER",
           "get_tracer"]

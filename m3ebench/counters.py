"""The program's own always-on counters, read from its process registry
(``repro_torch.obs.get_registry()``), for the metrics that read them.

The counters are process-cumulative: they hold the set-up's calls (two
warm-up calls; for the stream, one batch of each size and the warm
traffic), the window's and, in a traced run, the profiled stretch's
after it.  The window is about 95% or more of each count.  A program
that keeps no such counter gives nothing to read: the metric is left
out.
"""
from __future__ import annotations

from typing import Dict, Optional


def totals() -> Dict[str, float]:
    """Every counter's total over its label sets."""
    from repro_torch.obs import get_registry
    return {name: sum(float(s["value"]) for s in m["series"])
            for name, m in get_registry().snapshot().items()
            if m["kind"] == "counter"}


def ratio(num: str, den: str, scale: float = 1.0) -> Optional[float]:
    """``scale`` x counter ``num`` over counter ``den``; None where either
    is absent or zero."""
    t = totals()
    n, d = t.get(num), t.get(den)
    if not n or not d:
        return None
    return scale * n / d

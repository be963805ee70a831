"""Shared latency statistics — one home for the tail math.

A copy of ``repro.obs.stats`` (standard library and numpy only).  The
stream metrics (``repro_torch.stream.metrics``, which re-exports
``p99_s`` and ``interval_union_s``) and the trace summaries
(``repro_torch.obs.export``) report tails through these functions.

The house rule for tails: ``np.percentile(..., method="higher")``.
Linear interpolation reads *below* the observed worst sample whenever
there are fewer than ~100 samples (exactly the ``--quick`` bench
regime), which is the wrong direction to be optimistic in for a tail
metric.  The 10-sample unit test in ``tests/test_torch_stream.py`` pins
this: p99 of 10 samples is the observed max.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def quantile_s(xs, q: float, method: str = "higher") -> float:
    """``np.percentile`` with the tail-conservative default and a 0.0
    empty-input convention (metrics stay finite, never NaN)."""
    xs = np.asarray(xs, dtype=np.float64)
    if not len(xs):
        return 0.0
    return float(np.percentile(xs, q, method=method))


def p50_s(xs) -> float:
    """Median with linear interpolation (matches the historical
    ``np.percentile(lats, 50)`` in the stream metrics).  0.0 on empty."""
    return quantile_s(xs, 50, method="linear")


def p99_s(lats) -> float:
    """Tail-conservative p99: the smallest OBSERVED latency >= the 99th
    percentile (``method="higher"``), never an interpolated value below
    the worst sample.  0.0 on empty input."""
    return quantile_s(lats, 99, method="higher")


def interval_union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by a set of [start, end] intervals."""
    total, last_end = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end <= last_end:
            continue
        total += end - max(start, last_end)
        last_end = end
    return total

"""Stream metrics — the service-level numbers the pipeline is judged by.

A port of ``repro.stream.metrics``: the same results and batch records
give an equal ``summary()``, published to the port's metrics registry
under the reference's metric names.

Batch sweeps report one wall time; a streaming service is judged like a
server: per-scenario schedule latency (arrival -> schedule returned)
p50/p99, sustained scenarios/sec, and how busy the pipeline keeps the
device (device-idle fraction — the quantity the async analysis stage
exists to shrink).  Device busy time is the union of the batches'
intervals (batches may overlap: up to ``max_inflight`` are issued at
once, so summing them would double-count).  On a card each batch carries
its loops' interval on the card itself (``card_start_s`` /
``card_end_s``: timing events around each shard's loop, placed on the
run's clock), and the busy time is the union of those.  Without them
(the CPU, or batch records that lack them) it is the union of the host's
``[dispatch_s, done_s]`` windows, as in the reference: ``dispatch_s``
stamped before the batch's first launch is issued, ``done_s`` when the
router saw the batch finished, which is after the card finished it by
however long the router took to look (the route lag), so those windows
count the route lag as busy.

Besides the reference's rollup, :func:`compute_metrics` adds the card's
counters to the process registry: ``repro_stream_batches_total``, and
for the batches timed on the card ``repro_stream_batch_card_seconds_total``
(card start to end), ``repro_stream_card_queue_seconds_total`` (issued
to card start), ``repro_stream_route_lag_seconds_total`` (card end to
seen done), ``repro_stream_card_busy_seconds_total`` (the run's union
of them) and ``repro_stream_run_seconds_total`` (the run's wall).

SLO accounting: requests may carry a priority class and a deadline
(``ScenarioRequest.priority`` / ``deadline_s``); the metrics report the
attainment fraction (share of deadline-carrying schedules routed within
their deadline), the miss count, and per-class p99 latency.  p99 uses
``np.percentile(..., method="higher")`` — linear interpolation would
read *below* the observed worst latency whenever there are fewer than
~100 samples (exactly the ``--quick`` bench regime), which is the wrong
direction to be optimistic in for a tail metric.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

# canonical home is repro_torch.obs.stats (one tail-math implementation
# for the stream and trace summaries); re-exported here as the reference
# does
from repro_torch.obs.stats import interval_union_s, p99_s
from repro_torch.obs.registry import get_registry
from repro_torch.stream.workloads import PRIORITY_CLASSES

__all__ = ["StreamMetrics", "compute_metrics", "interval_union_s",
           "p99_s"]


@dataclasses.dataclass(frozen=True)
class StreamMetrics:
    num_scenarios: int
    wall_s: float                   # first submit -> last result routed
    scenarios_per_sec: float
    latency_p50_s: float            # arrival -> schedule returned
    latency_p99_s: float
    latency_mean_s: float
    analysis_busy_s: float          # union of analysis intervals
    device_busy_s: float            # union of the batches' card intervals
                                    # (host [dispatch, done] without them)
    device_idle_frac: float         # 1 - device_busy/wall
    num_batches: int
    mean_batch_fill: float          # real rows / padded rows, averaged
    # schedule-memo reuse (0 when the service runs without a memo).
    # DISJOINT counters: an exact hit whose stored row happens to be
    # warm-seeded counts as exact only, so
    # exact + warm + cold == num_scenarios always holds
    memo_exact_hits: int = 0        # answered from the store, NO dispatch
    memo_warm_hits: int = 0         # searched, seeded from a stored
                                    # population (and not an exact hit)
    # SLO accounting (vacuous defaults when no request carries one)
    slo_attainment: float = 1.0     # fraction of deadline-carrying
                                    # schedules routed within deadline
                                    # (1.0 when none carry a deadline)
    deadline_misses: int = 0
    num_with_deadline: int = 0
    latency_p99_urgent_s: float = 0.0    # per-class p99 (0.0 when the
    latency_p99_normal_s: float = 0.0    # class has no results)
    latency_p99_batch_s: float = 0.0
    # anytime mode: interim schedules returned to callers, background
    # refinements recorded to the memo (never routed)
    anytime_interims: int = 0
    anytime_refinements: int = 0
    # admission accounting (from the run's AdmissionQueues; zeros when
    # unavailable).  A member counts in exactly one of dispatched /
    # stolen — a held partial flushed early or stolen by the fleet
    # router is never double-counted (``early_flushes`` tags reasons,
    # it is not a second member count)
    queue_peak_depth: int = 0       # max members held at once
    early_flushes: int = 0          # partials preempted out of hold
    stolen_members: int = 0         # members taken by a fleet router

    def summary(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def compute_metrics(results, batches, wall_s: float,
                    refinements: int = 0,
                    admission=None) -> StreamMetrics:
    """Aggregate routed
    :class:`~repro_torch.stream.service.StreamResult`s and per-batch
    dispatch records into service metrics.  ``refinements``
    counts the anytime background rows that were recorded but (by
    design) never routed — they are device work the results list cannot
    show."""
    lats = np.array([r.latency_s for r in results], dtype=np.float64)
    card = [(b.card_start_s, b.card_end_s) for b in batches
            if getattr(b, "card_start_s", None) is not None]
    carded = bool(batches) and len(card) == len(batches)
    dev = interval_union_s(card if carded else
                           [(b.dispatch_s, b.done_s) for b in batches])
    ana = interval_union_s(
        [(r.analysis_start_s, r.ready_s) for r in results
         if r.ready_s > r.analysis_start_s])
    fills = [b.rows / max(b.padded_rows, 1) for b in batches]
    wall = max(wall_s, 1e-12)

    by_class: Dict[str, List[float]] = {c: [] for c in PRIORITY_CLASSES}
    misses, with_deadline = 0, 0
    for r in results:
        req = r.request
        by_class[getattr(req, "priority", "normal")].append(r.latency_s)
        deadline = getattr(req, "deadline_s", None)
        if deadline is not None:
            with_deadline += 1
            misses += r.latency_s > deadline

    m = StreamMetrics(
        num_scenarios=len(results),
        wall_s=wall_s,
        scenarios_per_sec=len(results) / wall,
        latency_p50_s=float(np.percentile(lats, 50)) if len(lats) else 0.0,
        latency_p99_s=p99_s(lats),
        latency_mean_s=float(lats.mean()) if len(lats) else 0.0,
        analysis_busy_s=ana,
        device_busy_s=dev,
        device_idle_frac=max(0.0, 1.0 - dev / wall),
        num_batches=len(batches),
        mean_batch_fill=float(np.mean(fills)) if fills else 0.0,
        # exact wins: a replayed row whose stored solve was warm-seeded
        # is an exact hit, not a warm hit (the flags stay on the result
        # for provenance; the counters partition the scenarios)
        memo_exact_hits=sum(bool(getattr(r, "memo_exact", False))
                            for r in results),
        memo_warm_hits=sum(bool(getattr(r, "warm_seeded", False))
                           and not getattr(r, "memo_exact", False)
                           for r in results),
        slo_attainment=(1.0 - misses / with_deadline
                        if with_deadline else 1.0),
        deadline_misses=int(misses),
        num_with_deadline=int(with_deadline),
        latency_p99_urgent_s=p99_s(by_class["urgent"]),
        latency_p99_normal_s=p99_s(by_class["normal"]),
        latency_p99_batch_s=p99_s(by_class["batch"]),
        anytime_interims=sum(bool(getattr(r, "anytime_interim", False))
                             for r in results),
        anytime_refinements=int(refinements),
        # `is not None`, NOT truthiness: a drained AdmissionQueues is
        # falsy (empty) but its counters are exactly what we want
        queue_peak_depth=(admission.peak_depth
                          if admission is not None else 0),
        early_flushes=(admission.early_flushes
                       if admission is not None else 0),
        stolen_members=(admission.stolen if admission is not None else 0),
    )
    _publish(m, lats)
    _publish_card(batches, wall_s, dev if carded else None)
    return m


def _publish_card(batches, wall_s: float, card_busy_s) -> None:
    """The run's batches on the card into the process registry:
    counters, accumulating across runs (``card_busy_s`` None: the
    batches were not all timed on the card)."""
    reg = get_registry()
    reg.counter("repro_stream_batches_total",
                "Device batches the stream service routed").inc(len(batches))
    if card_busy_s is None:
        return
    for b in batches:
        reg.counter("repro_stream_batch_card_seconds_total",
                    "Card seconds of the stream's batches").inc(
                        b.card_end_s - b.card_start_s)
        reg.counter("repro_stream_card_queue_seconds_total",
                    "Seconds from a batch's issue to its card start").inc(
                        max(0.0, b.card_start_s - b.issued_s))
        reg.counter("repro_stream_route_lag_seconds_total",
                    "Seconds from a batch's card end to the router seeing "
                    "it done").inc(max(0.0, b.done_s - b.card_end_s))
    reg.counter("repro_stream_card_busy_seconds_total",
                "The card's busy seconds over stream runs (union of the "
                "batches' card intervals)").inc(card_busy_s)
    reg.counter("repro_stream_run_seconds_total",
                "Wall seconds of stream runs with batches timed on the "
                "card").inc(wall_s)


def _publish(m: StreamMetrics, lats) -> None:
    """Roll the run's metrics up into the process-wide obs registry
    (additive on top of the returned dataclass, which stays the
    byte-compatible programmatic surface).  Counters accumulate across
    runs; gauges hold the latest run's values."""
    reg = get_registry()
    reg.counter("repro_stream_scenarios_total",
                "Scenarios routed by the stream service").inc(
                    m.num_scenarios)
    reg.counter("repro_stream_deadline_misses_total",
                "Deadline-carrying schedules routed late").inc(
                    m.deadline_misses)
    reg.counter("repro_stream_memo_hits_total",
                "Schedule-memo wins by kind").inc(
                    m.memo_exact_hits, kind="exact")
    reg.counter("repro_stream_memo_hits_total",
                "Schedule-memo wins by kind").inc(
                    m.memo_warm_hits, kind="warm")
    reg.gauge("repro_stream_latency_p99_seconds",
              "Last run's p99 schedule latency").set(m.latency_p99_s)
    reg.gauge("repro_stream_throughput_scenarios_per_second",
              "Last run's sustained scenario throughput").set(
                  m.scenarios_per_sec)
    reg.gauge("repro_stream_device_idle_fraction",
              "Last run's device-idle fraction").set(m.device_idle_frac)
    hist = reg.histogram("repro_stream_latency_seconds",
                         "Per-scenario schedule latency")
    for lat in lats:
        hist.observe(float(lat))

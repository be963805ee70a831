"""Fleet metrics — the rollups a fleet run is judged by.

One worker's numbers come from its own ``StreamMetrics``/``MemoStats``;
the fleet adds the cross-worker story: aggregate scenarios/sec on the
ROUTER wall clock (the number that must scale with workers), per-worker
shares (how skewed the trace was, how well stealing rebalanced it),
steal counts, queue depths, the cross-worker memo hit rate (schedules
one worker solved and another replayed — the shared store's win), and
fleet-level SLO attainment on router-observed latencies.  A copy of
``repro.fleet.metrics`` (standard library and numpy), publishing under the
same ``repro_fleet_*`` names into the port's obs registry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs.registry import get_registry
from repro_torch.obs.stats import p99_s


@dataclasses.dataclass(frozen=True)
class WorkerStats:
    """One worker's rollup (worker-side counters + router-side view)."""
    worker_id: str
    chunks: int = 0
    scenarios: int = 0            # results the worker computed/replayed
    run_wall_s: float = 0.0       # sum of its chunk pipeline walls
    peak_depth: int = 0           # worker-side admission peak
    early_flushes: int = 0
    refinements: int = 0          # anytime background rows
    memo_exact_hits: int = 0
    memo_foreign_hits: int = 0    # exact hits ANOTHER worker recorded
    memo_near_hits: int = 0
    memo_records: int = 0
    router_sent: int = 0          # members the router shipped here
    router_stolen_from: int = 0   # members stolen OUT of its front queue

    @property
    def scenarios_per_sec(self) -> float:
        return self.scenarios / max(self.run_wall_s, 1e-12)

    @classmethod
    def from_wire(cls, wid: str, d: Dict) -> "WorkerStats":
        memo = d.get("memo") or {}
        return cls(worker_id=wid,
                   chunks=int(d.get("chunks", 0)),
                   scenarios=int(d.get("scenarios", 0)),
                   run_wall_s=float(d.get("run_wall_s", 0.0)),
                   peak_depth=int(d.get("peak_depth", 0)),
                   early_flushes=int(d.get("early_flushes", 0)),
                   refinements=int(d.get("refinements", 0)),
                   memo_exact_hits=int(memo.get("exact_hits", 0)),
                   memo_foreign_hits=int(memo.get("foreign_hits", 0)),
                   memo_near_hits=int(memo.get("near_hits", 0)),
                   memo_records=int(memo.get("records", 0)),
                   router_sent=int(d.get("router_sent", 0)),
                   router_stolen_from=int(d.get("router_stolen_from", 0)))


@dataclasses.dataclass(frozen=True)
class FleetMetrics:
    num_workers: int
    num_scenarios: int
    wall_s: float                 # router clock: admit -> last result
    scenarios_per_sec: float      # aggregate, on the router wall
    latency_p50_s: float          # router-observed (admit -> received)
    latency_p99_s: float
    # balancing
    steals: int                   # steal events (whole-partial moves)
    stolen_members: int           # members moved by stealing
    router_peak_depth: int        # max members held across front queues
    per_worker_scenarios: Tuple[int, ...]
    per_worker_rate: Tuple[float, ...]   # scenarios/sec inside each
                                         # worker's own pipeline walls
    # shared memo (zeros without one)
    memo_exact_hits: int = 0
    memo_foreign_hits: int = 0    # exact hits crossing worker boundaries
    cross_worker_hit_rate: float = 0.0   # foreign / exact (0 if none)
    memo_records: int = 0
    # SLO attainment on router-observed latency
    slo_attainment: float = 1.0
    deadline_misses: int = 0
    num_with_deadline: int = 0

    def summary(self) -> Dict:
        return dataclasses.asdict(self)


def compute_fleet_metrics(results, worker_stats: Dict[str, Dict],
                          wall_s: float, steals: int = 0,
                          stolen_members: int = 0,
                          router_peak_depth: int = 0) -> FleetMetrics:
    """Aggregate a run's :class:`~repro_torch.fleet.router.FleetResult`s and
    the workers' wire-format stat dicts."""
    stats: List[WorkerStats] = [WorkerStats.from_wire(wid, d)
                                for wid, d in sorted(worker_stats.items())]
    lats = np.asarray([r.latency_s for r in results], dtype=np.float64)
    misses = with_deadline = 0
    for r in results:
        met = r.deadline_met
        if met is not None:
            with_deadline += 1
            misses += not met
    exact = sum(s.memo_exact_hits for s in stats)
    foreign = sum(s.memo_foreign_hits for s in stats)
    m = FleetMetrics(
        num_workers=len(stats),
        num_scenarios=len(results),
        wall_s=wall_s,
        scenarios_per_sec=len(results) / max(wall_s, 1e-12),
        latency_p50_s=float(np.percentile(lats, 50)) if len(lats) else 0.0,
        latency_p99_s=p99_s(lats),
        steals=int(steals),
        stolen_members=int(stolen_members),
        router_peak_depth=int(router_peak_depth),
        per_worker_scenarios=tuple(s.scenarios for s in stats),
        per_worker_rate=tuple(round(s.scenarios_per_sec, 3)
                              for s in stats),
        memo_exact_hits=exact,
        memo_foreign_hits=foreign,
        cross_worker_hit_rate=(foreign / exact if exact else 0.0),
        memo_records=sum(s.memo_records for s in stats),
        slo_attainment=(1.0 - misses / with_deadline
                        if with_deadline else 1.0),
        deadline_misses=int(misses),
        num_with_deadline=int(with_deadline),
    )
    _publish(m, stats)
    return m


def _publish(m: FleetMetrics, stats: List[WorkerStats]) -> None:
    """Additive obs-registry rollup (counters accumulate across runs,
    gauges hold the latest run); the returned dataclass is unchanged."""
    reg = get_registry()
    routed = reg.counter("repro_fleet_scenarios_total",
                         "Scenarios routed, by worker")
    for s in stats:
        routed.inc(s.scenarios, worker=s.worker_id)
    reg.counter("repro_fleet_steals_total",
                "Work-stealing events across the fleet").inc(m.steals)
    reg.counter("repro_fleet_memo_foreign_hits_total",
                "Exact memo hits recorded by a different worker").inc(
                    m.memo_foreign_hits)
    reg.gauge("repro_fleet_latency_p99_seconds",
              "Last fleet run's p99 router-observed latency").set(
                  m.latency_p99_s)
    reg.gauge("repro_fleet_throughput_scenarios_per_second",
              "Last fleet run's aggregate throughput").set(
                  m.scenarios_per_sec)
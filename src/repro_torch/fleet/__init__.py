"""repro_torch.fleet — a scheduling fleet over ``repro_torch.stream``.

One level up from the single-process service (MAGMA's many-jobs /
many-cores contention, applied to many scheduler *processes*): N
workers, each running the unchanged
:class:`~repro_torch.stream.StreamingScheduler` on its own device, fed by
a front-door router that partitions the arrival trace by compatibility
key and rebalances with work-stealing, all sharing one
fingerprint-sharded memo store so every schedule is computed once
fleet-wide.  A port of ``repro.fleet``.

The contract that keeps the fleet reviewable: every schedule a fleet
returns is bitwise the port's standalone row for the same (scenario,
seed) on the same device type — regardless of worker count, steal history,
or which worker served it (held by tests/test_torch_fleet.py and
chip_smoke.py's fleet phase).
"""
from repro_torch.fleet.shared_memo import (NUM_SHARDS, ShardedMemoStore,
                                           shard_of)
from repro_torch.fleet.launch import Fleet, FleetConfig, launch_fleet
from repro_torch.fleet.router import FleetRouter, WorkerQueue
from repro_torch.fleet.metrics import (FleetMetrics, WorkerStats,
                                       compute_fleet_metrics)

__all__ = [
    "NUM_SHARDS", "ShardedMemoStore", "shard_of",
    "Fleet", "FleetConfig", "launch_fleet",
    "FleetRouter", "WorkerQueue",
    "FleetMetrics", "WorkerStats", "compute_fleet_metrics",
]

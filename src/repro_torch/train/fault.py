"""Fault tolerance: straggler detection and elastic re-mesh planning, a
numpy copy of ``repro.train.fault``.

At 1000+ nodes the dominant failure modes are (i) slow hosts (thermal,
network, preemption warnings) and (ii) lost hosts.  The watchdog consumes
per-host heartbeat step times, maintains an EWMA per host, and flags hosts
whose EWMA exceeds ``threshold`` x the fleet median.  ``plan_remesh``
converts the healthy-host set into the largest valid mesh (model axis is
fixed by the parallelism plan; the data/pod axes shrink), which combined
with unpartitioned checkpoints (``train.checkpoint``) and the random-access
data pipeline (``train.data``) gives elastic restart:

    detect -> plan_remesh -> restore(checkpoint, new mesh) -> continue at
    the same step with the same data order.

``repro_torch.launch.mesh.make_mesh_from_plan`` turns a ``MeshPlan`` into
a ``DeviceMesh``.

Pure logic, fully unit-testable without hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerWatchdog:
    n_hosts: int
    ewma_alpha: float = 0.3
    threshold: float = 2.0          # x fleet median EWMA
    grace_steps: int = 3            # consecutive slow steps before flagging

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.slow_streak = np.zeros(self.n_hosts, dtype=int)
        self.seen = np.zeros(self.n_hosts, dtype=bool)

    def observe(self, step_times: Sequence[float]) -> List[int]:
        """Feed one step's per-host times; returns flagged host ids."""
        t = np.asarray(step_times, dtype=float)
        assert t.shape == (self.n_hosts,)
        self.ewma = np.where(self.seen,
                             (1 - self.ewma_alpha) * self.ewma
                             + self.ewma_alpha * t, t)
        self.seen[:] = True
        med = np.median(self.ewma)
        slow = self.ewma > self.threshold * med
        self.slow_streak = np.where(slow, self.slow_streak + 1, 0)
        return list(np.nonzero(self.slow_streak >= self.grace_steps)[0])

    def observe_missing(self, missing_hosts: Sequence[int]) -> List[int]:
        """Hosts that failed to heartbeat at all are flagged immediately."""
        return list(missing_hosts)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_chips: int

    @property
    def valid(self) -> bool:
        return all(s >= 1 for s in self.shape)


def plan_remesh(healthy_chips: int, model_axis: int = 16,
                chips_per_pod: int = 256,
                multi_pod: bool = True) -> Optional[MeshPlan]:
    """Largest (pod, data, model) mesh that fits the healthy chips.

    The model axis is fixed (parameter sharding layout); pods shrink first,
    then the data axis.  Returns None if fewer than one model axis worth of
    chips survives."""
    if healthy_chips < model_axis:
        return None
    if multi_pod and healthy_chips >= chips_per_pod:
        pods = healthy_chips // chips_per_pod
        data = chips_per_pod // model_axis
        if pods >= 2:
            return MeshPlan((pods, data, model_axis),
                            ("pod", "data", "model"),
                            pods * data * model_axis)
        healthy_chips = chips_per_pod
    data = healthy_chips // model_axis
    return MeshPlan((data, model_axis), ("data", "model"),
                    data * model_axis)


@dataclasses.dataclass
class ElasticController:
    """Glue: watchdog + re-mesh plan + restart decision record."""
    n_hosts: int
    chips_per_host: int = 4
    model_axis: int = 16

    def __post_init__(self):
        self.watchdog = StragglerWatchdog(self.n_hosts)
        self.dead: set = set()

    def step(self, step_times: Dict[int, float]) -> Optional[MeshPlan]:
        """step_times: host -> seconds (missing hosts absent).  Returns a
        new MeshPlan when membership changed, else None."""
        missing = [h for h in range(self.n_hosts)
                   if h not in step_times and h not in self.dead]
        times = np.array([step_times.get(h, np.nan) for h in range(self.n_hosts)])
        fleet_median = np.nanmedian(times) if np.isfinite(times).any() else 1.0
        times = np.where(np.isnan(times), fleet_median, times)
        flagged = set(self.watchdog.observe(times)) | set(missing)
        flagged -= self.dead
        if not flagged:
            return None
        self.dead |= flagged
        healthy_hosts = self.n_hosts - len(self.dead)
        return plan_remesh(healthy_hosts * self.chips_per_host,
                           model_axis=self.model_axis)

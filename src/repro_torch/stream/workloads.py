"""Workload/trace generator — multi-tenant scenario arrivals for the stream.

A port of ``repro.stream.workloads``; numpy only, so the same
``TraceConfig`` gives a trace equal to the reference's field by field.

The paper's end state is not one offline search but a *service*: jobs from
many DNNs keep arriving at a shared accelerator and every new mix needs a
mapping.  This module emits that arrival process as a deterministic trace
of :class:`ScenarioRequest`s — each request is one mapping problem (a DNN
mix x accelerator setting x system BW x PRNG seed) stamped with an arrival
time drawn from a configurable process:

  ``poisson``   independent exponential inter-arrivals at ``rate_hz`` —
                the steady multi-tenant baseline;
  ``bursty``    Poisson-arriving *bursts* whose size is geometric with
                mean ``burst_size`` (all members of a burst arrive
                together) — flash crowds / batched tenant uploads;
  ``batch``     everything arrives at t=0 — the offline-sweep degenerate
                case, useful as the serial-baseline reference.

Mixes default to the streaming heavy/light lineup
(``repro_torch.workloads.models``: AlphaGoZero, FasterRCNN, ResNet50 vs
DeepSpeech2, NCF, Transformer) over homogeneous and heterogeneous
sub-accelerator settings (Table III).  Everything is seeded: the same
``TraceConfig`` always generates the identical trace, which is what lets
tests replay a trace through the pipeline and compare every result
bit-for-bit against standalone searches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

ARRIVAL_KINDS = ("poisson", "bursty", "batch")

#: SLO priority classes, most to least urgent.  Admission orders the
#: ready queues by (class rank, slack); ``batch`` work never delays an
#: ``urgent`` schedule.
PRIORITY_CLASSES = ("urgent", "normal", "batch")


@dataclasses.dataclass(frozen=True)
class ScenarioRequest:
    """One mapping problem arriving at the stream."""
    uid: int
    arrival_s: float          # offset from trace start
    mix: str                  # repro_torch.workloads TASK_MODELS key
    setting: str              # accelerator setting (Table III: S1..S6)
    bw_gb: float              # system bandwidth, GB/s
    group_size: int           # jobs per dependency-free group
    seed: int                 # search PRNG seed AND group-layout seed
    objective: str = "throughput"
    budget: Optional[int] = None   # None: the service's default budget
    batch_scale: int = 1      # tenant mini-batch multiplier (scales every
                              # job's batch dim — distinct scales mean
                              # distinct cost-model profiles, the recurring
                              # analysis work a real arrival mix carries)
    flexible: bool = False    # flexible PE-array sub-accelerators
                              # (Fig. 14): analysis searches candidate
                              # array shapes per (layer, sub) — the
                              # expensive-analysis serving case
    priority: str = "normal"  # SLO class (PRIORITY_CLASSES)
    deadline_s: Optional[float] = None   # SLO latency budget, relative to
                              # arrival: the schedule should be routed by
                              # arrival_s + deadline_s.  None: no deadline
                              # (slack is infinite, only the class ranks)

    def __post_init__(self):
        # objective names are registry-validated at admission time, not
        # deep inside a device dispatch: a typo'd trace fails loudly
        # listing what is registered.  Multi-column provenance tokens
        # ("pareto:a+b", stamped by prepared frontier requests) validate
        # per component.
        from repro_torch.core.fitness import objective_info
        names = (self.objective[len("pareto:"):].split("+")
                 if self.objective.startswith("pareto:")
                 else [self.objective])
        for n in names:
            objective_info(n)
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(f"unknown priority {self.priority!r}; "
                             f"expected one of {PRIORITY_CLASSES}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 or None, got "
                             f"{self.deadline_s}")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Deterministic arrival-trace recipe (hash it, cache it, replay it)."""
    num_scenarios: int = 32
    arrival: str = "poisson"            # 'poisson' | 'bursty' | 'batch'
    rate_hz: float = 8.0                # mean scenario (or burst) arrivals/s
    burst_size: float = 4.0             # mean burst size ('bursty' only)
    mixes: Tuple[str, ...] = ("Heavy", "Light", "HeavyLight")
    settings: Tuple[str, ...] = ("S2", "S4")   # hetero small + hetero large
    bw_ladder_gb: Tuple[float, ...] = (1.0, 4.0, 16.0, 64.0)
    group_size: int = 64
    objectives: Tuple[str, ...] = ("throughput",)
    batch_scale_max: int = 1            # draw batch_scale from [1, max]
    flexible: bool = False              # profile flexible PE arrays
    priorities: Tuple[str, ...] = ("normal",)
                                        # SLO classes drawn uniformly per
                                        # request (repeat a class to
                                        # weight it, e.g. ("urgent",
                                        # "batch", "batch"))
    slo_by_class: Tuple[Tuple[str, float], ...] = ()
                                        # (class, deadline_s) pairs: the
                                        # per-class SLO latency budget;
                                        # classes absent here get no
                                        # deadline
    seed: int = 0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"expected one of {ARRIVAL_KINDS}")
        if self.num_scenarios < 1:
            raise ValueError("num_scenarios must be >= 1")
        if self.arrival != "batch" and self.rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0 for {self.arrival!r} "
                             f"arrivals, got {self.rate_hz}")
        if self.batch_scale_max < 1:
            raise ValueError(f"batch_scale_max must be >= 1, got "
                             f"{self.batch_scale_max}")
        if not self.priorities:
            raise ValueError("priorities must name at least one class")
        for p in self.priorities:
            if p not in PRIORITY_CLASSES:
                raise ValueError(f"unknown priority {p!r}; expected "
                                 f"members of {PRIORITY_CLASSES}")
        for entry in self.slo_by_class:
            cls, dl = entry
            if cls not in PRIORITY_CLASSES:
                raise ValueError(f"slo_by_class names unknown class "
                                 f"{cls!r}; expected members of "
                                 f"{PRIORITY_CLASSES}")
            if dl <= 0:
                raise ValueError(f"slo_by_class deadline for {cls!r} "
                                 f"must be > 0, got {dl}")


def _arrival_times(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    n = cfg.num_scenarios
    if cfg.arrival == "batch":
        return np.zeros(n)
    if cfg.arrival == "poisson":
        return np.cumsum(rng.exponential(1.0 / cfg.rate_hz, n))
    # bursty: draw burst sizes until they cover n, spread burst starts as a
    # Poisson process, members of a burst share the start instant
    sizes: List[int] = []
    while sum(sizes) < n:
        sizes.append(int(rng.geometric(1.0 / max(cfg.burst_size, 1.0))))
    starts = np.cumsum(rng.exponential(1.0 / cfg.rate_hz, len(sizes)))
    times = np.concatenate([np.full(s, t) for s, t in zip(sizes, starts)])
    return times[:n]


def generate_trace(cfg: TraceConfig) -> List[ScenarioRequest]:
    """Materialize the trace: ``num_scenarios`` requests, arrival-sorted.

    Scenario content (mix/setting/BW/objective) is drawn uniformly and
    independently of the arrival process, both from ``default_rng(seed)``
    — same config, same trace, bit-for-bit.
    """
    from repro_torch.workloads.models import TASK_MODELS

    for m in cfg.mixes:
        if m not in TASK_MODELS:
            raise ValueError(f"unknown mix {m!r}; expected keys of "
                             f"repro_torch.workloads.TASK_MODELS "
                             f"({', '.join(TASK_MODELS)})")
    rng = np.random.default_rng(cfg.seed)
    times = _arrival_times(cfg, rng)
    deadline_for = dict(cfg.slo_by_class)
    reqs = []
    for uid in range(cfg.num_scenarios):
        # single-class configs draw nothing extra, so every pre-SLO
        # TraceConfig still generates its bit-identical pre-SLO trace
        prio = (cfg.priorities[int(rng.integers(len(cfg.priorities)))]
                if len(cfg.priorities) > 1 else cfg.priorities[0])
        reqs.append(ScenarioRequest(
            uid=uid,
            arrival_s=float(times[uid]),
            mix=cfg.mixes[int(rng.integers(len(cfg.mixes)))],
            setting=cfg.settings[int(rng.integers(len(cfg.settings)))],
            bw_gb=float(cfg.bw_ladder_gb[
                int(rng.integers(len(cfg.bw_ladder_gb)))]),
            group_size=cfg.group_size,
            seed=int(rng.integers(2 ** 31 - 1)),
            objective=cfg.objectives[int(rng.integers(len(cfg.objectives)))],
            batch_scale=int(rng.integers(1, cfg.batch_scale_max + 1)),
            flexible=cfg.flexible,
            priority=prio,
            deadline_s=deadline_for.get(prio),
        ))
    return sorted(reqs, key=lambda r: (r.arrival_s, r.uid))

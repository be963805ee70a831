"""M3E driver (Section IV) — the complete optimization framework.

Wires together: Job Analyzer -> Job Analysis Table -> (encoder, decoder,
BW allocator, fitness) -> a chosen optimization method -> best mapping.

Method dispatch goes through the ``repro_torch.core.strategies`` registry;
every method receives the same fitness and the same sampling budget, the
paper's protocol.  Unknown method names raise a ``ValueError`` listing
what is registered.  The search runs on ``device`` ("cuda" unless the
caller asks for another).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.encoding import decode_to_lists
from repro_torch.core.fitness import FitnessFn, ObjectiveLike
from repro_torch.core.job_analyzer import JobAnalyzer
from repro_torch.core.magma import SearchResult
from repro_torch.core.strategies import get_strategy, run_strategy
from repro_torch.costmodel.accelerators import AcceleratorConfig
from repro_torch.workloads.benchmark import JobGroup


@dataclasses.dataclass
class M3E:
    """One optimization problem: (job group, accelerator, system BW)."""
    accel: AcceleratorConfig
    bw_sys: float                       # bytes/s
    objective: ObjectiveLike = "throughput"
    device: Union[str, torch.device] = "cuda"

    def prepare(self, group: JobGroup,
                objective: ObjectiveLike = None) -> FitnessFn:
        """The problem's ``FitnessFn``; ``objective`` overrides the
        instance default."""
        table = JobAnalyzer(self.accel).analyze(group.jobs)
        return FitnessFn(
            table, bw_sys=self.bw_sys,
            objective=self.objective if objective is None else objective,
            device=self.device)

    def search(self, group: JobGroup, method: str = "magma",
               budget: int = 10_000, seed: int = 0, *,
               init_population=None,
               keep_population: bool = False,
               strategy_kwargs: Optional[Mapping] = None) -> SearchResult:
        """Solve one mapping problem with a registered method.

        Method hyper-parameters (``cfg=`` for magma) go in
        ``strategy_kwargs`` and are validated by the strategy registry.
        """
        fit = self.prepare(group)
        strategy = get_strategy(method, **dict(strategy_kwargs or {}))
        return run_strategy(strategy, fit, budget=budget, seed=seed,
                            device=self.device,
                            init_population=init_population,
                            keep_population=keep_population)

    def describe_mapping(self, res: SearchResult) -> list:
        return decode_to_lists(res.best_accel, res.best_prio,
                               self.accel.num_sub_accels)


def geomean(xs: Sequence[float]) -> float:
    xs = np.asarray(xs, dtype=np.float64)
    return float(np.exp(np.log(np.maximum(xs, 1e-30)).mean()))

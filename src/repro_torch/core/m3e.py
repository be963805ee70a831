"""M3E driver (Section IV) — the complete optimization framework.

Wires together: Job Analyzer -> Job Analysis Table -> (encoder, decoder,
BW allocator, fitness) -> a chosen optimization method -> best mapping.

Method dispatch goes through the ``repro_torch.core.strategies`` registry
(MAGMA, the Table IV baselines and NSGA-II); every method receives the
same fitness and the same sampling budget, the paper's protocol.  The
reference's schedule memo and warm-start branches wait for ROADMAP Queue
1 items 8 and 7.  Unknown method names raise a ``ValueError`` listing
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
from repro_torch.core.pareto import ParetoFront, pareto_front
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
               engine: Optional[str] = None,
               init_population=None,
               keep_population: Optional[bool] = None,
               strategy_kwargs: Optional[Mapping] = None) -> SearchResult:
        """Solve one mapping problem with a registered method.

        Run-level knobs are keyword-only (``engine`` "scan" or "loop" for
        device-resident methods); method hyper-parameters (``cfg=`` for
        magma, ``population=`` for the black-box strategies, ...) go in
        ``strategy_kwargs`` and are validated by the strategy registry.
        """
        fit = self.prepare(group)
        strategy = get_strategy(method, **dict(strategy_kwargs or {}))
        run_kw = {}
        if engine is not None:
            run_kw["engine"] = engine
        if init_population is not None:
            run_kw["init_population"] = init_population
        if keep_population is not None:
            run_kw["keep_population"] = keep_population
        return run_strategy(strategy, fit, budget=budget, seed=seed,
                            device=self.device, **run_kw)

    def search_front(self, group: JobGroup,
                     objectives: Sequence[str] = ("latency", "energy",
                                                  "edp"),
                     method: str = "nsga2",
                     budget: int = 10_000, seed: int = 0, *,
                     engine: Optional[str] = None,
                     strategy_kwargs: Optional[Mapping] = None
                     ) -> ParetoFront:
        """Co-search several objectives at once -> a ``ParetoFront``.

        ``objectives`` name registered objective columns (the first one
        is the anytime scalar the search history tracks); ``method`` must
        be a ``multi_objective`` strategy (``nsga2``).
        """
        fit = self.prepare(group, objective=tuple(objectives))
        strategy = get_strategy(method, **dict(strategy_kwargs or {}))
        if not getattr(strategy, "multi_objective", False):
            raise ValueError(
                f"method {method!r} is single-objective; search_front "
                "needs a multi_objective strategy such as 'nsga2'")
        run_kw = {"keep_population": True}
        if engine is not None:
            run_kw["engine"] = engine
        res = run_strategy(strategy, fit, budget=budget, seed=seed,
                           device=self.device, **run_kw)
        return pareto_front(fit, res.final_population,
                            n_samples=res.n_samples,
                            wall_time_s=res.wall_time_s)

    def describe_mapping(self, res: SearchResult) -> list:
        return decode_to_lists(res.best_accel, res.best_prio,
                               self.accel.num_sub_accels)


def geomean(xs: Sequence[float]) -> float:
    xs = np.asarray(xs, dtype=np.float64)
    return float(np.exp(np.log(np.maximum(xs, 1e-30)).mean()))

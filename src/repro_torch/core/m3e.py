"""M3E driver (Section IV) — the complete optimization framework.

Wires together: Job Analyzer -> Job Analysis Table -> (encoder, decoder,
BW allocator, fitness) -> a chosen optimization method -> best mapping.

Method dispatch goes through the ``repro_torch.core.strategies`` registry
(MAGMA, the Table IV baselines and NSGA-II); every method receives the
same fitness and the same sampling budget, the paper's protocol.
Unknown method names raise a ``ValueError`` listing what is registered.
The search runs on ``device`` ("cuda" unless the caller asks for
another).  ``warm_start`` (Section V-C, populations kept per task type)
and ``memo`` (``repro_torch.memo``: exact-hit replay, nearest-scenario
warm seeds, every search recorded) are the reference's two reuse knobs.

Every search feeds the process registry (``repro_torch.obs``), always
on: ``repro_search_total``, ``repro_search_seconds_total`` (each call's
host wall), ``repro_search_prepare_seconds_total`` (the analysis and
tables) and ``repro_search_card_seconds_total`` (the generation loop on
the card, from timing events).  ``obs`` (``repro_torch.obs.ObsConfig``,
a dict of its fields, or None = off) enabled, a search emits its
``search.prepare``, ``search.loop``, ``search.readback`` and
``search.card`` spans on the process tracer; the host stages enter an
active torch profiler as ``repro.search.*`` ranges whatever ``obs`` says.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.encoding import decode_to_lists
from repro_torch.core.fitness import FitnessFn, ObjectiveLike
from repro_torch.core.job_analyzer import JobAnalyzer
from repro_torch.core.magma import SearchResult
from repro_torch.core.pareto import ParetoFront, pareto_front
from repro_torch.core.strategies import get_strategy, run_strategy
from repro_torch.core.warmstart import WarmStartEngine
from repro_torch.costmodel.accelerators import AcceleratorConfig
from repro_torch.obs import (NULL_TRACER, as_obs_config, get_registry,
                             get_tracer)
from repro_torch.obs.profiler import stage
from repro_torch.workloads.benchmark import JobGroup


@dataclasses.dataclass
class M3E:
    """One optimization problem: (job group, accelerator, system BW).

    ``warm_start`` is the Section V-C cache (population transfer keyed
    per task type); ``memo`` is the full ``repro_torch.memo`` subsystem —
    exact hits replay the stored schedule bit for bit with no search,
    misses are warm-seeded from the nearest stored scenario of the same
    task family, and every solved search is recorded back.  The two are
    independent knobs (the memo is consulted first when both are set).
    """
    accel: AcceleratorConfig
    bw_sys: float                       # bytes/s
    objective: ObjectiveLike = "throughput"
    device: Union[str, torch.device] = "cuda"
    warm_start: Optional[WarmStartEngine] = None
    memo: Optional[object] = None       # repro_torch.memo.ScheduleMemo
    obs: object = None                  # repro_torch.obs.ObsConfig

    def _tracer(self):
        return get_tracer() if as_obs_config(self.obs).enabled \
            else NULL_TRACER

    def prepare(self, group: JobGroup,
                objective: ObjectiveLike = None) -> FitnessFn:
        """The problem's ``FitnessFn``; ``objective`` overrides the
        instance default."""
        t0 = time.perf_counter()
        with stage("search.prepare", self._tracer(), jobs=len(group.jobs)):
            table = JobAnalyzer(self.accel).analyze(group.jobs)
            fit = FitnessFn(
                table, bw_sys=self.bw_sys,
                objective=self.objective if objective is None else objective,
                device=self.device)
        get_registry().counter(
            "repro_search_prepare_seconds_total",
            "Host seconds analysing job groups into fitness tables").inc(
                time.perf_counter() - t0)
        return fit

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
        t0 = time.perf_counter()
        res = self._search(group, method, budget, seed, engine,
                           init_population, keep_population, strategy_kwargs)
        _count_search(time.perf_counter() - t0, res)
        return res

    def _search(self, group: JobGroup, method: str, budget: int, seed: int,
                engine: Optional[str], init_population,
                keep_population: Optional[bool],
                strategy_kwargs: Optional[Mapping]) -> SearchResult:
        fit = self.prepare(group)
        strategy = get_strategy(method, **dict(strategy_kwargs or {}))
        run_kw = {"tracer": self._tracer()}
        if engine is not None:
            run_kw["engine"] = engine
        if init_population is not None:
            run_kw["init_population"] = init_population
        if keep_population is not None:
            run_kw["keep_population"] = keep_population
        if self.memo is not None and strategy.device_resident \
                and init_population is None:
            # a caller-supplied init_population bypasses the memo: a
            # replay would discard the seed, and the seeded result
            # recorded under the cold fingerprint would poison exact-hit
            # bit-identity for every other client
            return self._search_memoized(group, strategy, fit, budget, seed,
                                         run_kw)
        if strategy.name == "magma" and self.warm_start is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + 1)
            init = self.warm_start.init_population(
                group.task, gen, fit.group_size, fit.num_accels)
            if init is not None:
                run_kw.setdefault("init_population", init)
            run_kw.setdefault("keep_population", True)
            res = run_strategy(strategy, fit, budget=budget, seed=seed,
                               device=self.device, **run_kw)
            if res.final_population is not None:
                self.warm_start.remember(group.task, res.final_population)
            return res
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
        be a ``multi_objective`` strategy (``nsga2``).  Rides the same
        memo as ``search``: the converged archive is recorded under the
        vector spec's fingerprint, so a re-seen frontier request replays
        its front without a search.
        """
        t0 = time.perf_counter()
        fit = self.prepare(group, objective=tuple(objectives))
        strategy = get_strategy(method, **dict(strategy_kwargs or {}))
        if not getattr(strategy, "multi_objective", False):
            raise ValueError(
                f"method {method!r} is single-objective; search_front "
                "needs a multi_objective strategy such as 'nsga2'")
        run_kw = {"keep_population": True, "tracer": self._tracer()}
        if engine is not None:
            run_kw["engine"] = engine
        if self.memo is not None and strategy.device_resident:
            res = self._search_memoized(group, strategy, fit, budget, seed,
                                        run_kw)
        else:
            res = run_strategy(strategy, fit, budget=budget, seed=seed,
                               device=self.device, **run_kw)
        if res.final_population is None:
            raise RuntimeError(
                "search_front needs the converged population to extract "
                "the front, but none came back (a memo record without a "
                "stored population?)")
        front = pareto_front(fit, res.final_population,
                             n_samples=res.n_samples,
                             wall_time_s=res.wall_time_s)
        _count_search(time.perf_counter() - t0, res)
        return front

    def _search_memoized(self, group: JobGroup, strategy, fit: FitnessFn,
                         budget: int, seed: int, run_kw) -> SearchResult:
        """Route one search through the schedule memo: exact hit ->
        bitwise replay (no search, no kernel launch); miss -> warm-seed
        from the nearest same-family scenario, run, record."""
        hit = self.memo.lookup(fit, strategy, budget, seed)
        if hit is not None:
            return hit.to_search_result()
        warm = self.memo.warm_start(fit, strategy, family=group.task)
        if warm is not None:
            run_kw["init_population"] = warm
        run_kw.setdefault("keep_population", True)
        res = run_strategy(strategy, fit, budget=budget, seed=seed,
                           device=self.device, **run_kw)
        self.memo.record(fit, strategy, budget, seed, res,
                         population=res.final_population,
                         family=group.task, warm=warm)
        return res

    def describe_mapping(self, res: SearchResult) -> list:
        return decode_to_lists(res.best_accel, res.best_prio,
                               self.accel.num_sub_accels)


def _count_search(wall_s: float, res: SearchResult) -> None:
    """One finished search into the process registry."""
    reg = get_registry()
    reg.counter("repro_search_total", "Searches M3E ran").inc()
    reg.counter("repro_search_seconds_total",
                "Host wall seconds of M3E's searches").inc(wall_s)
    if res.card_time_s is not None:
        reg.counter("repro_search_card_seconds_total",
                    "Card seconds of M3E's searches' generation loops").inc(
                        res.card_time_s)


def geomean(xs: Sequence[float]) -> float:
    xs = np.asarray(xs, dtype=np.float64)
    return float(np.exp(np.log(np.maximum(xs, 1e-30)).mean()))

"""Shared driver: any ask/tell strategy as one generation loop over rows.

:func:`scan_strategy` is the core every execution path shares: R
independent searches (rows) advance together, one ask -> evaluate ->
fold best -> tell a generation, with the best-so-far fitness, genomes and
history folded per row on the device with ``torch.where`` (strict ``>``,
so each row keeps its earliest best).  Nothing is read back to the host
until the loop ends, so the host only enqueues work while the card runs
it.  The final generation tells only when the sample budget is not yet
exhausted, as in ``repro.core.strategies.driver`` (multi-objective
strategies always tell: their archive is the result).

:func:`run_strategy` is its one-row case, seeded from ``seed`` on the
search's device; ``repro_torch.core.sweep`` runs it over (scenario x
seed) rows.  So a sweep row is a standalone search by construction.
``engine="loop"`` steps the same sequence from the host with one
read-back a generation (:func:`_run_loop`) -- the parity and benchmark
baseline of the device loop, bitwise equal to it.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.encoding import Population, row_generators, take_rows
from repro_torch.core.fitness import (FitnessFn, FitnessParams,
                                      ObjectiveSpec, evaluate_objectives,
                                      evaluate_params)
from repro_torch.core.magma import SearchResult
from repro_torch.core.strategies.base import SearchStrategy


def plan_generations(budget: int, ask_size: int) -> Tuple[int, bool]:
    """(generations, evolve_last) for a sampling budget: floor(budget /
    ask_size) generations, with a final ``tell`` only when that undershoots
    the budget."""
    generations = max(1, budget // ask_size)
    return generations, generations * ask_size < budget


def row_eval_fn(strategy: SearchStrategy, params: FitnessParams,
                objective: Optional[ObjectiveSpec]):
    """(R, P, G) genomes -> (R, P) fitness, or the (R, P, M) objective
    matrix for a multi-objective strategy, over row-stacked ``params``.
    ``objective`` None selects each row's column by its objective code."""
    if getattr(strategy, "multi_objective", False):
        def eval_fn(accel, prio):
            return evaluate_objectives(params, accel, prio,
                                       num_accels=strategy.num_accels,
                                       objective=objective)
    else:
        def eval_fn(accel, prio):
            return evaluate_params(params, accel, prio,
                                   num_accels=strategy.num_accels,
                                   objective=objective)
    return eval_fn


def scan_strategy(strategy: SearchStrategy, state, eval_fn, group_size: int,
                  generations: int, evolve_last: bool):
    """Run ``generations`` ask -> eval -> tell steps over the state's R
    rows on their device.

    Returns ``(best_fit (R,), best_accel (R, G), best_prio (R, G),
    history (R, generations), state)``, all on the device.  For a
    multi-objective strategy ``eval_fn`` returns an (R, P, M) matrix:
    ``tell`` takes all of it and the anytime best tracks column 0.
    """
    mo = getattr(strategy, "multi_objective", False)
    state, accel, prio = strategy.ask(state)
    R, dev = accel.shape[0], accel.device
    bf = torch.full((R,), float("-inf"), dtype=torch.float32, device=dev)
    ba = torch.zeros((R, group_size), dtype=torch.int32, device=dev)
    bp = torch.zeros((R, group_size), dtype=torch.float32, device=dev)
    hist = torch.empty((R, generations), dtype=torch.float32, device=dev)
    for g in range(generations):
        if g:
            state, accel, prio = strategy.ask(state)
        fit = eval_fn(accel, prio)
        col = fit[..., 0] if mo else fit
        i = torch.argmax(col, dim=-1, keepdim=True)          # (R, 1)
        top = torch.gather(col, 1, i)[:, 0]
        better = top > bf
        bf = torch.where(better, top, bf)
        ba = torch.where(better[:, None], take_rows(accel, i)[:, 0], ba)
        bp = torch.where(better[:, None], take_rows(prio, i)[:, 0], bp)
        hist[:, g] = bf
        if g + 1 < generations or evolve_last or mo:
            state = strategy.tell(state, fit)
    return bf, ba, bp, hist, state


def _run_loop(strategy: SearchStrategy, state, eval_fn, generations: int,
              evolve_last: bool):
    """Host-stepped ask/eval/tell loop over one row: the fitness is read
    back every generation and the best folded on the host."""
    mo = getattr(strategy, "multi_objective", False)
    bf, ba, bp = -np.inf, None, None
    hist = []
    for g in range(generations):
        state, accel, prio = strategy.ask(state)
        fit = eval_fn(accel, prio)
        col = (fit[..., 0] if mo else fit)[0].cpu().numpy()
        i = int(np.argmax(col))
        if col[i] > bf:
            bf = float(col[i])
            ba, bp = accel[0, i].cpu().numpy(), prio[0, i].cpu().numpy()
        hist.append(bf)
        if g + 1 < generations or evolve_last or mo:
            state = strategy.tell(state, fit)
    return bf, ba, bp, np.asarray(hist), state


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == \
        (b.index if b.index is not None else current)


def run_strategy(strategy: SearchStrategy, fitness_fn: FitnessFn,
                 budget: int = 10_000, seed: int = 0, *,
                 device: Union[str, torch.device] = "cuda",
                 engine: Optional[str] = None,
                 init_population=None,
                 keep_population: bool = False) -> SearchResult:
    """Run a registered strategy on one problem for ``budget`` samples.

    Device-resident strategies run the generation loop on ``device``
    (``engine="scan"``, the default: nothing read back until the end) or
    step it from the host (``engine="loop"``); both give the same result.
    Host-only strategies run their own loop (``engine`` None or
    ``"host"``), their fitness batches on the fitness' device.
    ``device`` must be where ``fitness_fn`` keeps its tables; the
    generator is seeded from ``seed`` on it, so no draw crosses the bus.
    """
    if not strategy.device_resident:
        if engine not in (None, "host"):
            raise ValueError(
                f"strategy {strategy.name!r} is host-only; engine="
                f"{engine!r} is not available (use None or 'host')")
        if init_population is not None or keep_population:
            raise ValueError(
                f"strategy {strategy.name!r} is host-only; population "
                "hand-off (init_population/keep_population) is not supported")
        return strategy.search(fitness_fn, budget, seed)

    device = torch.device(device)
    if not _same_device(device, fitness_fn.device):
        raise ValueError(f"run_strategy on {device}, but the fitness tables "
                         f"are on {fitness_fn.device}")
    mo = getattr(strategy, "multi_objective", False)
    if fitness_fn.num_objectives > 1 and not mo:
        raise ValueError(
            f"strategy {strategy.name!r} is single-objective but the "
            f"fitness has {fitness_fn.num_objectives} columns "
            f"({fitness_fn.objective_spec.token!r}); use a multi_objective "
            "strategy such as 'nsga2' or a scalar ObjectiveSpec")
    engine = engine or "scan"
    if engine not in ("scan", "loop"):
        raise ValueError(f"unknown engine {engine!r}; expected 'scan' or "
                         "'loop'")
    strategy = strategy.bind(fitness_fn.num_accels)
    generations, evolve_last = plan_generations(budget, strategy.ask_size)
    P, G = strategy.ask_size, fitness_fn.group_size
    params = FitnessParams(*(t[None] for t in fitness_fn.params))
    eval_fn = row_eval_fn(strategy, params, fitness_fn.objective_spec)
    if init_population is not None:
        init_population = Population(*(t[None] for t in init_population))

    t0 = time.perf_counter()
    state = strategy.init(row_generators([seed], device), params,
                          init_population=init_population)
    if engine == "scan":
        bf, ba, bp, hist, state = scan_strategy(
            strategy, state, eval_fn, G, generations, evolve_last)
        best_fitness = float(bf[0].cpu())
        best_accel, best_prio = ba[0].cpu().numpy(), bp[0].cpu().numpy()
        history = hist[0].cpu().numpy().astype(np.float64)
    else:
        best_fitness, best_accel, best_prio, history, state = _run_loop(
            strategy, state, eval_fn, generations, evolve_last)
    wall = time.perf_counter() - t0

    final = None
    if keep_population:
        pop = strategy.population(state)
        final = Population(accel=pop.accel[0], prio=pop.prio[0])
    return SearchResult(
        best_fitness=best_fitness, best_accel=best_accel,
        best_prio=best_prio,
        history_samples=P * np.arange(1, generations + 1),
        history_best=np.asarray(history, dtype=np.float64),
        n_samples=P * generations, wall_time_s=wall,
        final_population=final,
    )

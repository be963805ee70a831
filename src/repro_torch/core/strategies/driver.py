"""Shared driver: any ask/tell strategy as one loop on the search's device.

:func:`run_strategy` runs ``plan_generations(budget, P)`` generations of
ask -> evaluate -> fold best -> tell.  The best-so-far fitness, genomes and
history stay on the device, folded with ``torch.where`` (strict ``>``, so
the earliest best is kept); nothing is read back to the host until the
loop ends, so the host only enqueues work while the card runs it.  The
final generation tells only when the sample budget is not yet exhausted,
as in ``repro.core.strategies.driver``.
"""
from __future__ import annotations

import time
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core.fitness import FitnessFn
from repro_torch.core.magma import SearchResult
from repro_torch.core.strategies.base import SearchStrategy


def plan_generations(budget: int, ask_size: int) -> Tuple[int, bool]:
    """(generations, evolve_last) for a sampling budget: floor(budget /
    ask_size) generations, with a final ``tell`` only when that undershoots
    the budget."""
    generations = max(1, budget // ask_size)
    return generations, generations * ask_size < budget


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
                 init_population=None,
                 keep_population: bool = False) -> SearchResult:
    """Run a registered strategy on one problem for ``budget`` samples.

    ``device`` is where the search runs; it must be where ``fitness_fn``
    keeps its tables.  The generator is seeded from ``seed`` on that
    device, so no draw crosses the bus.
    """
    device = torch.device(device)
    if not _same_device(device, fitness_fn.device):
        raise ValueError(f"run_strategy on {device}, but the fitness tables "
                         f"are on {fitness_fn.device}")
    if fitness_fn.num_objectives > 1:
        raise ValueError(
            f"strategy {strategy.name!r} is single-objective but the "
            f"fitness has {fitness_fn.num_objectives} columns "
            f"({fitness_fn.objective_spec.token!r}); use a scalar "
            "ObjectiveSpec")
    strategy = strategy.bind(fitness_fn.num_accels)
    generations, evolve_last = plan_generations(budget, strategy.ask_size)
    P, G = strategy.ask_size, fitness_fn.group_size
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    t0 = time.perf_counter()
    state = strategy.init(gen, fitness_fn.params,
                          init_population=init_population)
    bf = torch.full((), float("-inf"), dtype=torch.float32, device=device)
    ba = torch.zeros((G,), dtype=torch.int32, device=device)
    bp = torch.zeros((G,), dtype=torch.float32, device=device)
    hist = torch.empty((generations,), dtype=torch.float32, device=device)
    for g in range(generations):
        state, accel, prio = strategy.ask(state)
        fit = fitness_fn(accel, prio)
        i = torch.argmax(fit)
        better = fit[i] > bf
        bf = torch.where(better, fit[i], bf)
        ba = torch.where(better, accel[i], ba)
        bp = torch.where(better, prio[i], bp)
        hist[g] = bf
        if g + 1 < generations or evolve_last:
            state = strategy.tell(state, fit)
    best_fitness = float(bf.cpu())
    best_accel, best_prio = ba.cpu().numpy(), bp.cpu().numpy()
    history = hist.cpu().numpy().astype(np.float64)
    wall = time.perf_counter() - t0

    return SearchResult(
        best_fitness=best_fitness, best_accel=best_accel,
        best_prio=best_prio,
        history_samples=P * np.arange(1, generations + 1),
        history_best=history, n_samples=P * generations, wall_time_s=wall,
        final_population=strategy.population(state)
        if keep_population else None,
    )

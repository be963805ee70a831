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

The loop runs on the static-buffer step of
``repro_torch.core.strategies.graphs``: on a card the whole loop is
captured once per shape as a CUDA graph and replayed, one launch a
search (the reference's one compiled ``lax.scan``, one asynchronous
call); on the CPU the same loop runs eagerly.  A caller that hands the
loop a ``card`` list gets the loop's :class:`cardtime.CardInterval`
(two timing events around it on the card) to settle once it has waited
for the results.

:func:`run_strategy` is its one-row case, seeded from ``seed`` on the
search's device; ``repro_torch.core.sweep`` runs it over (scenario x
seed) rows.  So a sweep row is a standalone search by construction.
``engine="loop"`` steps the same sequence from the host with one
read-back a generation (:func:`_run_loop`) -- the parity and benchmark
baseline of the device loop, bitwise equal to it.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.encoding import Population, row_generators, to_host
from repro_torch.core.fitness import FitnessFn, FitnessParams, ObjectiveSpec
from repro_torch.core.magma import SearchResult
from repro_torch.core.strategies import cardtime, graphs
from repro_torch.core.strategies.base import SearchStrategy, WarmStart
from repro_torch.core.strategies.graphs import row_eval_fn
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.obs.profiler import stage


def plan_generations(budget: int, ask_size: int) -> Tuple[int, bool]:
    """(generations, evolve_last) for a sampling budget: floor(budget /
    ask_size) generations, with a final ``tell`` only when that undershoots
    the budget."""
    generations = max(1, budget // ask_size)
    return generations, generations * ask_size < budget


def scan_steps(strategy: SearchStrategy, state, params: FitnessParams,
               objective: Optional[ObjectiveSpec], group_size: int,
               generations: int, evolve_last: bool, *,
               capture: Optional[bool] = None,
               card: Optional[List[cardtime.CardInterval]] = None):
    """:func:`scan_strategy` as a generator: it yields once each span of
    generations has been issued and returns (``StopIteration.value``)
    what ``scan_strategy`` returns, so one thread can interleave the
    loops of several row shards (:func:`run_interleaved`).

    The loop is one load of a cached ``graphs.GenerationStep``, one run
    of each of its spans (``graphs.plan_spans``: one span of every
    generation, or the strategy's ``graph_span`` generations each) and
    one unload: a span is a replay of its CUDA
    graph (``capture`` True, the default on a card) or its eager body
    (``capture`` False, the default on the CPU).  With a ``card`` list,
    a timing event is recorded before the load and one after the unload
    (on a card, unless the loop captures a graph), and the interval
    appended to ``card`` for the caller to ``cardtime.settle`` once it
    has waited for the results."""
    dev = params.lat.device
    if capture is None:
        capture = dev.type == "cuda"
    elif capture and dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs a card; the rows are on {dev}")
    mo = getattr(strategy, "multi_objective", False)
    spans = graphs.plan_spans(generations, evolve_last or mo,
                              strategy.graph_span)
    step = graphs.checkout(strategy, params, state, objective, group_size)
    try:
        # a loop that captures a graph is set-up: its interval would hold
        # the capture, so it is not timed
        fresh = capture and any(sp not in step.graphs for sp in spans)
        # lint: disable=L002(host metadata: the graphs the step holds)
        timed = None if card is None or fresh else cardtime.begin(dev)
        step.load(state, params)
        if capture:
            step.prepare(spans, state, params)
        hist = torch.empty((step.key.rows, generations), dtype=torch.float32,
                           device=dev)
        g = 0
        for sp in spans:
            hist[:, g:g + sp[0]] = step.run(sp, capture)
            g += sp[0]
            yield
        bf, ba, bp, state = step.unload(graphs.state_gens(state))
        if timed is not None:
            card.append(cardtime.end(timed, generations, sum(
                step.nodes.get(sp, 0) for sp in spans) if capture else 0))
    finally:
        graphs.checkin(step)
    return bf, ba, bp, hist, state


def run_interleaved(loops) -> list:
    """Drive generators such as :func:`scan_steps` one step each in turn
    until all have returned; their return values, in order."""
    loops = list(loops)
    results, live = [None] * len(loops), list(range(len(loops)))
    while live:
        for j in list(live):
            try:
                next(loops[j])
            except StopIteration as stop:
                results[j] = stop.value
                live.remove(j)
    return results


def scan_strategy(strategy: SearchStrategy, state, params: FitnessParams,
                  objective: Optional[ObjectiveSpec], group_size: int,
                  generations: int, evolve_last: bool, *,
                  capture: Optional[bool] = None,
                  card: Optional[List[cardtime.CardInterval]] = None):
    """Run ``generations`` ask -> eval -> tell steps over the state's R
    rows on their device, against the row-stacked tables ``params``
    (``objective`` None: each row's own objective code).  ``card`` is
    :func:`scan_steps`'s.

    Returns ``(best_fit (R,), best_accel (R, G), best_prio (R, G),
    history (R, generations), state)``, all on the device.  For a
    multi-objective strategy the fitness is an (R, P, M) matrix: ``tell``
    takes all of it and the anytime best tracks column 0.
    """
    return run_interleaved([scan_steps(strategy, state, params, objective,
                                       group_size, generations, evolve_last,
                                       capture=capture, card=card)])[0]


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
            graphs.count_tells(strategy.name, accel.device, 1)
    return bf, ba, bp, np.asarray(hist), state


def rows_hand_off(init_population, device):
    """A one-search hand-off (a ``Population`` or a ``WarmStart``, host
    arrays or tensors) as the one-row state ``init`` takes: every field
    with a leading row axis, on ``device``."""
    accel = torch.as_tensor(init_population[0], dtype=torch.int32,
                            device=device)[None]
    prio = torch.as_tensor(init_population[1], dtype=torch.float32,
                           device=device)[None]
    if isinstance(init_population, WarmStart):
        jitter = torch.as_tensor(init_population.jitter, dtype=torch.float32,
                                 device=device).reshape(1)
        return WarmStart(accel=accel, prio=prio, jitter=jitter)
    return Population(accel=accel, prio=prio)


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
                 keep_population: bool = False,
                 tracer: Optional[Tracer] = None) -> SearchResult:
    """Run a registered strategy on one problem for ``budget`` samples.

    Device-resident strategies run the generation loop on ``device``
    (``engine="scan"``, the default: nothing read back until the end; on
    a card the whole loop one replay of its captured CUDA graph) or
    step it from the host (``engine="loop"``); both give the same result.
    Host-only strategies run their own loop (``engine`` None or
    ``"host"``), their fitness batches on the fitness' device.
    ``device`` must be where ``fitness_fn`` keeps its tables; the
    generator is seeded from ``seed`` on it, so no draw crosses the bus.
    ``init_population`` is a ``Population`` (used verbatim) or a
    ``WarmStart`` (seeded in ``init``), for strategies with
    ``supports_init_population``.  ``tracer`` (a ``repro_torch.obs``
    ``Tracer``) takes a device-resident search's ``search.loop``,
    ``search.readback`` and ``search.card`` spans; the result's
    ``card_time_s`` is its loop's time on the card (timing events), None
    where nothing ran there.
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
    return _search(strategy, fitness_fn, budget, seed, device, engine,
                   init_population, keep_population, tracer=tracer)


def _search(strategy: SearchStrategy, fitness_fn: FitnessFn, budget: int,
            seed: int, device: torch.device, engine: str, init_population,
            keep_population: bool,
            capture: Optional[bool] = None,
            tracer: Optional[Tracer] = None) -> SearchResult:
    """:func:`run_strategy`'s device-resident search, its arguments
    checked.  ``capture`` is ``scan_steps``'s: False runs the generation
    step eagerly on a card too (the uncaptured baseline of the captured
    engine, which ``chip_smoke.py`` times).  The loop's card interval is
    settled after the read-back, which waits for it; ``search.card``
    ends where the read-back returned."""
    tracer = NULL_TRACER if tracer is None else tracer
    strategy = strategy.bind(fitness_fn.num_accels)
    generations, evolve_last = plan_generations(budget, strategy.ask_size)
    P, G = strategy.ask_size, fitness_fn.group_size
    params = FitnessParams(*(t[None] for t in fitness_fn.params))
    objective = fitness_fn.objective_spec
    if init_population is not None:
        init_population = rows_hand_off(init_population, device)

    t0 = time.perf_counter()
    state = strategy.init(row_generators([seed], device), params,
                          init_population=init_population)
    card_time = None
    if engine == "scan":
        card: List[cardtime.CardInterval] = []
        with stage("search.loop", tracer):
            bf, ba, bp, hist, state = scan_strategy(
                strategy, state, params, objective, G, generations,
                evolve_last, capture=capture, card=card)
        with stage("search.readback", tracer):
            bf, ba, bp, hist = to_host(bf, ba, bp, hist)
        card_time = cardtime.settle(card)
        if card_time is not None and tracer.enabled:
            t = tracer.now()
            tracer.emit("search.card", t - card_time, t)
        best_fitness, best_accel, best_prio = float(bf[0]), ba[0], bp[0]
        history = hist[0].astype(np.float64)
    else:
        best_fitness, best_accel, best_prio, history, state = _run_loop(
            strategy, state, row_eval_fn(strategy, params, objective),
            generations, evolve_last)
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
        final_population=final, card_time_s=card_time,
    )

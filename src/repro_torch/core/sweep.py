"""Scenario sweeps — (strategy, scenario x seed) search grids as batched
rows, sharded over cards and streamed in chunks.

The paper's headline experiments (Fig. 8/9/11/13/17, Table IV) are grids
of many independent searches: S stacked scenario tables (same ``(G, A)``,
different ``lat``/``bw``/``bw_sys``/objective) x K seeds, times a method
axis for the comparison figures.  Any **device-resident**
``repro_torch.core.strategies`` strategy rides this machinery
(``run_sweep(strategy=...)``; MAGMA is the default):

  1. the grid is flattened to ``N = S*K`` rows -- row ``s*K + k`` is
     scenario ``s`` with seed ``seeds[k]`` -- and each chunk of rows runs
     the shared generation loop (``strategies.scan_strategy``) once for
     all its rows: one body, and one makespan-kernel launch, per
     generation and chunk, where R sequential searches would issue them R
     times; on a card the chunk's whole loop is one replay of a CUDA
     graph captured for its shape (``strategies.graphs``).  Each row
     keeps its own generator, seeded with its seed, and draws its slice
     of every random tensor from it;
  2. with several devices each chunk's rows are split into contiguous
     shards, one a device (the rows ``shard_map`` would give it in the
     reference), each with its tables, seeds, generators and warm starts
     on its device.  One thread issues the shards' loops in turn (on a
     card one replay each), with no sync between them, and the
     results are gathered to the host in row order.  Rows carry no
     collective;
  3. grids larger than ``chunk_rows`` stream through in chunks; chunk
     i+1's tables are copied to the cards from pinned memory on a side
     stream a card while chunk i computes.

Rows are padded (by repeating the last real row: its tables, and a
generator of its own seeded with its seed) so every chunk has the same
shape and a multiple of the device count of rows, and padding is sliced
off before results reshape back to ``(S, K)``.  Every row is bitwise a
standalone ``run_strategy`` with the same scenario and seed, whatever the
chunking or the device count: nothing in the loop mixes rows, and the
makespan kernel gives an individual's makespan from its own queues and
its row's ``bw_sys`` only, whatever the population size.

``run_sweep(memo=...)`` records every solved row in a
``repro_torch.memo.ScheduleMemo`` (the schedule and, for strategies with
a population hand-off, the converged population, read back with the
chunk's results), so a later ``M3E.search`` or ``lookup`` of the same
(scenario, seed) replays it; ``run_rows(warm=...)`` seeds every row from
its own ``WarmStart``.  Neither changes the search a row runs.

``SweepConfig(transfer_guard=True)`` issues every chunk (its copies to
the card and its generation loop) under
``repro_torch.lint.runtime.transfer_sanitizer``, so a hidden
host<->device synchronisation on the hot path raises; the chunk's
read-back, a synchronisation by nature, runs after the guarded region.
``SweepConfig(obs=...)`` emits one ``sweep.chunk`` span per chunk on the
process tracer (``repro_torch.obs.get_tracer``).  Neither changes a row.
Each shard's loop is timed on the card (``strategies.cardtime``) and
settled after the chunk's read-back.

The devices are every visible card (``cuda:0`` .. ``cuda:n-1``) for
``device="cuda"``, the one device otherwise, or the explicit list
``SweepConfig(devices=...)``; ``max_devices`` caps their number.  A list
may name one device several times (two shards on one card, or on the
CPU): that is how the split is tested without several cards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.encoding import row_generators, to_host
from repro_torch.core.fitness import (FitnessFn, FitnessParams,
                                      ObjectiveSpec, as_objective_spec,
                                      normalize_scenarios)
from repro_torch.core.magma import BatchSearchResult, MagmaConfig
from repro_torch.core.strategies import (MagmaStrategy, SearchStrategy,
                                         WarmStart, available, cardtime,
                                         get_strategy, plan_generations)
from repro_torch.core.strategies.driver import run_interleaved, scan_steps
from repro_torch.lint.runtime import transfer_sanitizer
from repro_torch.obs import NULL_TRACER, as_obs_config, get_tracer
from repro_torch.obs.profiler import stage


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """How a scenario grid is partitioned over time.

    chunk_rows     max (scenario, seed) rows per chunk; None runs the
                   whole grid as one chunk.  Rounded up to a multiple of
                   the device count, so every shard is dense.
    max_devices    shard rows over at most this many devices (None: all
                   of ``devices``)
    devices        the devices to shard over, in shard order (None: every
                   visible card for a ``cuda`` device without an index,
                   else the one device)
    transfer_guard run each chunk's copies and generation loop under
                   ``repro_torch.lint.runtime.transfer_sanitizer``: a
                   synchronisation inside them raises (the read-back after
                   each chunk runs outside the guard)
    obs            observability (``repro_torch.obs.ObsConfig``, a dict of
                   its fields, or None = off): enabled, each chunk emits
                   a ``sweep.chunk`` span (chunk, rows, devices) on the
                   process tracer
    """
    chunk_rows: Optional[int] = None
    max_devices: Optional[int] = None
    devices: Optional[Tuple[Union[str, torch.device], ...]] = None
    transfer_guard: bool = False
    obs: object = None


def shard_devices(max_devices: Optional[int],
                  device: Union[str, torch.device],
                  devices: Optional[Sequence] = None
                  ) -> Tuple[torch.device, ...]:
    """The devices rows shard over: ``devices`` when given, else every
    visible card (``cuda:0`` .. ``cuda:n-1``) for a ``cuda`` device
    without an index, else ``device`` itself; at most ``max_devices`` of
    them (None: all)."""
    device = torch.device(device)
    if devices is None:
        if device.type == "cuda" and device.index is None:
            devices = [torch.device("cuda", i)
                       for i in range(max(torch.cuda.device_count(), 1))]
        else:
            devices = [device]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("shard over at least one device")
    n = len(devices) if max_devices is None else max(1, min(max_devices,
                                                             len(devices)))
    return devices[:n]


def split_rows(tensors: Sequence[torch.Tensor], n: int) -> List[tuple]:
    """Each tensor's rows in ``n`` contiguous equal parts: one tuple of
    parts a shard."""
    return list(zip(*(torch.chunk(x, n) for x in tensors))) if tensors \
        else [()] * n


def host_rows(shard_outs: Sequence[tuple]) -> Tuple[np.ndarray, ...]:
    """Per-shard result tuples (each on its device) read back, one copy a
    shard, and joined in row order."""
    parts = [to_host(*out) for out in shard_outs]
    return tuple(np.concatenate(col) for col in zip(*parts))


@dataclasses.dataclass
class SweepResult(BatchSearchResult):
    """BatchSearchResult plus how the grid was executed."""
    num_devices: int = 1
    rows: int = 0                  # real (scenario, seed) rows
    padded_rows: int = 0           # rows actually computed (incl. padding)
    chunk_rows: int = 0            # rows per chunk
    chunk_wall_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_wall_s)

    @property
    def generations(self) -> int:
        return int(self.history_samples.shape[0])

    def gens_per_sec(self) -> List[float]:
        """Aggregate generations/second per chunk (all rows of the chunk
        advance one generation together)."""
        return [self.chunk_rows * self.generations / max(w, 1e-12)
                for w in self.chunk_wall_s]


def _row_steps(seeds: Sequence[int], params: FitnessParams,
               strategy: SearchStrategy, generations: int,
               evolve_last: bool, group_size: int,
               objective: Optional[ObjectiveSpec], device,
               keep_population: bool = False,
               warm: Optional[WarmStart] = None,
               card: Optional[list] = None):
    """R (scenario, seed) rows on ``device`` (``params`` stacked there) --
    the trace of ``run_strategy``: seed each row's generator, init, run
    the shared loop -- as a generator that yields once each span of
    generations (on a card, the whole loop's replay) is issued.
    Returns ``(best_fit (R,), best_accel (R, G), best_prio (R, G),
    history (R, T))`` on the device, and with ``keep_population``
    also the converged ``(pop_accel (R, P, G), pop_prio (R, P, G))``.
    ``warm`` is a per-row ``WarmStart`` (leading R, on the device)
    seeding each row's initial population in ``init``; neither option
    changes the search a row runs.  ``card`` is ``scan_steps``'s."""
    state = strategy.init(row_generators(seeds, device), params,
                          init_population=warm)
    out = yield from scan_steps(strategy, state, params, objective,
                                group_size, generations, evolve_last,
                                card=card)
    if keep_population:
        pop = strategy.population(out[4])
        return out[:4] + (pop.accel, pop.prio)
    return out[:4]


def row_executable(strategy: SearchStrategy, generations: int,
                   evolve_last: bool, group_size: int, objective,
                   devices: Sequence[Union[str, torch.device]] = ("cuda",),
                   keep_population: bool = False):
    """(row-batch fn, devices): ``fn(seeds (N,), shards, warm=None,
    card=None)``, where ``shards`` holds one ``FitnessParams`` a device
    (the rows split contiguously, ``N / len(devices)`` each, on that
    device), ``warm`` likewise one ``WarmStart`` a device or None and
    ``card`` a list that takes each shard's card interval (``scan_steps``),
    returns one tuple of per-row results a shard, on its device, without
    a sync.  The shards'
    loops are issued from this thread in turn: on a card one load, one
    replay of the loop's graph and one unload a shard.  The function
    ``run_sweep`` runs each chunk through.  ``keep_population`` appends
    the converged populations to the outputs; ``warm`` seeds each row."""
    objective = as_objective_spec(objective)
    if getattr(strategy, "multi_objective", False) and objective is None:
        raise ValueError(
            f"strategy {strategy.name!r} is multi_objective and needs a "
            "static ObjectiveSpec shared by every row; the dynamic "
            "per-row objective_code select is scalar-only")
    devices = tuple(torch.device(d) for d in devices)

    def fn(seeds, shards, warm=None, card=None):
        n = len(devices)
        seeds = np.asarray(seeds)
        per = seeds.shape[0] // n
        return run_interleaved(
            _row_steps(seeds[d * per:(d + 1) * per], shards[d], strategy,
                       generations, evolve_last, group_size, objective,
                       devices[d], keep_population,
                       None if warm is None else warm[d], card)
            for d in range(n))
    return fn, devices


def _flatten_grid(params: FitnessParams, seeds: np.ndarray):
    """(S scenarios, K seeds) -> N=S*K host rows, scenario-major: each
    scenario's tables repeated per seed."""
    S, K = int(params.lat.shape[0]), int(seeds.shape[0])
    rows = FitnessParams(*(torch.repeat_interleave(x, K, dim=0)
                           for x in params))
    return rows, np.tile(seeds, S), S * K


def _pad_rows(rows_params: FitnessParams, rows_seeds: np.ndarray,
              total: int, warm: Optional[WarmStart] = None):
    """Pad to ``total`` rows by repeating the last real row (its tables,
    its seed and its warm start: the padding simulates cleanly, from a
    generator of its own, and its results are sliced off)."""
    pad = total - rows_seeds.shape[0]
    if pad <= 0:
        return rows_params, rows_seeds, warm

    def rep(x):
        return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
    return (FitnessParams(*(rep(x) for x in rows_params)),
            np.concatenate([rows_seeds, np.repeat(rows_seeds[-1:], pad)]),
            None if warm is None else WarmStart(*(rep(x) for x in warm)))


def _host_warm(warm: Optional[WarmStart], N: int) -> Optional[WarmStart]:
    """Per-row warm starts as host tensors: accel (N, P, G) int32, prio
    (N, P, G) f32, jitter (N,) f32."""
    if warm is None:
        return None
    accel = torch.as_tensor(warm.accel, dtype=torch.int32).cpu()
    prio = torch.as_tensor(warm.prio, dtype=torch.float32).cpu()
    jitter = torch.as_tensor(warm.jitter, dtype=torch.float32).cpu()
    if accel.dim() != 3 or accel.shape[0] != N or prio.shape != accel.shape:
        raise ValueError(f"warm must hold one (P, G) population per row "
                         f"({N}); got accel {tuple(accel.shape)}, prio "
                         f"{tuple(prio.shape)}")
    return WarmStart(accel=accel, prio=prio,
                     jitter=jitter.expand(N).contiguous())


def _resolve_strategy(strategy, cfg: Optional[MagmaConfig]) -> SearchStrategy:
    """``strategy`` may be None (MAGMA, configured by ``cfg``), a registry
    name, or a ``SearchStrategy`` instance (then ``cfg`` must be None —
    instances carry their own config)."""
    if strategy is None:
        return MagmaStrategy(cfg or MagmaConfig())
    if isinstance(strategy, str):
        if cfg is not None:
            return get_strategy(strategy, cfg=cfg)   # magma accepts cfg;
        return get_strategy(strategy)                # others reject it clearly
    if not isinstance(strategy, SearchStrategy):
        raise ValueError(f"strategy must be None, a registry name, or a "
                         f"SearchStrategy; got {type(strategy).__name__}")
    if cfg is not None:
        raise ValueError("pass cfg only with the default MAGMA strategy (or "
                         "strategy='magma'); strategy instances carry their "
                         "own config")
    return strategy


@dataclasses.dataclass
class RowsResult:
    """Per-row results of :func:`run_rows` (leading axis: the N real rows),
    plus how the batch was executed.  ``run_sweep`` reshapes this into the
    ``(S, K)`` grid view."""
    best_fitness: np.ndarray       # (N,)
    best_accel: np.ndarray         # (N, G)
    best_prio: np.ndarray          # (N, G)
    history_best: np.ndarray       # (N, T)
    generations: int
    wall_time_s: float
    num_devices: int = 1
    rows: int = 0
    padded_rows: int = 0
    chunk_rows: int = 0
    chunk_wall_s: List[float] = dataclasses.field(default_factory=list)


def run_rows(rows_params: FitnessParams, rows_seeds, *,
             strategy: SearchStrategy, generations: int, evolve_last: bool,
             objective: Optional[ObjectiveSpec] = None,
             sweep: SweepConfig | None = None,
             device: Union[str, torch.device] = "cuda",
             warm: Optional[WarmStart] = None,
             memo=None, rows_family: Optional[Sequence[str]] = None
             ) -> RowsResult:
    """Execute N independent (scenario, seed) search rows on ``device``.

    ``rows_params`` is a ``FitnessParams`` with leading axis N on the
    host (chunks are copied to the card as they run); ``rows_seeds`` is
    (N,).  ``strategy`` must already be bound to the scenarios'
    accelerator count.  Rows are padded to equal chunks by repeating the
    last real row and the padding is sliced off, so row ``i`` of the
    result is bitwise a standalone ``run_strategy`` with that scenario
    and seed (and ``warm[i]`` as its ``init_population``), whatever the
    chunking or which rows share a chunk.

    ``warm`` is a ``WarmStart`` with leading axis N (host arrays or
    tensors; the jitter one value or one per row) seeding every row.
    ``memo`` (a ``repro_torch.memo.ScheduleMemo``) records every solved
    row — the schedule plus, for strategies with a population hand-off,
    the converged population — under its fingerprint once the chunks
    have run; ``rows_family`` tags each row's transfer family.  Recording
    adds outputs to the chunk, never changes a row's search.
    """
    sweep = sweep or SweepConfig()
    device = torch.device(device)
    rows_seeds = np.asarray(rows_seeds, dtype=np.int64)
    N = int(rows_seeds.shape[0])
    G = int(rows_params.lat.shape[-2])
    # never more shards than real rows
    devices = shard_devices(sweep.max_devices, device, sweep.devices)[:N]
    ndev = len(devices)
    warm = _host_warm(warm, N)

    chunk_rows = N if sweep.chunk_rows is None else max(1, sweep.chunk_rows)
    chunk_rows = min(chunk_rows, N)
    chunk_rows = -(-chunk_rows // ndev) * ndev        # dense shards
    n_chunks = -(-N // chunk_rows)
    padded = n_chunks * chunk_rows   # the last partial chunk is padded
    rows_params, rows_seeds, warm = _pad_rows(rows_params, rows_seeds,
                                              padded, warm)
    keep_pop = memo is not None and strategy.supports_init_population
    fn, _ = row_executable(strategy, generations, evolve_last, G, objective,
                           devices, keep_population=keep_pop)
    # the tensors each chunk copies to the devices: the tables, then the
    # warm starts' fields
    host = tuple(rows_params) + (() if warm is None else tuple(warm))
    n_params = len(rows_params)

    cuda = devices[0].type == "cuda"
    sides = {d: torch.cuda.Stream(d) for d in set(devices)} if cuda else {}
    if cuda:     # pinned host rows: the copies below run asynchronously
        host = tuple(x.pin_memory() for x in host)

    def put_chunk(i):
        """Chunk i's tensors, one (tensors, copy-done event) a shard on its
        device; on a card, copied on that card's side stream."""
        sl = slice(i * chunk_rows, (i + 1) * chunk_rows)
        shards = split_rows(tuple(x[sl] for x in host), ndev)
        if not cuda:
            return [(xs, None) for xs in shards]
        out = []
        for d, xs in zip(devices, shards):
            with torch.cuda.stream(sides[d]):
                xs = tuple(x.to(d, non_blocking=True) for x in xs)
                out.append((xs, sides[d].record_event()))
        return out

    tracer = (get_tracer() if as_obs_config(sweep.obs).enabled
              else NULL_TRACER)
    guard = sweep.transfer_guard and cuda

    t0 = time.perf_counter()
    outs, walls = [], []
    with transfer_sanitizer(guard):
        buf = put_chunk(0)
    for i in range(n_chunks):
        tc = time.perf_counter()
        card: List[cardtime.CardInterval] = []
        with stage("sweep.chunk", tracer, chunk=i, rows=chunk_rows,
                   devices=ndev):
            with transfer_sanitizer(guard):
                for d, (xs, done) in zip(devices, buf):
                    if done is not None:
                        stream = torch.cuda.current_stream(d)
                        stream.wait_event(done)
                        for x in xs:
                            x.record_stream(stream)
                out = fn(rows_seeds[i * chunk_rows:(i + 1) * chunk_rows],
                         [FitnessParams(*xs[:n_params]) for xs, _ in buf],
                         None if warm is None else
                         [WarmStart(*xs[n_params:]) for xs, _ in buf],
                         card)
                # the next chunk's copy overlaps this chunk's generations
                buf = put_chunk(i + 1) if i + 1 < n_chunks else None
            # the chunk's results, one copy a shard: a synchronisation,
            # so outside the guard
            outs.append(host_rows(out))
            cardtime.settle(card)
        walls.append(time.perf_counter() - tc)
    wall = time.perf_counter() - t0

    def gather(j):
        return np.concatenate([o[j] for o in outs])[:N]

    rr = RowsResult(
        best_fitness=gather(0), best_accel=gather(1), best_prio=gather(2),
        history_best=gather(3).astype(np.float64), generations=generations,
        wall_time_s=wall, num_devices=ndev, rows=N, padded_rows=padded,
        chunk_rows=chunk_rows, chunk_wall_s=walls)
    if memo is not None:
        _record_rows(memo, rr, rows_params, rows_seeds, strategy,
                     generations, evolve_last, objective, device,
                     rows_family, (gather(4), gather(5)) if keep_pop
                     else None, warm is not None)
    return rr


def _record_rows(memo, rr: RowsResult, rows_params: FitnessParams,
                 rows_seeds: np.ndarray, strategy: SearchStrategy,
                 generations: int, evolve_last: bool,
                 objective: Optional[ObjectiveSpec], device: torch.device,
                 rows_family: Optional[Sequence[str]], pops,
                 warm: bool) -> None:
    """Feed every solved row into the schedule memo, from the host copies
    of the results.  The sampling budget is reconstructed from
    (generations, evolve_last): the fingerprint depends only on that
    pair, so any budget that plans to the same protocol shares the
    entry."""
    from repro_torch.memo.engine import row_view
    P = strategy.ask_size
    budget = generations * P + int(evolve_last)
    for i in range(rr.rows):
        fit = row_view(FitnessParams(*(x[i] for x in rows_params)),
                       num_accels=strategy.num_accels, objective=objective,
                       device=device)
        memo.record(
            fit, strategy, budget, int(rows_seeds[i]),
            {"best_fitness": rr.best_fitness[i],
             "best_accel": rr.best_accel[i],
             "best_prio": rr.best_prio[i],
             "history_best": rr.history_best[i]},
            population=(pops[0][i], pops[1][i]) if pops is not None else None,
            family="" if rows_family is None else rows_family[i],
            warm=True if warm else None)


def run_sweep(scenarios: Union[Sequence[FitnessFn], FitnessParams],
              budget: int = 10_000,
              cfg: MagmaConfig | None = None,
              seeds: Sequence[int] = (0,),
              num_accels: Optional[int] = None,
              sweep: SweepConfig | None = None,
              strategy: Union[SearchStrategy, str, None] = None,
              memo=None,
              memo_family: Union[str, Sequence[str]] = "", *,
              device: Union[str, torch.device] = "cuda") -> SweepResult:
    """Run an S x K (scenario x seed) search grid as batched rows on
    ``device``.

    ``scenarios``/``num_accels`` follow ``magma_search_batch`` (which is
    a thin wrapper over this).  ``strategy`` selects the optimizer: None
    runs MAGMA (configured by ``cfg``), a registry name or any
    device-resident ``SearchStrategy`` runs that method instead.
    Host-only strategies are rejected with a ``ValueError``.  Results
    come back with ``(S, K)`` leading axes and row ``[s, k]`` bitwise
    equal to a standalone ``run_strategy(strategy, scenarios[s],
    seed=seeds[k])`` on the same device, whatever the chunking
    (``sweep``, :class:`SweepConfig`).

    ``memo`` (a ``repro_torch.memo.ScheduleMemo``) records every solved
    row for exact-hit replay / warm-start transfer; ``memo_family`` tags
    the rows' transfer family — one string for the whole grid or one per
    scenario.
    """
    params, num_accels, objective = normalize_scenarios(scenarios,
                                                        num_accels)
    strategy = _resolve_strategy(strategy, cfg)
    if not strategy.device_resident:
        raise ValueError(
            f"strategy {strategy.name!r} is host-only and cannot ride the "
            f"device-resident sweep; run it per problem via run_strategy/"
            f"M3E.search, or pick one of "
            f"{', '.join(available(device_resident=True))}")
    strategy = strategy.bind(num_accels)
    S = int(params.lat.shape[0])
    G = int(params.lat.shape[-2])
    P = strategy.ask_size
    generations, evolve_last = plan_generations(budget, P)

    seeds = np.asarray(list(seeds), dtype=np.int64)
    rows_params, rows_seeds, N = _flatten_grid(params, seeds)
    if isinstance(memo_family, str):
        rows_family = [memo_family] * N
    else:                    # one family per scenario, repeated per seed
        memo_family = list(memo_family)
        if len(memo_family) != S:
            raise ValueError(
                f"memo_family must be one string or one per scenario "
                f"({S}); got {len(memo_family)}")
        rows_family = [f for f in memo_family for _ in seeds]
    rr = run_rows(rows_params, rows_seeds, strategy=strategy,
                  generations=generations, evolve_last=evolve_last,
                  objective=objective, sweep=sweep, device=device,
                  memo=memo, rows_family=rows_family)

    def grid(x, trailing):
        return x.reshape((S, len(seeds)) + trailing)

    return SweepResult(
        best_fitness=grid(rr.best_fitness, ()),
        best_accel=grid(rr.best_accel, (G,)),
        best_prio=grid(rr.best_prio, (G,)),
        history_samples=P * np.arange(1, generations + 1),
        history_best=grid(rr.history_best, (generations,)),
        n_samples=P * generations,
        wall_time_s=rr.wall_time_s,
        seeds=seeds,
        num_devices=rr.num_devices,
        rows=N,
        padded_rows=rr.padded_rows,
        chunk_rows=rr.chunk_rows,
        chunk_wall_s=rr.chunk_wall_s,
    )

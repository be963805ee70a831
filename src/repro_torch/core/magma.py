"""MAGMA — Multi-Accelerator Genetic Mapping Algorithm (Section V).

GA over the M3E encoding with the paper's four operators:

  mutation        (rate 0.05 per gene)  random re-draw of selected genes
  crossover-gen   (rate 0.90)  single-pivot crossover of ONE genome
                  (accel-selection OR job-priority), leaving the other intact
  crossover-rg    (rate 0.05)  the same index range of BOTH genomes is taken
                  from the second parent — preserves per-job cross-genome
                  dependency
  crossover-accel (rate 0.05)  one parent's complete per-core schedule (job
                  set + ordering for a sampled sub-accelerator) is copied
                  into the child; displaced jobs are randomly re-assigned
                  for load balance

Population = group size (paper default 100); sampling budget 10K points =
100 generations.

A generation is split in two: :func:`draw_generation` draws every random
tensor a generation needs from a ``torch.Generator`` (the 12 draws of
``repro.core.magma._next_generation_body``, with the same shapes, ranges
and dtypes), and :func:`next_generation_body` is the deterministic rest.
A test can therefore feed the body the reference's own random draws.
Both take a leading row axis: :func:`draw_generation_rows` fills each
row's slice from that row's generator, and the body runs once over R
independent populations.  The single-child operators (``_mutate``,
``_crossover_gen``, ``_crossover_rg``, ``_crossover_accel``,
``_make_child``) are the executable spec of the batched body, with their
draws passed in.

Engines: ``magma_search`` runs the shared strategy driver
(``repro_torch.core.strategies.run_strategy``) on the search's device,
reading nothing back to the host until the last generation is done
(``engine="scan"``, the default), or steps it from the host with one
read-back a generation (``engine="loop"``); both give the same result for
a seed.  ``magma_search_batch`` runs an S x K (scenario x seed) grid
through ``repro_torch.core.sweep.run_sweep``, whose row [s, k] is bitwise
the standalone search of scenario s with seed ``seeds[k]``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.encoding import (Population, rand_rows, randint_rows,
                                       take_rows)
from repro_torch.core.fitness import FitnessFn, FitnessParams


@dataclasses.dataclass(frozen=True)
class MagmaConfig:
    population: int = 100
    elite_frac: float = 0.10
    mutation_rate: float = 0.05
    p_crossover_gen: float = 0.90
    p_crossover_rg: float = 0.05
    p_crossover_accel: float = 0.05
    # ablation switches (Fig. 16)
    enable_crossover_gen: bool = True
    enable_crossover_rg: bool = True
    enable_crossover_accel: bool = True

    @property
    def n_elite(self) -> int:
        return max(1, int(round(self.elite_frac * self.population)))


@dataclasses.dataclass
class SearchResult:
    best_fitness: float
    best_accel: np.ndarray
    best_prio: np.ndarray
    history_samples: np.ndarray    # cumulative evaluations
    history_best: np.ndarray       # best-so-far fitness
    n_samples: int
    wall_time_s: float
    final_population: Optional[Population] = None


@dataclasses.dataclass
class BatchSearchResult:
    """Batched searches: leading axes are (scenario S, seed K)."""
    best_fitness: np.ndarray       # (S, K)
    best_accel: np.ndarray         # (S, K, G)
    best_prio: np.ndarray          # (S, K, G)
    history_samples: np.ndarray    # (T,) cumulative evaluations (shared)
    history_best: np.ndarray       # (S, K, T)
    n_samples: int                 # per search
    wall_time_s: float             # whole batch
    seeds: np.ndarray              # (K,)

    @property
    def num_scenarios(self) -> int:
        return self.best_fitness.shape[0]

    def result(self, scenario: int = 0, seed_index: int = 0) -> SearchResult:
        """Materialize one (scenario, seed) row as a host SearchResult."""
        return SearchResult(
            best_fitness=float(self.best_fitness[scenario, seed_index]),
            best_accel=np.asarray(self.best_accel[scenario, seed_index]),
            best_prio=np.asarray(self.best_prio[scenario, seed_index]),
            history_samples=self.history_samples,
            history_best=np.asarray(self.history_best[scenario, seed_index],
                                    dtype=np.float64),
            n_samples=self.n_samples,
            wall_time_s=self.wall_time_s,
        )


class GenerationDraws(NamedTuple):
    """The random tensors of one generation (n = number of children)."""
    dads: torch.Tensor        # (n,)   int32 in [0, n_elite)
    moms: torch.Tensor        # (n,)   int32 in [0, n_elite)
    u_op: torch.Tensor        # (n,)   f32 in [0, 1): operator choice
    which: torch.Tensor       # (n, 1) bool: crossover-gen takes prio
    pivot: torch.Tensor       # (n, 1) int32 in [1, max(G, 2))
    ra: torch.Tensor          # (n, 1) int32 in [0, G): crossover-rg ends
    rb: torch.Tensor          # (n, 1) int32 in [0, G)
    a_sel: torch.Tensor       # (n, 1) int32 in [0, A): crossover-accel core
    rebalance: torch.Tensor   # (n, G) int32 in [0, A): displaced jobs' cores
    u_mut: torch.Tensor       # (n, G) f32 in [0, 1): mutation mask draw
    mut_accel: torch.Tensor   # (n, G) int32 in [0, A)
    mut_prio: torch.Tensor    # (n, G) f32 in [0, 1)


def draw_generation_rows(gens: Sequence[torch.Generator], n_child: int,
                         G: int, A: int, cfg: MagmaConfig) -> GenerationDraws:
    """One generation's random tensors for R rows, (R, ...) each: row r
    drawn from ``gens[r]`` in the order a single row draws them."""
    n_elite = cfg.n_elite
    return GenerationDraws(
        dads=randint_rows(gens, 0, n_elite, (n_child,)),
        moms=randint_rows(gens, 0, n_elite, (n_child,)),
        u_op=rand_rows(gens, (n_child,)),
        which=rand_rows(gens, (n_child, 1)) < 0.5,
        pivot=randint_rows(gens, 1, max(G, 2), (n_child, 1)),
        ra=randint_rows(gens, 0, G, (n_child, 1)),
        rb=randint_rows(gens, 0, G, (n_child, 1)),
        a_sel=randint_rows(gens, 0, A, (n_child, 1)),
        rebalance=randint_rows(gens, 0, A, (n_child, G)),
        u_mut=rand_rows(gens, (n_child, G)),
        mut_accel=randint_rows(gens, 0, A, (n_child, G)),
        mut_prio=rand_rows(gens, (n_child, G)),
    )


def draw_generation(gen: torch.Generator, n_child: int, G: int, A: int,
                    cfg: MagmaConfig) -> GenerationDraws:
    """Draw one generation's random tensors from ``gen`` on its device
    (the one-row case of :func:`draw_generation_rows`)."""
    return GenerationDraws(*(d[0] for d in draw_generation_rows(
        (gen,), n_child, G, A, cfg)))


@functools.lru_cache(maxsize=32)
def _operator_cdf(cfg: MagmaConfig, device: torch.device) -> torch.Tensor:
    """The operator mix's CDF, computed in float64 and cast to float32
    exactly as the reference does.  Cached per (cfg, device) so that a
    generation copies nothing from the host; callers never mutate it.
    The one copy is issued without a sync, so even the first generation
    on a card runs clean under ``lint.runtime.transfer_sanitizer``."""
    probs = np.array(
        [cfg.p_crossover_gen if cfg.enable_crossover_gen else 0.0,
         cfg.p_crossover_rg if cfg.enable_crossover_rg else 0.0,
         cfg.p_crossover_accel if cfg.enable_crossover_accel else 0.0])
    probs = np.concatenate([probs, [max(1.0 - probs.sum(), 0.0)]])
    return torch.as_tensor(np.cumsum(probs / probs.sum()),
                           dtype=torch.float32).to(device, non_blocking=True)


def next_generation_body(accel: torch.Tensor, prio: torch.Tensor,
                         fitness: torch.Tensor, draws: GenerationDraws,
                         cfg: MagmaConfig, num_accels: int, n_elite: int):
    """Elitism + brood generation, given the draws.

    Genomes are (P, G) with (P,) fitness and unbatched draws, or R rows:
    (R, P, G) genomes, (R, P) fitness and (R, ...) draws; every operation
    stays within its row.  Deterministic: every random number comes from
    ``draws``.  Returns the next ``(accel, prio)``, elites first.
    ``num_accels`` is kept for parity with the reference signature; the
    draws already carry its range.
    """
    del num_accels
    if accel.dim() == 2:
        a, p = next_generation_body(
            accel[None], prio[None], fitness[None],
            GenerationDraws(*(d[None] for d in draws)), cfg, 0, n_elite)
        return a[0], p[0]
    G = accel.shape[-1]
    order = torch.argsort(-fitness, dim=-1, stable=True)
    elite_idx = order[:, :n_elite]
    e_accel = take_rows(accel, elite_idx)                     # (R, E, G)
    e_prio = take_rows(prio, elite_idx)

    d_accel, d_prio = take_rows(e_accel, draws.dads), \
        take_rows(e_prio, draws.dads)                         # (R, n, G)
    m_accel, m_prio = take_rows(e_accel, draws.moms), \
        take_rows(e_prio, draws.moms)

    # operator choice per child: inverse-CDF over the (static) mix
    cdf = _operator_cdf(cfg, accel.device)
    op = torch.searchsorted(cdf, draws.u_op, right=True)[..., None]

    idx = torch.arange(G, device=accel.device)

    # crossover-gen: pivot crossover on one randomly-chosen genome
    take_gen = idx >= draws.pivot
    g_accel = torch.where(~draws.which & take_gen, m_accel, d_accel)
    g_prio = torch.where(draws.which & take_gen, m_prio, d_prio)

    # crossover-rg: same index range from mom in BOTH genomes
    lo = torch.minimum(draws.ra, draws.rb)
    hi = torch.maximum(draws.ra, draws.rb) + 1
    take_rg = (idx >= lo) & (idx < hi)
    r_accel = torch.where(take_rg, m_accel, d_accel)
    r_prio = torch.where(take_rg, m_prio, d_prio)

    # crossover-accel: copy mom's schedule for one core; rebalance displaced
    from_mom = m_accel == draws.a_sel
    a_accel = torch.where(from_mom, m_accel, d_accel)
    a_prio = torch.where(from_mom, m_prio, d_prio)
    displaced = (d_accel == draws.a_sel) & ~from_mom
    a_accel = torch.where(displaced, draws.rebalance, a_accel)

    c_accel = torch.where(op == 0, g_accel, torch.where(
        op == 1, r_accel, torch.where(op == 2, a_accel, d_accel)))
    c_prio = torch.where(op == 0, g_prio, torch.where(
        op == 1, r_prio, torch.where(op == 2, a_prio, d_prio)))

    # mutation: per-gene re-draw
    mut = draws.u_mut < cfg.mutation_rate
    c_accel = torch.where(mut, draws.mut_accel, c_accel)
    c_prio = torch.where(mut, draws.mut_prio, c_prio)

    return (torch.cat([e_accel, c_accel], dim=1),
            torch.cat([e_prio, c_prio], dim=1))


# ---------------------------------------------------------------------------
# operators — single-child references.  The engine uses the batched
# ``next_generation_body`` (same semantics, draws in dense (n, G)
# tensors); these are its executable spec, one child at a time, with the
# random draws passed in (genomes are (G,) tensors; dad/mom are
# (accel, prio) pairs).
# ---------------------------------------------------------------------------
class ChildDraws(NamedTuple):
    """The random numbers of one child (``op`` already chosen)."""
    op: int                   # 0 gen, 1 rg, 2 accel, 3 copy of dad
    which: bool               # crossover-gen takes the prio genome
    pivot: int                # crossover-gen pivot
    ra: int                   # crossover-rg ends
    rb: int
    a_sel: int                # crossover-accel core
    rebalance: torch.Tensor   # (G,) int32: displaced jobs' new cores
    u_mut: torch.Tensor       # (G,) f32: mutation mask draw
    mut_accel: torch.Tensor   # (G,) int32
    mut_prio: torch.Tensor    # (G,) f32


def _mutate(accel, prio, rate, u_mut, mut_accel, mut_prio):
    mask = u_mut < rate
    return (torch.where(mask, mut_accel, accel),
            torch.where(mask, mut_prio, prio))


def _crossover_gen(dad, mom, which: bool, pivot: int):
    """Pivot crossover on one randomly-chosen genome only."""
    take_mom = torch.arange(dad[0].shape[0], device=dad[0].device) >= pivot
    accel = torch.where(take_mom & (not which), mom[0], dad[0])
    prio = torch.where(take_mom & which, mom[1], dad[1])
    return accel, prio


def _crossover_rg(dad, mom, a: int, b: int):
    """Range crossover applied to BOTH genomes at the same indices."""
    idx = torch.arange(dad[0].shape[0], device=dad[0].device)
    take_mom = (idx >= min(a, b)) & (idx < max(a, b) + 1)
    return (torch.where(take_mom, mom[0], dad[0]),
            torch.where(take_mom, mom[1], dad[1]))


def _crossover_accel(dad, mom, a: int, rebalance):
    """Copy mom's schedule for one sub-accelerator; rebalance displaced
    jobs."""
    from_mom = mom[0] == a
    accel = torch.where(from_mom, mom[0], dad[0])
    prio = torch.where(from_mom, mom[1], dad[1])
    # jobs dad had on `a` but mom didn't: randomly re-assign (load balance)
    displaced = (dad[0] == a) & ~from_mom
    return torch.where(displaced, rebalance, accel), prio


def _make_child(dad, mom, d: ChildDraws, cfg: MagmaConfig):
    if d.op == 0:
        child = _crossover_gen(dad, mom, d.which, d.pivot)
    elif d.op == 1:
        child = _crossover_rg(dad, mom, d.ra, d.rb)
    elif d.op == 2:
        child = _crossover_accel(dad, mom, d.a_sel, d.rebalance)
    else:
        child = dad
    return _mutate(child[0], child[1], cfg.mutation_rate, d.u_mut,
                   d.mut_accel, d.mut_prio)


def magma_search(fitness_fn: FitnessFn, budget: int = 10_000,
                 cfg: MagmaConfig | None = None, seed: int = 0, *,
                 device: Union[str, torch.device] = "cuda",
                 init_population: Population | None = None,
                 keep_population: bool = False,
                 engine: str = "scan") -> SearchResult:
    """Run MAGMA for ``budget`` fitness evaluations (paper: 10K) on
    ``device``, which must be where ``fitness_fn`` keeps its tables.

    ``engine="scan"`` (default) keeps the whole search on the device;
    ``engine="loop"`` steps it from the host (``_magma_search_loop``).
    Both give the same result for a seed."""
    cfg = cfg or MagmaConfig()
    if engine == "loop":
        return _magma_search_loop(fitness_fn, budget, cfg, seed, device,
                                  init_population, keep_population)
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}")
    from repro_torch.core.strategies import MagmaStrategy, run_strategy
    return run_strategy(MagmaStrategy(cfg), fitness_fn,
                        budget=budget, seed=seed, device=device,
                        init_population=init_population,
                        keep_population=keep_population)


def magma_search_batch(scenarios: Union[Sequence[FitnessFn], FitnessParams],
                       budget: int = 10_000,
                       cfg: MagmaConfig | None = None,
                       seeds: Sequence[int] = (0,),
                       num_accels: Optional[int] = None, *,
                       device: Union[str, torch.device] = "cuda"
                       ) -> BatchSearchResult:
    """Run an S x K grid of searches as batched rows on ``device``.

    ``scenarios`` is a sequence of same-shape ``FitnessFn``s (stacked
    automatically) or an already-stacked ``FitnessParams`` with a leading
    scenario axis (then ``num_accels`` is required).  Row ``[s, k]``
    equals a standalone ``magma_search(scenarios[s], seed=seeds[k])``
    bitwise.  Routes through ``repro_torch.core.sweep.run_sweep``; use it
    directly for chunked grids.
    """
    from repro_torch.core.sweep import run_sweep
    return run_sweep(scenarios, budget=budget, cfg=cfg, seeds=seeds,
                     num_accels=num_accels, device=device)


def _magma_search_loop(fitness_fn: FitnessFn, budget: int, cfg: MagmaConfig,
                       seed: int, device, init_population: Population | None,
                       keep_population: bool) -> SearchResult:
    """The host-stepped search: one read-back a generation (the parity
    and benchmark baseline of the device engine)."""
    from repro_torch.core.strategies import MagmaStrategy, run_strategy
    return run_strategy(MagmaStrategy(cfg), fitness_fn, budget=budget,
                        seed=seed, device=device, engine="loop",
                        init_population=init_population,
                        keep_population=keep_population)

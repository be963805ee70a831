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

The whole search stays on the search's device: ``magma_search`` runs the
shared strategy driver (``repro_torch.core.strategies.run_strategy``),
which reads nothing back to the host until the last generation is done.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.encoding import Population
from repro_torch.core.fitness import FitnessFn


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


def draw_generation(gen: torch.Generator, n_child: int, G: int, A: int,
                    cfg: MagmaConfig) -> GenerationDraws:
    """Draw one generation's random tensors from ``gen`` on its device."""
    dev = gen.device
    n_elite = cfg.n_elite

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32)

    return GenerationDraws(
        dads=randint(0, n_elite, (n_child,)),
        moms=randint(0, n_elite, (n_child,)),
        u_op=uniform((n_child,)),
        which=uniform((n_child, 1)) < 0.5,
        pivot=randint(1, max(G, 2), (n_child, 1)),
        ra=randint(0, G, (n_child, 1)),
        rb=randint(0, G, (n_child, 1)),
        a_sel=randint(0, A, (n_child, 1)),
        rebalance=randint(0, A, (n_child, G)),
        u_mut=uniform((n_child, G)),
        mut_accel=randint(0, A, (n_child, G)),
        mut_prio=uniform((n_child, G)),
    )


@functools.lru_cache(maxsize=32)
def _operator_cdf(cfg: MagmaConfig, device: torch.device) -> torch.Tensor:
    """The operator mix's CDF, computed in float64 and cast to float32
    exactly as the reference does.  Cached per (cfg, device) so that a
    generation copies nothing from the host; callers never mutate it."""
    probs = np.array(
        [cfg.p_crossover_gen if cfg.enable_crossover_gen else 0.0,
         cfg.p_crossover_rg if cfg.enable_crossover_rg else 0.0,
         cfg.p_crossover_accel if cfg.enable_crossover_accel else 0.0])
    probs = np.concatenate([probs, [max(1.0 - probs.sum(), 0.0)]])
    return torch.as_tensor(np.cumsum(probs / probs.sum()), dtype=torch.float32,
                           device=device)


def next_generation_body(accel: torch.Tensor, prio: torch.Tensor,
                         fitness: torch.Tensor, draws: GenerationDraws,
                         cfg: MagmaConfig, num_accels: int, n_elite: int):
    """Elitism + brood generation on (P, G) genomes, given the draws.

    Deterministic: every random number comes from ``draws``.  Returns the
    next ``(accel, prio)``, elites first.  ``num_accels`` is kept for
    parity with the reference signature; the draws already carry its range.
    """
    del num_accels
    G = accel.shape[1]
    order = torch.argsort(-fitness, stable=True)
    elite_idx = order[:n_elite]
    e_accel = accel[elite_idx]
    e_prio = prio[elite_idx]

    d_accel, d_prio = e_accel[draws.dads], e_prio[draws.dads]   # (n, G)
    m_accel, m_prio = e_accel[draws.moms], e_prio[draws.moms]

    # operator choice per child: inverse-CDF over the (static) mix
    cdf = _operator_cdf(cfg, accel.device)
    op = torch.searchsorted(cdf, draws.u_op, right=True)[:, None]

    idx = torch.arange(G, device=accel.device)[None, :]

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

    return (torch.cat([e_accel, c_accel]), torch.cat([e_prio, c_prio]))


def magma_search(fitness_fn: FitnessFn, budget: int = 10_000,
                 cfg: MagmaConfig | None = None, seed: int = 0, *,
                 device: Union[str, torch.device] = "cuda",
                 init_population: Population | None = None,
                 keep_population: bool = False) -> SearchResult:
    """Run MAGMA for ``budget`` fitness evaluations (paper: 10K) on
    ``device``, which must be where ``fitness_fn`` keeps its tables."""
    from repro_torch.core.strategies import MagmaStrategy, run_strategy
    return run_strategy(MagmaStrategy(cfg or MagmaConfig()), fitness_fn,
                        budget=budget, seed=seed, device=device,
                        init_population=init_population,
                        keep_population=keep_population)

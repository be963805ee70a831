"""NSGA-II — multi-objective search behind ask/tell, on the search's device.

A ``multi_objective = True`` strategy: the driver feeds ``tell`` the
(R, P, M) objective matrix (``evaluate_objectives``) instead of a scalar
column, and the state carries, per row, an elitist archive of the P most
crowded low-rank genomes seen so far.  Its pieces are the fixed-shape
functions of ``repro_torch.core.pareto``:

  - fast non-dominated sort = pairwise domination matrix + front peeling,
  - crowding distance = one lexicographic sort per objective with
    per-front spans via scatter-min/max,
  - environmental selection = one lexicographic sort on (rank,
    -crowding, index).

Variation happens in the continuous [0, 1]^{2G} relaxation the host
baselines use (``decode_continuous``): simulated binary crossover (SBX)
over binary-tournament parents + polynomial mutation.  As for the other
strategies, :func:`draw_nsga2` draws a step's random tensors (each row
from its own generator, the reference's draws in its order) and
:func:`nsga2_body` is the deterministic rest, so a test can inject the
reference's draws.

The archive's fitness matrix initializes to a finite ``-1e30`` sentinel
(not ``-inf``: crowding normalizes by per-front spans and ``inf - inf``
would NaN), so the first ``tell`` always replaces it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.encoding import (Population, rand_rows, randint_rows,
                                       take_rows)
from repro_torch.core.pareto import crowded_order, crowding_distance, nd_ranks
from repro_torch.core.strategies.base import (SearchStrategy,
                                              decode_continuous)
from repro_torch.core.strategies.registry import register

_SENTINEL = -1e30      # finite "worse than anything real" archive init


def encode_continuous(accel: torch.Tensor, prio: torch.Tensor,
                      num_accels: int) -> torch.Tensor:
    """Inverse of ``decode_continuous`` up to exact round-trip: accel k
    maps to the center of its decode bin ((k + 0.5) / A), priorities pass
    through."""
    acc = (accel.to(torch.float32) + 0.5) / num_accels
    return torch.cat([acc, prio.to(torch.float32)], dim=-1)


class NSGA2State(NamedTuple):
    gens: Tuple[torch.Generator, ...]
    X: torch.Tensor        # (R, P, 2G) f32 — the candidates ask proposes
    arch_X: torch.Tensor   # (R, P, 2G) f32 — elitist archive (survivors)
    arch_F: torch.Tensor   # (R, P, M)  f32 — archive objective matrix


class NSGA2Draws(NamedTuple):
    t1: torch.Tensor       # (R, 2, P) int32: first parents' tournaments
    t2: torch.Tensor       # (R, 2, P) int32: second parents' tournaments
    u: torch.Tensor        # (R, P, d) f32: SBX spread draw
    u_cross: torch.Tensor  # (R, P, 1) f32: crossover-or-copy draw
    u_delta: torch.Tensor  # (R, P, d) f32: polynomial mutation draw
    u_mut: torch.Tensor    # (R, P, d) f32: mutation mask draw


def draw_nsga2(gens, P: int, d: int) -> NSGA2Draws:
    return NSGA2Draws(t1=randint_rows(gens, 0, P, (2, P)),
                      t2=randint_rows(gens, 0, P, (2, P)),
                      u=rand_rows(gens, (P, d)),
                      u_cross=rand_rows(gens, (P, 1)),
                      u_delta=rand_rows(gens, (P, d)),
                      u_mut=rand_rows(gens, (P, d)))


def nsga2_body(state: NSGA2State, fitness: torch.Tensor, draws: NSGA2Draws,
               eta_crossover: float, eta_mutation: float,
               p_crossover: float) -> NSGA2State:
    """Environmental selection over archive + offspring, then SBX and
    polynomial mutation of tournament parents; fitness (R, P, M)."""
    P, d = state.X.shape[1:]
    # -- environmental selection over archive ∪ offspring ----------------
    pool_X = torch.cat([state.arch_X, state.X], dim=1)
    pool_F = torch.cat([state.arch_F, fitness.to(state.arch_F.dtype)],
                       dim=1)
    rank = nd_ranks(pool_F)
    crowd = crowding_distance(pool_F, rank)
    surv = crowded_order(rank, crowd)[..., :P]
    arch_X, arch_F = take_rows(pool_X, surv), take_rows(pool_F, surv)
    s_rank = torch.gather(rank, -1, surv)
    s_crowd = torch.gather(crowd, -1, surv)

    # -- binary tournaments on (rank, crowding) for two parent sets ------
    def tournament(t):
        a, b = t[:, 0].long(), t[:, 1].long()
        ra, rb = torch.gather(s_rank, -1, a), torch.gather(s_rank, -1, b)
        ca, cb = torch.gather(s_crowd, -1, a), torch.gather(s_crowd, -1, b)
        a_wins = (ra < rb) | ((ra == rb) & (ca >= cb))
        return torch.where(a_wins, a, b)
    x1 = take_rows(arch_X, tournament(draws.t1))
    x2 = take_rows(arch_X, tournament(draws.t2))

    # -- SBX crossover ----------------------------------------------------
    u = draws.u
    exp = 1.0 / (eta_crossover + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** exp,
                       (1.0 / (2.0 * (1.0 - u))) ** exp)
    child = 0.5 * ((1.0 + beta) * x1 + (1.0 - beta) * x2)
    do_cross = draws.u_cross < p_crossover
    child = torch.clamp(torch.where(do_cross, child, x1), 0.0, 1.0)

    # -- polynomial mutation, expected one gene per individual ------------
    um = draws.u_delta
    mexp = 1.0 / (eta_mutation + 1.0)
    delta = torch.where(um < 0.5, (2.0 * um) ** mexp - 1.0,
                        1.0 - (2.0 * (1.0 - um)) ** mexp)
    mutate = draws.u_mut < (1.0 / d)
    child = torch.clamp(torch.where(mutate, child + delta, child), 0.0, 1.0)
    return NSGA2State(gens=state.gens, X=child.to(torch.float32),
                      arch_X=arch_X, arch_F=arch_F)


@dataclasses.dataclass(frozen=True)
class NSGA2Strategy(SearchStrategy):
    """NSGA-II (Deb et al. 2002) on the continuous mapping relaxation."""

    pop_size: int = 64
    eta_crossover: float = 15.0     # SBX distribution index
    eta_mutation: float = 20.0      # polynomial-mutation distribution index
    p_crossover: float = 0.9        # per-individual SBX probability
    num_accels: Optional[int] = None
    name = "nsga2"
    multi_objective = True

    @property
    def ask_size(self) -> int:
        return self.pop_size

    def init(self, gens, params, *, init_population=None) -> NSGA2State:
        P = self.pop_size
        G = params.lat.shape[-2]
        # rows: objective_code (R,) for a scalar problem, (R, M) for M
        code = params.objective_code
        M = int(code.shape[-1]) if code.dim() == 2 else 1
        if init_population is None:
            X = rand_rows(gens, (P, 2 * G))
        else:
            pop = Population(*init_population)
            X = encode_continuous(pop.accel, pop.prio, self.num_accels)
        arch_F = torch.full(X.shape[:2] + (M,), _SENTINEL,
                            dtype=torch.float32, device=X.device)
        return NSGA2State(gens=tuple(gens), X=X, arch_X=X, arch_F=arch_F)

    def ask(self, state: NSGA2State):
        return (state,) + decode_continuous(state.X, self.num_accels)

    def tell(self, state: NSGA2State, fitness: torch.Tensor) -> NSGA2State:
        P, d = state.X.shape[1:]
        if fitness.dim() == 2:               # scalar problem: M=1 column
            fitness = fitness[..., None]
        return nsga2_body(state, fitness, draw_nsga2(state.gens, P, d),
                          self.eta_crossover, self.eta_mutation,
                          self.p_crossover)

    def population(self, state: NSGA2State) -> Population:
        """The ARCHIVE (best non-dominated set seen), not the offspring —
        what ``pareto_front`` extracts."""
        accel, prio = decode_continuous(state.arch_X, self.num_accels)
        return Population(accel=accel, prio=prio)


def _nsga2_factory(population: int = 64, eta_crossover: float = 15.0,
                   eta_mutation: float = 20.0,
                   p_crossover: float = 0.9) -> NSGA2Strategy:
    # the registry kwarg stays ``population`` (matching every other
    # strategy); the field is ``pop_size`` so the ``population(state)``
    # protocol method is not shadowed
    return NSGA2Strategy(pop_size=population, eta_crossover=eta_crossover,
                         eta_mutation=eta_mutation, p_crossover=p_crossover)


register("nsga2", _nsga2_factory, device_resident=True,
         description="NSGA-II: non-dominated sort + crowding elitism over "
                     "the continuous relaxation; multi-objective "
                     "(latency/energy/EDP Pareto fronts)",
         figures="beyond-paper: Section IV-C objectives as one frontier")

"""Device-resident black-box baselines (Table IV) as ask/tell strategies.

Each strategy is the reference's ``repro.core.strategies.blackbox``
counterpart on the continuous relaxation x in [0, 1]^{2G}
(``decode_continuous``), with Table IV's hyper-parameters:

  random   uniform re-draw every generation
  stdga    whole-genome single-point crossover 0.1 + uniform mutation 0.1
  de       DE/rand/1/bin, F = CR = 0.8
  pso      w_global = w_parent = 0.8, momentum 1.6

Every step is split as MAGMA's is: a ``draw_*`` function draws the
step's random tensors, each row from its own generator (the reference's
draws, with the same shapes, ranges and dtypes), and a ``*_body``
function is the deterministic rest, over R rows at once.  A test can feed
a body the reference's own draws.  The one draw that is the port's own
is DE's three distinct donors per individual: the reference takes
``jax.random.choice(replace=False)``; here three uniform integers in
[0, P), [0, P-1) and [0, P-2) are shifted past the donors already taken,
which gives every ordered triple of distinct indices the same chance.

Selection sorts are stable along the population axis, so ties keep the
lower index whatever the number of rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.encoding import rand_rows, randint_rows, take_rows
from repro_torch.core.strategies.base import (SearchStrategy,
                                              decode_continuous)
from repro_torch.core.strategies.registry import register

Gens = Tuple[torch.Generator, ...]


# lint: dispatch
def _uniform_start(gens, P: int, params) -> torch.Tensor:
    return rand_rows(gens, (P, 2 * params.lat.shape[-2]))


# ---------------------------------------------------------------------------
# random search
# ---------------------------------------------------------------------------
class RandomState(NamedTuple):
    gens: Gens
    X: torch.Tensor          # (R, P, 2G) the batch the next ask proposes


@dataclasses.dataclass(frozen=True)
class RandomStrategy(SearchStrategy):
    """Uniform random search: every generation is a fresh uniform batch."""

    population: int = 100
    num_accels: Optional[int] = None
    name = "random"

    @property
    def ask_size(self) -> int:
        return self.population

    def init(self, gens, params, *, init_population=None) -> RandomState:
        if init_population is not None:
            raise ValueError("random search takes no init_population")
        return RandomState(gens=tuple(gens),
                           X=_uniform_start(gens, self.population, params))

    def ask(self, state: RandomState):
        return (state,) + decode_continuous(state.X, self.num_accels)

    def tell(self, state: RandomState, fitness) -> RandomState:
        return RandomState(gens=state.gens,
                           X=rand_rows(state.gens, state.X.shape[1:]))


# ---------------------------------------------------------------------------
# standard GA
# ---------------------------------------------------------------------------
class StdGAState(NamedTuple):
    gens: Gens
    X: torch.Tensor          # (R, P, 2G)


class StdGADraws(NamedTuple):
    dads: torch.Tensor       # (R, n) int32 in [0, n_elite)
    moms: torch.Tensor       # (R, n) int32 in [0, n_elite)
    u_cross: torch.Tensor    # (R, n, 1) f32: crossover draw
    pivot: torch.Tensor      # (R, n, 1) int32 in [1, max(d, 2))
    u_mut: torch.Tensor      # (R, n, d) f32: mutation mask draw
    mut: torch.Tensor        # (R, n, d) f32: mutated values


# lint: dispatch
def draw_stdga(gens, n_child: int, n_elite: int, d: int) -> StdGADraws:
    return StdGADraws(
        dads=randint_rows(gens, 0, n_elite, (n_child,)),
        moms=randint_rows(gens, 0, n_elite, (n_child,)),
        u_cross=rand_rows(gens, (n_child, 1)),
        pivot=randint_rows(gens, 1, max(d, 2), (n_child, 1)),
        u_mut=rand_rows(gens, (n_child, d)),
        mut=rand_rows(gens, (n_child, d)))


# lint: dispatch
def stdga_body(X, fitness, draws: StdGADraws, n_elite: int,
               crossover_rate: float, mutation_rate: float) -> torch.Tensor:
    """Next (R, P, d) population: the elites, then their children."""
    d = X.shape[-1]
    elites = take_rows(X, torch.argsort(-fitness, dim=-1,
                                        stable=True)[:, :n_elite])
    dads = take_rows(elites, draws.dads)
    moms = take_rows(elites, draws.moms)
    take = (draws.u_cross < crossover_rate) & (
        torch.arange(d, device=X.device) >= draws.pivot)
    child = torch.where(take, moms, dads)
    child = torch.where(draws.u_mut < mutation_rate, draws.mut, child)
    return torch.cat([elites, child], dim=1)


@dataclasses.dataclass(frozen=True)
class StdGAStrategy(SearchStrategy):
    """Standard GA: whole-genome single-point crossover + uniform mutation."""

    population: int = 100
    mutation_rate: float = 0.1
    crossover_rate: float = 0.1
    elite_frac: float = 0.1
    num_accels: Optional[int] = None
    name = "stdga"

    @property
    def ask_size(self) -> int:
        return self.population

    @property
    def n_elite(self) -> int:
        return max(1, int(self.elite_frac * self.population))

    def init(self, gens, params, *, init_population=None) -> StdGAState:
        if init_population is not None:
            raise ValueError("stdga takes no init_population")
        return StdGAState(gens=tuple(gens),
                          X=_uniform_start(gens, self.population, params))

    def ask(self, state: StdGAState):
        return (state,) + decode_continuous(state.X, self.num_accels)

    def tell(self, state: StdGAState, fitness) -> StdGAState:
        _, P, d = state.X.shape
        draws = draw_stdga(state.gens, P - self.n_elite, self.n_elite, d)
        return StdGAState(gens=state.gens, X=stdga_body(
            state.X, fitness, draws, self.n_elite, self.crossover_rate,
            self.mutation_rate))


# ---------------------------------------------------------------------------
# differential evolution
# ---------------------------------------------------------------------------
class DEState(NamedTuple):
    gens: Gens
    X: torch.Tensor          # (R, P, 2G) current population
    fit: torch.Tensor        # (R, P) its fitness (-inf before evaluation)
    trial: torch.Tensor      # (R, P, 2G) the batch the last ask proposed


class DEDraws(NamedTuple):
    idx: torch.Tensor        # (R, P, 3) int32: distinct donors a, b, c
    u_cross: torch.Tensor    # (R, P, d) f32: binomial crossover draw
    jrand: torch.Tensor      # (R, P) int32 in [0, d): the forced gene


# lint: dispatch
def draw_de(gens, P: int, d: int) -> DEDraws:
    i0 = randint_rows(gens, 0, P, (P,))
    i1 = randint_rows(gens, 0, P - 1, (P,))
    i2 = randint_rows(gens, 0, P - 2, (P,))
    i1 = i1 + (i1 >= i0).int()
    lo, hi = torch.minimum(i0, i1), torch.maximum(i0, i1)
    i2 = i2 + (i2 >= lo).int()
    i2 = i2 + (i2 >= hi).int()
    return DEDraws(idx=torch.stack([i0, i1, i2], dim=-1),
                   u_cross=rand_rows(gens, (P, d)),
                   jrand=randint_rows(gens, 0, d, (P,)))


# lint: dispatch
def de_trial(X, draws: DEDraws, f_weight: float, cr: float) -> torch.Tensor:
    """DE/rand/1/bin trials of an (R, P, d) population."""
    d = X.shape[-1]
    a, b, c = (take_rows(X, draws.idx[..., k]) for k in range(3))
    mutant = torch.clamp(a + f_weight * (b - c), 0.0, 1.0)
    cross = (draws.u_cross < cr) | (
        torch.arange(d, device=X.device) == draws.jrand[..., None])
    return torch.where(cross, mutant, X)


@dataclasses.dataclass(frozen=True)
class DEStrategy(SearchStrategy):
    """DE/rand/1/bin; ``ask`` proposes trials, ``tell`` greedily selects."""

    population: int = 100
    f_weight: float = 0.8
    cr: float = 0.8
    num_accels: Optional[int] = None
    name = "de"

    @property
    def ask_size(self) -> int:
        return self.population

    def init(self, gens, params, *, init_population=None) -> DEState:
        if init_population is not None:
            raise ValueError("de takes no init_population")
        X = _uniform_start(gens, self.population, params)
        # fit = -inf: the first tell accepts every trial unconditionally
        fit = torch.full(X.shape[:2], float("-inf"), dtype=torch.float32,
                         device=X.device)
        return DEState(gens=tuple(gens), X=X, fit=fit, trial=X)

    def ask(self, state: DEState):
        _, P, d = state.X.shape
        trial = de_trial(state.X, draw_de(state.gens, P, d), self.f_weight,
                         self.cr)
        state = DEState(gens=state.gens, X=state.X, fit=state.fit,
                        trial=trial)
        return (state,) + decode_continuous(trial, self.num_accels)

    def tell(self, state: DEState, fitness) -> DEState:
        better = fitness > state.fit
        return DEState(
            gens=state.gens,
            X=torch.where(better[..., None], state.trial, state.X),
            fit=torch.where(better, fitness, state.fit),
            trial=state.trial)


# ---------------------------------------------------------------------------
# particle swarm
# ---------------------------------------------------------------------------
class PSOState(NamedTuple):
    gens: Gens
    X: torch.Tensor          # (R, P, 2G) positions
    V: torch.Tensor          # (R, P, 2G) velocities
    pbest: torch.Tensor      # (R, P, 2G)
    pbest_f: torch.Tensor    # (R, P)
    gbest: torch.Tensor      # (R, 2G)
    gbest_f: torch.Tensor    # (R,)


# lint: dispatch
def pso_body(state: PSOState, fitness, r: torch.Tensor, w_global: float,
             w_parent: float, momentum: float) -> PSOState:
    """One swarm step given ``r`` (R, 2, P, d), the reference's draw."""
    X = state.X
    imp = fitness > state.pbest_f
    pbest = torch.where(imp[..., None], X, state.pbest)
    pbest_f = torch.where(imp, fitness, state.pbest_f)
    i = torch.argmax(fitness, dim=-1, keepdim=True)
    top = torch.gather(fitness, 1, i)[:, 0]
    better = top > state.gbest_f
    gbest = torch.where(better[:, None], take_rows(X, i)[:, 0], state.gbest)
    gbest_f = torch.where(better, top, state.gbest_f)
    V = (momentum * state.V
         + w_parent * r[:, 0] * (pbest - X)
         + w_global * r[:, 1] * (gbest[:, None, :] - X))
    V = torch.clamp(V, -0.5, 0.5)
    return PSOState(gens=state.gens, X=torch.clamp(X + V, 0.0, 1.0), V=V,
                    pbest=pbest, pbest_f=pbest_f, gbest=gbest,
                    gbest_f=gbest_f)


@dataclasses.dataclass(frozen=True)
class PSOStrategy(SearchStrategy):
    """Particle swarm with personal/global attraction and momentum."""

    population: int = 100
    w_global: float = 0.8
    w_parent: float = 0.8
    momentum: float = 1.6
    num_accels: Optional[int] = None
    name = "pso"

    @property
    def ask_size(self) -> int:
        return self.population

    def init(self, gens, params, *, init_population=None) -> PSOState:
        if init_population is not None:
            raise ValueError("pso takes no init_population")
        X = _uniform_start(gens, self.population, params)
        V = (rand_rows(gens, X.shape[1:]) - 0.5) * 0.1
        R, P = X.shape[:2]
        return PSOState(
            gens=tuple(gens), X=X, V=V, pbest=X,
            pbest_f=torch.full((R, P), float("-inf"), device=X.device),
            gbest=X[:, 0], gbest_f=torch.full((R,), float("-inf"),
                                              device=X.device))

    def ask(self, state: PSOState):
        return (state,) + decode_continuous(state.X, self.num_accels)

    def tell(self, state: PSOState, fitness) -> PSOState:
        r = rand_rows(state.gens, (2,) + tuple(state.X.shape[1:]))
        return pso_body(state, fitness, r, self.w_global, self.w_parent,
                        self.momentum)


register("random", RandomStrategy, device_resident=True,
         description="uniform random search on the continuous relaxation",
         figures="Table IV; Fig. 11")
register("stdga", StdGAStrategy, device_resident=True, aliases=("std_ga",),
         description="standard GA, crossover 0.1 / mutation 0.1 (Table IV)",
         figures="Table IV; Fig. 11")
register("de", DEStrategy, device_resident=True,
         description="differential evolution DE/rand/1/bin, F=CR=0.8",
         figures="Table IV; Fig. 11")
register("pso", PSOStrategy, device_resident=True,
         description="particle swarm, w=0.8/0.8, momentum 1.6 (Table IV)",
         figures="Table IV; Fig. 11")

"""MAGMA behind the ask/tell interface — a thin adapter over the generation
step of ``repro_torch.core.magma``.

``ask`` returns the current populations unchanged; ``tell`` draws the
generation's random tensors (``draw_generation_rows``: generation
``ctr[r]`` of row r's counter-based stream under ``key[r]``, one kernel
launch for every row on a card), runs the deterministic
``next_generation_body`` (elitism + the paper's four operators, batched
over the children and the rows) and advances the counter.  ``init``
draws each row's key from the row's generator right after its
population, so the seed still decides every draw, and a row's draws
depend on nothing but its own key: a sweep or stream row stays bitwise
its standalone search.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.encoding import (Population, randint_rows,
                                       random_population_rows)
from repro_torch.core.magma import (MagmaConfig, draw_generation_rows,
                                    next_generation_body)
from repro_torch.core.strategies.base import (SearchStrategy, WarmStart,
                                              seed_population,
                                              warm_noise_rows)
from repro_torch.core.strategies.registry import register


class MagmaState(NamedTuple):
    gens: Tuple[torch.Generator, ...]   # one per row
    accel: torch.Tensor   # (R, P, G) int32
    prio: torch.Tensor    # (R, P, G) float32
    key: torch.Tensor     # (R, 2) int64: a row's two 32-bit key words
    ctr: torch.Tensor     # (R,) int64: the generation the next tell draws


@dataclasses.dataclass(frozen=True)
class MagmaStrategy(SearchStrategy):
    """MAGMA's GA as an ask/tell strategy (Section V operators)."""

    cfg: MagmaConfig = MagmaConfig()
    num_accels: Optional[int] = None     # bound per problem via .bind()
    name = "magma"
    supports_init_population = True
    #: the generations' draw stream, named in the memo's fingerprints
    draw_stream = "philox4x32-10-ctr"

    @property
    def ask_size(self) -> int:
        return self.cfg.population

    @property
    def n_elite(self) -> int:
        return self.cfg.n_elite

    def init(self, gens, params, *, init_population=None) -> MagmaState:
        warm = isinstance(init_population, WarmStart)
        if warm:
            noise = warm_noise_rows(gens, init_population.prio.shape[1:])
        # drawn with a hand-off too: the generators then stand where a
        # cold search's do (see strategies.base)
        pop = random_population_rows(gens, self.cfg.population,
                                     params.lat.shape[-2], self.num_accels)
        key = randint_rows(gens, 0, 2 ** 32, (2,), dtype=torch.int64)
        if warm:
            ws = init_population
            pop = Population(*seed_population(ws.accel, ws.prio, ws.jitter,
                                              noise, self.num_accels))
        elif init_population is not None:
            pop = Population(*init_population)
        return MagmaState(gens=tuple(gens), accel=pop.accel, prio=pop.prio,
                          key=key, ctr=torch.zeros_like(key[:, 0]))

    def ask(self, state: MagmaState):
        return state, state.accel, state.prio

    def tell(self, state: MagmaState, fitness: torch.Tensor) -> MagmaState:
        _, P, G = state.accel.shape
        draws, ctr = draw_generation_rows(state.key, state.ctr,
                                          P - self.n_elite, G,
                                          self.num_accels, self.cfg)
        accel, prio = next_generation_body(
            state.accel, state.prio, fitness, draws, self.cfg,
            self.num_accels, self.n_elite)
        return state._replace(accel=accel, prio=prio, ctr=ctr)

    def population(self, state: MagmaState) -> Population:
        return Population(accel=state.accel, prio=state.prio)


def _magma_factory(cfg: Optional[MagmaConfig] = None) -> MagmaStrategy:
    return MagmaStrategy(cfg=cfg or MagmaConfig())


register("magma", _magma_factory, device_resident=True,
         description="MAGMA GA: elitism + the paper's four domain-aware "
                     "operators (mutation, crossover-gen/-rg/-accel)",
         figures="every figure; Table IV")

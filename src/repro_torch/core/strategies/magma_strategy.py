"""MAGMA behind the ask/tell interface — a thin adapter over the generation
step of ``repro_torch.core.magma``.

``ask`` returns the current populations unchanged; ``tell`` draws the
generation's random tensors, each row from its own generator
(``draw_generation_rows``), and runs the deterministic
``next_generation_body`` (elitism + the paper's four operators, batched
over the children and the rows).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.encoding import Population, random_population_rows
from repro_torch.core.magma import (MagmaConfig, draw_generation_rows,
                                    next_generation_body)
from repro_torch.core.strategies.base import SearchStrategy
from repro_torch.core.strategies.registry import register


class MagmaState(NamedTuple):
    gens: Tuple[torch.Generator, ...]   # one per row
    accel: torch.Tensor   # (R, P, G) int32
    prio: torch.Tensor    # (R, P, G) float32


@dataclasses.dataclass(frozen=True)
class MagmaStrategy(SearchStrategy):
    """MAGMA's GA as an ask/tell strategy (Section V operators)."""

    cfg: MagmaConfig = MagmaConfig()
    num_accels: Optional[int] = None     # bound per problem via .bind()
    name = "magma"

    @property
    def ask_size(self) -> int:
        return self.cfg.population

    @property
    def n_elite(self) -> int:
        return self.cfg.n_elite

    def init(self, gens, params, *, init_population=None) -> MagmaState:
        if init_population is None:
            pop = random_population_rows(gens, self.cfg.population,
                                         params.lat.shape[-2],
                                         self.num_accels)
        else:
            pop = Population(*init_population)
        return MagmaState(gens=tuple(gens), accel=pop.accel, prio=pop.prio)

    def ask(self, state: MagmaState):
        return state, state.accel, state.prio

    def tell(self, state: MagmaState, fitness: torch.Tensor) -> MagmaState:
        _, P, G = state.accel.shape
        draws = draw_generation_rows(state.gens, P - self.n_elite, G,
                                     self.num_accels, self.cfg)
        accel, prio = next_generation_body(
            state.accel, state.prio, fitness, draws, self.cfg,
            self.num_accels, self.n_elite)
        return MagmaState(gens=state.gens, accel=accel, prio=prio)

    def population(self, state: MagmaState) -> Population:
        return Population(accel=state.accel, prio=state.prio)


def _magma_factory(cfg: Optional[MagmaConfig] = None) -> MagmaStrategy:
    return MagmaStrategy(cfg=cfg or MagmaConfig())


register("magma", _magma_factory, device_resident=True,
         description="MAGMA GA: elitism + the paper's four domain-aware "
                     "operators (mutation, crossover-gen/-rg/-accel)",
         figures="every figure; Table IV")

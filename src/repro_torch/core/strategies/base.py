"""The ``SearchStrategy`` protocol — every optimizer as ask/tell state.

A strategy is a frozen (hashable) configuration object plus three
functions over a state tuple of tensors, each with a leading row axis of
``R`` independent searches (a sweep chunk; a standalone search is the
case ``R = 1``):

  ``init(gens, params) -> state``           seed R rows' state
  ``ask(state) -> (state, accel, prio)``    propose ``ask_size`` candidates
                                            a row: (R, P, G) each
  ``tell(state, fitness) -> state``         fold the (R, P) fitness in

``params`` is a ``FitnessParams`` stacked for the R rows (lat (R, G, A),
...).  Generator convention: ``gens`` holds one ``torch.Generator`` per
row, created on the search's device and seeded with the row's seed, and
the state carries them.  Every random tensor a step needs is drawn row
by row -- each row's generator fills that row's slice of one (R, ...)
buffer (``repro_torch.core.encoding.rand_rows`` / ``randint_rows``) --
and the step's arithmetic then runs once over all rows.  A row therefore draws exactly
the numbers a standalone search with its seed draws, and the rows never
mix (no reduction or sort crosses the row axis), so a sweep row is
bitwise the standalone search of its scenario and seed.
``init``/``ask``/``tell`` return new state and never assign to ``self``,
so one strategy object can serve many searches.

Strategies are *bound* to a problem before running: :meth:`bind` returns
a copy with ``num_accels`` filled in.  Host-only methods (adaptive
population sizes, RL training loops, one-shot heuristics) implement
:class:`HostSearchStrategy` instead and the registry records them as
``device_resident=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


class SearchStrategy:
    """Base class / protocol for ask-tell search strategies.

    Concrete strategies are frozen dataclasses.
    """

    # plain class attributes, NOT dataclass fields (subclasses override)
    name = "?"
    device_resident = True
    # whether ``tell`` consumes an (R, P, M) objective matrix instead of
    # an (R, P) scalar column; the driver evaluates via
    # ``evaluate_objectives`` and ranks the anytime best on column 0
    multi_objective = False

    @property
    def ask_size(self) -> int:
        """Candidates proposed per ``ask`` (drives budget -> generations)."""
        raise NotImplementedError

    def bind(self, num_accels: int) -> "SearchStrategy":
        """Return this strategy bound to a problem's accelerator count."""
        if getattr(self, "num_accels", None) == num_accels:
            return self
        return dataclasses.replace(self, num_accels=num_accels)

    def init(self, gens: Sequence[torch.Generator], params, *,
             init_population=None) -> Any:
        raise NotImplementedError

    def ask(self, state) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def tell(self, state, fitness: torch.Tensor) -> Any:
        raise NotImplementedError

    def population(self, state):
        """Final (R, P, G) population (for hand-off to a later search),
        or None."""
        return None


@dataclasses.dataclass(frozen=True)
class HostSearchStrategy(SearchStrategy):
    """A host-loop searcher behind the strategy interface.

    Wraps ``fn(fitness_fn, budget, seed) -> SearchResult`` — methods whose
    control flow does not fit a fixed-shape generation loop (adaptive
    population sizes, RL training loops, one-shot heuristics).  The
    registry lists these as ``device_resident=False``; ``run_strategy``
    dispatches them to their own loop and ``run_sweep`` rejects them.
    Their fitness batches still go to the fitness' device.
    """

    name: str = "?"
    fn: Optional[Callable] = None
    device_resident = False

    @property
    def ask_size(self) -> int:
        raise ValueError(f"strategy {self.name!r} is host-only; it has no "
                         "fixed ask size")

    def bind(self, num_accels: int) -> "HostSearchStrategy":
        return self

    def search(self, fitness_fn, budget: int, seed: int):
        return self.fn(fitness_fn, budget, seed)


def decode_continuous(X: torch.Tensor, num_accels: int):
    """(..., 2G) continuous in [0, 1] -> (accel (..., G) int32, prio
    (..., G) f32).

    The same relaxation the host baselines use
    (``repro_torch.core.optimizers.base.decode_x``): the first G dims
    floor to the accel-selection genome, the last G are the priority
    genome.
    """
    G = X.shape[-1] // 2
    accel = torch.clamp_max((X[..., :G] * num_accels).to(torch.int32),
                            num_accels - 1)
    return accel, X[..., G:].to(torch.float32)

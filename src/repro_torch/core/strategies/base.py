"""The ``SearchStrategy`` protocol — every optimizer as ask/tell state.

A strategy is a frozen (hashable) configuration object plus three
functions over a state tuple of tensors:

  ``init(gen, params) -> state``            seed the state
  ``ask(state) -> (state, accel, prio)``    propose ``ask_size`` candidates
  ``tell(state, fitness) -> state``         fold the candidates' fitness in

Generator convention: the state carries the ``torch.Generator`` the search
was seeded with, created on the search's device, and every draw comes from
it.  ``init``/``ask``/``tell`` return new state and never assign to
``self``, so one strategy object can serve many searches.

Strategies are *bound* to a problem before running: :meth:`bind` returns
a copy with ``num_accels`` filled in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


class SearchStrategy:
    """Base class / protocol for ask-tell search strategies.

    Concrete strategies are frozen dataclasses.
    """

    # plain class attribute, NOT a dataclass field (subclasses override)
    name = "?"

    @property
    def ask_size(self) -> int:
        """Candidates proposed per ``ask`` (drives budget -> generations)."""
        raise NotImplementedError

    def bind(self, num_accels: int) -> "SearchStrategy":
        """Return this strategy bound to a problem's accelerator count."""
        if getattr(self, "num_accels", None) == num_accels:
            return self
        return dataclasses.replace(self, num_accels=num_accels)

    def init(self, gen: torch.Generator, params, *,
             init_population=None) -> Any:
        raise NotImplementedError

    def ask(self, state) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def tell(self, state, fitness: torch.Tensor) -> Any:
        raise NotImplementedError

    def population(self, state):
        """Final population (for hand-off to a later search), or None."""
        return None

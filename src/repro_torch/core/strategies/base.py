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

A strategy with ``supports_init_population`` also takes a hand-off in
``init``: a ``Population`` (used verbatim) or a :class:`WarmStart` (a
transferred population, its priorities jittered by
:func:`seed_population`).  Either way ``init`` still draws the cold
population's numbers and drops them, so every row's generator leaves
``init`` where a cold search's does and a seeded search differs from the
cold one only in its initial population.  The warm jitter re-reads, from
a saved generator state, the numbers the cold population then takes
(:func:`warm_noise_rows`), as the reference draws it from the sub-key
that would have drawn the random population.

Strategies are *bound* to a problem before running: :meth:`bind` returns
a copy with ``num_accels`` filled in.  Host-only methods (adaptive
population sizes, RL training loops, one-shot heuristics) implement
:class:`HostSearchStrategy` instead and the registry records them as
``device_resident=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.encoding import randn_rows


class WarmStart(NamedTuple):
    """A transferred population as a warm-start seed (Section V-C).

    Taken wherever ``init_population`` is, by strategies with
    ``supports_init_population``.  Unlike a plain ``Population`` (used
    verbatim), a ``WarmStart`` is *seeded*: ``init`` clips the accel
    genome to the problem's accelerator count and re-randomizes the
    priorities' low bits (:func:`seed_population`).  The schedule memo
    hands one out as host arrays; ``run_strategy`` and the sweep give
    every field a leading row axis on the search's device.
    """
    accel: Any    # (P, G) int32 source population (clipped to A-1)
    prio: Any     # (P, G) float32 source priorities
    jitter: Any   # ()     float32 priority noise scale


# lint: dispatch
def seed_population(accel, prio, jitter, noise, num_accels: int):
    """The Section V-C warm-seed discipline, in one place.

    Clip the transferred accel genome to this problem's accelerator count
    and add ``jitter`` times the standard normals ``noise`` (the shape of
    ``prio``, drawn by the caller) to the priorities, clipped to [0,
    0.999] to keep the prio < 1 encoding invariant.  ``jitter`` is one
    value or one per row (leading axis).  The strategies' ``init`` and
    ``WarmStartEngine.init_population`` both call exactly this.  Returns
    ``(accel int32, prio float32)``.
    """
    accel = torch.clamp_max(torch.as_tensor(accel).to(torch.int32),
                            num_accels - 1)
    prio = torch.as_tensor(prio).to(torch.float32)
    jitter = torch.as_tensor(jitter, dtype=torch.float32, device=prio.device)
    jitter = jitter.reshape(jitter.shape + (1,) * (prio.dim() - jitter.dim()))
    return accel, torch.clamp(prio + jitter * noise, 0.0, 0.999)


# lint: dispatch
def warm_noise_rows(gens: Sequence[torch.Generator],
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """(R, *shape) standard normals, row r from ``gens[r]``, each
    generator left in the state it was in: the jitter of a warm start
    reads the stream the cold population is drawn from next."""
    states = [gen.get_state() for gen in gens]
    noise = randn_rows(gens, shape)
    for gen, state in zip(gens, states):
        gen.set_state(state)
    return noise


class SearchStrategy:
    """Base class / protocol for ask-tell search strategies.

    Concrete strategies are frozen dataclasses.
    """

    # plain class attributes, NOT dataclass fields (subclasses override)
    name = "?"
    device_resident = True
    # whether ``init`` accepts a Population / WarmStart hand-off (the
    # memo's near-hit seeding is gated on this)
    supports_init_population = False
    # whether ``tell`` consumes an (R, P, M) objective matrix instead of
    # an (R, P) scalar column; the driver evaluates via
    # ``evaluate_objectives`` and ranks the anytime best on column 0
    multi_objective = False
    # generations a captured CUDA graph of the loop covers (None: the
    # whole loop, one replay a search; ``graphs.plan_spans``)
    graph_span = None

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


# lint: dispatch
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

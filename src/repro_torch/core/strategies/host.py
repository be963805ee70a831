"""Host-only strategies: methods whose control flow does not fit the
fixed-shape generation loop of ``strategies.driver``.

  cmaes   full-covariance CMA-ES — the per-generation eigendecomposition
          stays the float64 numpy reference
  tbpsa   population size adapts at run time (dynamic shapes)
  a2c/ppo2        RL mappers with host-driven training loops (their
                  rollouts, fitness and updates on the fitness' device)
  herald_like / ai_mt_like   one-shot hand heuristics (single evaluation)

All are registered with ``device_resident=False`` — ``run_strategy``
dispatches them to their host loop, ``run_sweep`` rejects them with a
clear error, and ``available(device_resident=False)`` lists them.  Their
fitness batches go to the ``FitnessFn``'s device.
"""
from __future__ import annotations

from repro_torch.core import heuristics, rl
from repro_torch.core.optimizers import blackbox
from repro_torch.core.strategies.base import HostSearchStrategy
from repro_torch.core.strategies.registry import register


def _host(name, fn):
    def factory():
        return HostSearchStrategy(name=name, fn=fn)
    return factory


register("cmaes", _host("cmaes", blackbox.cma_es),
         device_resident=False, aliases=("cma_es",),
         description="full-covariance CMA-ES, elite = best half (host: "
                     "f64 eigendecomposition)",
         figures="Table IV; Fig. 11")
register("tbpsa", _host("tbpsa", blackbox.tbpsa),
         device_resident=False,
         description="population-size-adaptive ES (host: dynamic "
                     "population shapes)",
         figures="Table IV; Fig. 11")
register("a2c", _host("a2c", rl.a2c),
         device_resident=False,
         description="A2C RL mapper, 3x128 MLP (host training loop)",
         figures="Table IV")
register("ppo2", _host("ppo2", rl.ppo2),
         device_resident=False,
         description="PPO2 RL mapper, 3x128 MLP (host training loop)",
         figures="Table IV")
register("herald_like",
         _host("herald_like",
               lambda fit, budget, seed: heuristics.herald_like(fit)),
         device_resident=False,
         description="greedy earliest-finish-time hand heuristic",
         figures="Fig. 8/9/15; Table IV")
register("ai_mt_like",
         _host("ai_mt_like",
               lambda fit, budget, seed: heuristics.ai_mt_like(fit)),
         device_resident=False,
         description="BW-alternating multi-array hand heuristic",
         figures="Fig. 8/9; Table IV")

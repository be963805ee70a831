"""Ask/tell search-strategy API: the ``SearchStrategy`` protocol, one
device loop (``run_strategy``) and one registry (``get_strategy`` /
``available`` / ``register``).  Only ``magma`` is registered so far.

    from repro_torch.core.strategies import get_strategy, run_strategy
    res = run_strategy(get_strategy("magma"), fitness_fn, budget=10_000,
                       seed=0, device="cuda")
"""
from repro_torch.core.strategies.base import SearchStrategy
from repro_torch.core.strategies.registry import (StrategyInfo, available,
                                                  canonical_name,
                                                  get_strategy, register,
                                                  strategy_info)
from repro_torch.core.strategies.driver import plan_generations, run_strategy
from repro_torch.core.strategies.magma_strategy import (MagmaState,
                                                        MagmaStrategy)

__all__ = [
    "SearchStrategy", "StrategyInfo", "available", "canonical_name",
    "get_strategy", "register", "strategy_info",
    "plan_generations", "run_strategy", "MagmaState", "MagmaStrategy",
]

"""Ask/tell search-strategy API: every optimization method behind one
interface (``SearchStrategy``: ``init``/``ask``/``tell`` over state with a
leading row axis), one generation loop (``scan_strategy``, run for one
problem by ``run_strategy`` and for (scenario x seed) rows by
``repro_torch.core.sweep.run_sweep``) and one registry (``get_strategy``
/ ``available`` / ``register``).  Device-resident strategies (magma,
random, stdga, de, pso, nsga2) run their generations on the search's
device; host-only methods (cmaes, tbpsa, a2c, ppo2, the hand heuristics)
run their own loops behind the same ``SearchResult`` contract, their
fitness batches on the fitness' device.

    from repro_torch.core.strategies import get_strategy, run_strategy
    res = run_strategy(get_strategy("de"), fitness_fn, budget=10_000,
                       seed=0, device="cuda")

Vector-objective contract: a strategy with ``multi_objective = True``
(``nsga2``) receives the (R, P, M) objective matrix in ``tell`` -- the
columns of the problem's ``ObjectiveSpec``, every column higher-is-better
-- and the driver tracks the anytime best on column 0; the non-dominated
set comes from ``repro_torch.core.pareto.pareto_front(fit,
result.final_population)`` (``M3E.search_front``).
"""
from repro_torch.core.strategies.base import (HostSearchStrategy,
                                              SearchStrategy, WarmStart,
                                              decode_continuous,
                                              seed_population)
from repro_torch.core.strategies.registry import (StrategyInfo, available,
                                                  canonical_name,
                                                  get_strategy, register,
                                                  strategy_info)
from repro_torch.core.strategies.driver import (plan_generations,
                                                run_strategy, scan_strategy)
from repro_torch.core.strategies.magma_strategy import (MagmaState,
                                                        MagmaStrategy)
from repro_torch.core.strategies.blackbox import (DEStrategy, PSOStrategy,
                                                  RandomStrategy,
                                                  StdGAStrategy)
from repro_torch.core.strategies.nsga2 import (NSGA2State, NSGA2Strategy,
                                               encode_continuous)
from repro_torch.core.strategies import host as _host  # noqa: F401

__all__ = [
    "SearchStrategy", "HostSearchStrategy", "WarmStart",
    "seed_population", "decode_continuous",
    "StrategyInfo", "available", "canonical_name", "get_strategy",
    "register", "strategy_info",
    "plan_generations", "run_strategy", "scan_strategy",
    "MagmaState", "MagmaStrategy",
    "DEStrategy", "PSOStrategy", "RandomStrategy", "StdGAStrategy",
    "NSGA2State", "NSGA2Strategy", "encode_continuous",
]

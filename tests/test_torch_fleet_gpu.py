"""The scheduling fleet on the card: a 2-worker CUDA fleet (both workers on
the host's cards, round-robin; on a one-card host both share card 0)
returns every row bitwise the standalone card search for its (scenario,
seed), and each worker's reported makespan launches equal one per
generation and batch it dispatched (its warmup's included).

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``card_fleet`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_fleet_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fitness import FitnessFn  # noqa: E402
from repro_torch.core.strategies import get_strategy, run_strategy  # noqa: E402
from repro_torch.fleet import FleetConfig, launch_fleet  # noqa: E402
from repro_torch.stream import (TraceConfig, analyze_serial,  # noqa: E402
                                generate_trace)

BUDGET = 300
TRACE = TraceConfig(num_scenarios=12, group_size=12, settings=("S1", "S2"),
                    mixes=("Heavy", "Light"), bw_ladder_gb=(1.0, 16.0),
                    seed=3)


@pytest.fixture(scope="module")
def card_fleet(tmp_path_factory):
    """One 2-worker fleet for the module (start-up dominates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    trace = generate_trace(TRACE)
    cfg = FleetConfig(num_workers=2, budget=BUDGET, device="cuda",
                      stream={"batch_rows": 4}, chunk_rows=4,
                      memo_path=str(tmp_path_factory.mktemp("fleet")
                                    / "memo"),
                      recompile_guard=True, ready_timeout_s=300.0)
    with launch_fleet(cfg) as fleet:
        fleet.warmup(trace)
        fleet.mark_warm()
        results = fleet.run(trace)
        yield trace, results, fleet.last_metrics, fleet.worker_stats()


@pytest.mark.gpu
def test_fleet_rows_are_bitwise_standalone_card_searches(card_fleet):
    trace, results, metrics, _ = card_fleet
    assert [r.request.uid for r in results] == [t.uid for t in trace]
    assert metrics.steals >= 1
    strat = get_strategy("magma")
    for r in results:
        fit = analyze_serial([r.request])[0].fit
        ref = run_strategy(strat, FitnessFn(fit.table, bw_sys=fit.bw_sys,
                                            objective=fit.objective,
                                            device="cuda"),
                           budget=BUDGET, seed=r.request.seed, device="cuda")
        assert r.best_fitness == ref.best_fitness
        for name in ("best_accel", "best_prio", "history_best"):
            np.testing.assert_array_equal(getattr(r, name),
                                          getattr(ref, name))


@pytest.mark.gpu
def test_fleet_workers_report_one_launch_per_generation_and_batch(
        card_fleet):
    _, results, _, stats = card_fleet
    assert sorted(stats) == ["w0", "w1"]
    for s in stats.values():
        assert s["makespan_launches"] == s["dispatched_generations"] > 0
        # the kernel library loaded during the warmup, nothing after it
        assert s["compiles"] == 1 and s["recompiles_post_warmup"] == 0
    assert sum(s["scenarios"] for s in stats.values()) == len(results)

"""The streaming service on the card: streamed rows are bitwise standalone
card searches, a ``transfer_guard=True`` run completes (no hidden
synchronisation in the dispatch region, warm-seeded rows included), and
each batch launches the makespan kernel once per generation.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fitness import FitnessFn  # noqa: E402
from repro_torch.core.strategies import (get_strategy,  # noqa: E402
                                         plan_generations, run_strategy)
from repro_torch.core.sweep import SweepConfig, run_sweep  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.lint.runtime import transfer_sanitizer  # noqa: E402
from repro_torch.memo import ScheduleMemo  # noqa: E402
from repro_torch.stream import (ScenarioRequest, StreamConfig,  # noqa: E402
                                StreamingScheduler, TraceConfig,
                                analyze_serial, generate_trace)

BUDGET = 300
TRACE = TraceConfig(num_scenarios=8, group_size=12, settings=("S1", "S2"),
                    mixes=("Heavy", "Light"), bw_ladder_gb=(1.0, 16.0),
                    seed=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(fit, device):
    return FitnessFn(fit.table, bw_sys=fit.bw_sys, objective=fit.objective,
                     device=device)


def _same(a, b):
    assert a.best_fitness == b.best_fitness
    for name in ("best_accel", "best_prio", "history_best"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.gpu
def test_streamed_rows_are_bitwise_standalone_card_searches(cuda):
    svc = StreamingScheduler(budget=BUDGET, device=cuda,
                             stream=StreamConfig(batch_rows=4))
    results = svc.run(generate_trace(TRACE))
    assert len(results) == TRACE.num_scenarios
    for r in results:
        fit = _on(analyze_serial([r.request])[0].fit, cuda)
        _same(r, run_strategy(get_strategy("magma"), fit, budget=BUDGET,
                              seed=r.request.seed, device=cuda))
    for b in svc.last_batches:
        assert b.dispatch_s <= b.issued_s <= b.done_s
    svc.close()


@pytest.mark.gpu
def test_transfer_guard_run_completes_with_the_same_rows(cuda):
    trace = generate_trace(TRACE)
    plain = StreamingScheduler(budget=BUDGET, device=cuda,
                               stream=StreamConfig(batch_rows=4))
    want = plain.run(trace)
    guarded = StreamingScheduler(budget=BUDGET, device=cuda,
                                 stream=StreamConfig(batch_rows=4,
                                                     transfer_guard=True))
    for a, b in zip(guarded.run(trace), want):
        _same(a, b)
    # warm-seeded rows and memo records under the guard: a near sibling
    # of a recorded scenario is seeded from its population
    memo = ScheduleMemo()
    svc = StreamingScheduler(budget=BUDGET, device=cuda, memo=memo,
                             stream=StreamConfig(batch_rows=4,
                                                 transfer_guard=True))
    base = ScenarioRequest(uid=0, arrival_s=0.0, mix="Light", setting="S2",
                           bw_gb=16.0, group_size=12, seed=50)
    svc.run([base])
    res = svc.run([base, dataclasses.replace(base, uid=1, bw_gb=8.0,
                                             seed=51)])
    assert res[0].memo_exact and res[1].warm_seeded
    # a sweep under the guard keeps its rows too
    fits = [_on(analyze_serial([r])[0].fit, cuda) for r in trace[:3]]
    sw = run_sweep(fits, budget=BUDGET, seeds=[0, 1], device=cuda,
                   sweep=SweepConfig(chunk_rows=4, transfer_guard=True))
    ref = run_sweep(fits, budget=BUDGET, seeds=[0, 1], device=cuda,
                    sweep=SweepConfig(chunk_rows=4))
    np.testing.assert_array_equal(sw.best_fitness, ref.best_fitness)
    for s in (plain, guarded, svc):
        s.close()


@pytest.mark.gpu
def test_transfer_sanitizer_raises_on_a_sync(cuda):
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        with transfer_sanitizer():
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert x.sum().item() == 4.0


@pytest.mark.gpu
def test_makespan_launches_per_batch_equal_generations(cuda):
    svc = StreamingScheduler(budget=BUDGET, device=cuda,
                             stream=StreamConfig(batch_rows=4))
    trace = generate_trace(TRACE)
    svc.warmup(trace)
    before = mk.LAUNCHES["makespan"]
    svc.run_serial(trace)
    launched = mk.LAUNCHES["makespan"] - before
    want = sum(plan_generations(b.compat_key.budget,
                                b.compat_key.strategy.ask_size)[0]
               for b in svc.last_batches)
    assert len(svc.last_batches) >= 2 and launched == want
    before = mk.LAUNCHES["makespan"]
    svc.run(trace)
    want = sum(plan_generations(b.compat_key.budget,
                                b.compat_key.strategy.ask_size)[0]
               for b in svc.last_batches)
    assert mk.LAUNCHES["makespan"] - before == want
    svc.close()

"""The generation engine on the card: a search's whole loop one replay of
a CUDA graph of the static-buffer step (``repro_torch.core.strategies.graphs``).

- captured equals the host-stepped ``engine="loop"`` bitwise, for every
  device-resident strategy, and replays under seeds other than the one
  the graph was captured with;
- two keys interleaved generation by generation, and two loops of one
  key at once (two shards on one card), equal their searches run alone;
- a stream captures nothing after its warmup (``RecompileGuard``), and a
  shape the warmup did not run is reported;
- the makespan kernel counts one launch a generation, and the first
  search of a key one more for the warm generation before each capture;
- a batch's host-issued launches (the CUDA runtime's calls, profiled)
  are the same at 10 generations and at 100;
- a step's replays stay right after many other configurations have
  been captured (the constants its graph reads stay alive);
- a capture that fails raises.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import magma  # noqa: E402
from repro_torch.core.encoding import row_generators  # noqa: E402
from repro_torch.core.fitness import FitnessFn, FitnessParams  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         get_strategy, plan_generations,
                                         run_strategy)
from repro_torch.core.strategies import graphs  # noqa: E402
from repro_torch.core.strategies.driver import (run_interleaved,  # noqa: E402
                                                scan_steps)
from repro_torch.core.sweep import SweepConfig, run_sweep  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.lint.runtime import RecompileError, RecompileGuard  # noqa: E402
from repro_torch.stream import (StreamConfig, StreamingScheduler,  # noqa: E402
                                TraceConfig, generate_trace)

STRATEGIES = ("magma", "random", "stdga", "de", "pso", "nsga2")
P = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _fit(device, G=16, A=4, seed=0, bw_sys=2.0):
    rng = np.random.default_rng(seed)
    return FitnessFn(table_from_arrays(rng.uniform(0.05, 5.0, (G, A)),
                                       rng.uniform(0.01, 10.0, (G, A)),
                                       rng.uniform(1e6, 1e9, G)),
                     bw_sys=bw_sys, device=device)


def _strategy(name, pop=P):
    if name == "magma":
        return MagmaStrategy(magma.MagmaConfig(population=pop))
    return get_strategy(name, population=pop)


def _same(a, b):
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_accel, b.best_accel)
    np.testing.assert_array_equal(a.best_prio, b.best_prio)
    np.testing.assert_array_equal(a.history_best, b.history_best)


@pytest.mark.gpu
@pytest.mark.parametrize("name", STRATEGIES)
def test_captured_equals_loop_at_seeds_other_than_the_capture(cuda, name):
    fit = _fit(cuda)
    s = _strategy(name)
    graphs.clear()
    for budget in (P * 6, P * 6 + 3):          # both last generations
        for seed in (0, 1, 2, 3):             # seed 0's search captures
            keep = s.supports_init_population
            got = run_strategy(s, fit, budget=budget, seed=seed,
                               device=cuda, keep_population=keep)
            want = run_strategy(s, fit, budget=budget, seed=seed,
                                device=cuda, engine="loop",
                                keep_population=keep)
            _same(got, want)
            if keep:
                assert torch.equal(got.final_population.accel,
                                   want.final_population.accel)
                assert torch.equal(got.final_population.prio,
                                   want.final_population.prio)
    captured = [c for info in graphs.steps_info()
                for c in info["captures"]]
    # one step of one key, a loop graph a budget (the two budgets plan
    # the same loop for a strategy whose last generation always tells)
    assert len(captured) == (1 if getattr(s, "multi_objective", False)
                             else 2)
    assert all(c["generations"] == 6 for c in captured)


@pytest.mark.gpu
def test_sweep_rows_equal_standalone(cuda):
    fits = [_fit(cuda), _fit(cuda, seed=1, bw_sys=5.0)]
    s = _strategy("magma")
    res = run_sweep(fits, budget=P * 5, seeds=(0, 1), strategy=s,
                    sweep=SweepConfig(chunk_rows=3), device=cuda)
    for i, fit in enumerate(fits):
        for k, seed in enumerate((0, 1)):
            _same(res.result(i, k), run_strategy(s, fit, budget=P * 5,
                                                 seed=seed, device=cuda))


@pytest.mark.gpu
def test_two_keys_interleaved_and_one_key_twice(cuda):
    fit = _fit(cuda)
    params = FitnessParams(*(t[None] for t in fit.params))
    gens, evolve_last = plan_generations(P * 5, P)

    def loop(name, seed):
        s = _strategy(name).bind(fit.num_accels)
        state = s.init(row_generators([seed], cuda), params)
        return scan_steps(s, state, params, fit.objective_spec,
                          fit.group_size, gens, evolve_last)

    plan = [("magma", 1), ("de", 2), ("magma", 3)]
    together = run_interleaved([loop(n, s) for n, s in plan])
    for (name, seed), got in zip(plan, together):
        want = run_interleaved([loop(name, seed)])[0]
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_makespan_launches_one_a_generation(cuda):
    fit = _fit(cuda, G=20, A=5)
    s = _strategy("stdga")
    graphs.clear()
    gens, evolve_last = plan_generations(P * 7 + 1, P)
    graphs_a_step = len(set(graphs.plan_spans(gens, evolve_last)))   # 1
    for seed in (0, 1):                   # the capture's search, a replay
        before, then = mk.LAUNCHES["makespan"], graphs.totals()
        run_strategy(s, fit, budget=P * 7 + 1, seed=seed, device=cuda)
        now = graphs.totals()
        captures = now["captures"] - then["captures"]
        warm = now["warm_launches"] - then["warm_launches"]
        # the first search captures its graphs, each after one warm
        # generation that launches the kernel once; a replay captures none
        assert captures == (graphs_a_step if seed == 0 else 0)
        assert warm == captures
        assert mk.LAUNCHES["makespan"] - before == gens + warm


@pytest.mark.gpu
def test_a_step_replays_right_after_many_other_configs(cuda):
    """A graph reads MAGMA's operator CDF by its address: after 40 other
    configurations have captured theirs and the allocator has handed out
    thousands of zeroed small blocks, the first key's replays still
    equal the loop."""
    fit = _fit(cuda)
    first = _strategy("magma")
    budget = P * 4
    graphs.clear()
    run_strategy(first, fit, budget=budget, seed=0, device=cuda)
    for i in range(40):
        other = MagmaStrategy(magma.MagmaConfig(
            population=P, p_crossover_gen=0.01 * (i + 1)))
        run_strategy(other, fit, budget=budget, seed=i, device=cuda)
    junk = [torch.zeros(4, device=cuda) for _ in range(4096)]
    then = graphs.totals()["captures"]
    got = run_strategy(first, fit, budget=budget, seed=5, device=cuda)
    assert graphs.totals()["captures"] == then            # replays only
    _same(got, run_strategy(first, fit, budget=budget, seed=5, device=cuda,
                            engine="loop"))
    del junk


@pytest.mark.gpu
def test_no_capture_after_a_stream_warmup(cuda):
    trace = generate_trace(TraceConfig(
        num_scenarios=8, group_size=12, settings=("S1", "S2"),
        mixes=("Heavy", "Light"), bw_ladder_gb=(1.0, 16.0), seed=3))
    graphs.clear()
    svc = StreamingScheduler(budget=300, device=cuda,
                             stream=StreamConfig(batch_rows=4))
    with RecompileGuard(label="stream") as guard:
        svc.warmup(trace)
        assert any(c.startswith("cuda graph ") for c in guard.compiles)
        guard.warmup()
        svc.run(trace)
        svc.run_serial(trace)
        assert guard.post_warmup == []
    svc.close()
    other = dataclasses.replace(trace[0], group_size=10)
    with RecompileGuard(label="stream") as guard:
        guard.warmup()
        svc2 = StreamingScheduler(budget=300, device=cuda,
                                  stream=StreamConfig(batch_rows=4))
        svc2.run([other])                 # a shape the warmup never ran
        svc2.close()
        assert [c for c in guard.post_warmup if c.startswith("cuda graph ")]
        with pytest.raises(RecompileError, match="cuda graph"):
            guard.check()
        guard.warmup()


# the CUDA runtime's launch calls as torch.profiler names them (host side)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")


@pytest.mark.gpu
def test_a_batch_issues_as_many_launches_at_10_and_100_generations(cuda):
    """An 8-row batch's loop, its graph captured, issues a number of
    host launches that does not depend on its generations."""
    from torch.profiler import ProfilerActivity, profile
    fit = _fit(cuda)
    s = _strategy("magma").bind(fit.num_accels)
    params = FitnessParams(*(torch.stack([t] * 8) for t in fit.params))
    seeds = list(range(8))

    def batch(gens):
        state = s.init(row_generators(seeds, cuda), params)
        return run_interleaved([scan_steps(s, state, params,
                                           fit.objective_spec,
                                           fit.group_size, gens, False)])[0]

    counts = {}
    for gens in (10, 100):
        batch(gens)                          # captures its loop
        torch.cuda.synchronize()
        before = mk.LAUNCHES["makespan"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            batch(gens)
            torch.cuda.synchronize()
        assert mk.LAUNCHES["makespan"] - before == gens
        counts[gens] = sum(e.name in LAUNCH_APIS for e in prof.events()
                           if e.device_type != torch.autograd.DeviceType.CUDA)
    assert counts[10] == counts[100] <= 100, counts


@dataclasses.dataclass(frozen=True)
class _SyncingRandom(type(get_strategy("random"))):
    """Random search whose tell reads a value back: not capturable."""

    def tell(self, state, fitness):
        # lint: disable=L002(the point of this test: a sync fails capture)
        if float(fitness.max()) > 0:
            return super().tell(state, fitness)
        return super().tell(state, fitness)


@pytest.mark.gpu
def test_a_failed_capture_raises(cuda):
    fit = _fit(cuda)
    s = _SyncingRandom(population=P)
    with pytest.raises(RuntimeError):
        run_strategy(s, fit, budget=P * 3, seed=0, device=cuda)
    # the card is usable after it, and the eager loop still runs
    run_strategy(s, fit, budget=P * 3, seed=0, device=cuda, engine="loop")
    torch.cuda.synchronize()

"""The schedule memo on the card: exact hits launch no kernel, and rows
solved on the CPU never exact-hit on the card.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import M3E, MagmaConfig  # noqa: E402
from repro_torch.core.encoding import Population, row_generators  # noqa: E402
from repro_torch.core.fitness import FitnessParams  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         WarmStart, run_strategy)
from repro_torch.core.encoding import to_host  # noqa: E402
from repro_torch.core.sweep import SweepConfig, run_sweep  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.memo import ScheduleMemo  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

CFG = MagmaConfig(population=20)
BUDGET = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b):
    assert a.best_fitness == b.best_fitness
    for name in ("best_accel", "best_prio", "history_best"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.gpu
def test_exact_hit_replays_bitwise_with_no_kernel_launch(cuda):
    group = build_task_groups("Mix", group_size=30, seed=0)[0]
    memo = ScheduleMemo()
    m3e = M3E(get_setting("S4"), bw_sys=256 * GB, memo=memo, device=cuda)
    cold = M3E(get_setting("S4"), bw_sys=256 * GB, device=cuda).search(
        group, budget=BUDGET, seed=0, strategy_kwargs={"cfg": CFG})
    before = mk.LAUNCHES["makespan"]
    first = m3e.search(group, budget=BUDGET, seed=0,
                       strategy_kwargs={"cfg": CFG})
    assert mk.LAUNCHES["makespan"] - before == BUDGET // CFG.population
    _same(first, cold)
    before = mk.LAUNCHES["makespan"]
    again = m3e.search(group, budget=BUDGET, seed=0,
                       strategy_kwargs={"cfg": CFG})
    assert mk.LAUNCHES["makespan"] == before
    assert again.wall_time_s == 0.0
    _same(again, cold)


@pytest.mark.gpu
def test_cpu_rows_never_hit_on_the_card(cuda):
    group = build_task_groups("Mix", group_size=30, seed=0)[0]
    memo = ScheduleMemo()
    on_cpu = M3E(get_setting("S4"), bw_sys=256 * GB, memo=memo, device="cpu")
    on_cpu.search(group, budget=BUDGET, seed=0, strategy_kwargs={"cfg": CFG})
    card = M3E(get_setting("S4"), bw_sys=256 * GB, memo=memo, device=cuda)
    fit = card.prepare(group)
    assert memo.lookup(fit, MagmaStrategy(CFG), BUDGET, 0) is None
    # nor near: the CPU row's population is in the other route's family
    assert memo.warm_start(fit, MagmaStrategy(CFG), family="Mix") is None
    before = mk.LAUNCHES["makespan"]
    res = card.search(group, budget=BUDGET, seed=0,
                      strategy_kwargs={"cfg": CFG})
    assert mk.LAUNCHES["makespan"] > before and res.wall_time_s > 0.0
    assert len(memo) == 2


@pytest.mark.gpu
def test_memoized_sweep_rows_replay_bitwise_on_the_card(cuda):
    groups = build_task_groups("Mix", group_size=30, num_groups=2, seed=0)
    m3e = M3E(get_setting("S4"), bw_sys=256 * GB, device=cuda)
    fits = [m3e.prepare(g) for g in groups]
    memo = ScheduleMemo()
    res = run_sweep(fits, budget=BUDGET, cfg=CFG, seeds=(0, 1), memo=memo,
                    sweep=SweepConfig(chunk_rows=3), device=cuda)
    assert len(memo) == 4
    for s, fit in enumerate(fits):
        for k, seed in enumerate((0, 1)):
            hit = memo.lookup(fit, MagmaStrategy(CFG), BUDGET, seed)
            alone = run_strategy(MagmaStrategy(CFG), fit, budget=BUDGET,
                                 seed=seed, device=cuda)
            _same(hit.to_search_result(), alone)
            assert hit.best_fitness == res.best_fitness[s, k]


@pytest.mark.gpu
def test_to_host_reads_back_mixed_tensors_in_one_copy(cuda):
    xs = (torch.arange(7, dtype=torch.int32, device=cuda).reshape(7, 1),
          torch.rand((3, 5), device=cuda),
          torch.tensor(2.5, device=cuda),
          torch.arange(4, dtype=torch.float64, device=cuda))
    for got, x in zip(to_host(*xs), xs):
        want = x.cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("warm", [True, False])
def test_card_generators_after_init_same_warm_and_cold(cuda, warm):
    group = build_task_groups("Mix", group_size=30, seed=0)[0]
    fit = M3E(get_setting("S4"), bw_sys=256 * GB, device=cuda).prepare(group)
    s = MagmaStrategy(CFG).bind(fit.num_accels)
    rows = FitnessParams(*(torch.stack([t] * 2) for t in fit.params))
    cold = row_generators([3, 9], cuda)
    s.init(cold, rows)
    accel = torch.zeros((2, 20, 30), dtype=torch.int32, device=cuda)
    prio = torch.full((2, 20, 30), 0.5, device=cuda)
    hand = (WarmStart(accel, prio, torch.full((2,), 0.02, device=cuda))
            if warm else Population(accel, prio))
    gens = row_generators([3, 9], cuda)
    s.init(gens, rows, init_population=hand)
    for a, b in zip(cold, gens):
        assert torch.equal(a.get_state(), b.get_state())

"""MAGMA's draw kernel on the card (``repro_torch.kernels.draws``,
``csrc/draws.cu``):

- the kernel equals the plain version bitwise at the sweep's, the
  stream's and a search's shapes, (R, n, G, A) = (48, 90, 100, 4),
  (8, 90, 100, 8) and (1, 90, 100, 8), counters past 2**32 among them,
  at ragged sizes that take its unaligned stores, and with no children
  (n = 0: no launch, the counter still advanced);
- a captured loop's replays equal the same loop run eagerly on the card,
  under the seed it was captured with and under others, and a sweep's
  rows equal their standalone searches;
- ``repro_draws_launches_total`` (and ``draws.LAUNCHES``) counts one
  launch a tell, plus the warm generation's before a capture, as
  ``graphs.tells`` counts MAGMA's tells on the card; an elite-only search
  (P = n_elite) tells and advances its counter, captured, with no
  launch.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import magma  # noqa: E402
from repro_torch.core.fitness import FitnessFn  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         plan_generations, run_strategy)
from repro_torch.core.strategies import driver, graphs  # noqa: E402
from repro_torch.core.encoding import row_generators  # noqa: E402
from repro_torch.core.fitness import FitnessParams  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.core.sweep import run_sweep  # noqa: E402
from repro_torch.kernels import draws as D  # noqa: E402
from repro_torch.obs import get_registry  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _key_ctr(R, seed):
    gen = torch.Generator().manual_seed(seed)
    key = torch.randint(0, 2 ** 32, (R, 2), generator=gen)
    ctr = torch.randint(0, 2 ** 40, (R,), generator=gen)
    ctr[0] = 0
    return key, ctr


@pytest.mark.gpu
@pytest.mark.parametrize("R,n,G,A", [(48, 90, 100, 4), (8, 90, 100, 8),
                                     (1, 90, 100, 8), (5, 7, 3, 2),
                                     (3, 33, 9, 5), (4, 0, 100, 8)])
def test_kernel_equals_plain_bitwise(cuda, R, n, G, A):
    key, ctr = _key_ctr(R, R * n + G)
    slots = magma.generation_slots(n, G, A, magma.MagmaConfig())
    want, want_next = D.draws_plain(key, ctr, slots)
    launched = D.LAUNCHES["draws"]
    got, got_next = D.draws(key.to(cuda), ctr.to(cuda), slots)
    torch.cuda.synchronize()
    assert D.LAUNCHES["draws"] - launched == (1 if n else 0)
    for s, w, g in zip(slots, want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, s
        assert torch.equal(g.cpu(), w), s
    assert torch.equal(got_next.cpu(), want_next)


@pytest.mark.gpu
def test_kernel_checks_its_inputs(cuda):
    key, ctr = (t.to(cuda) for t in _key_ctr(4, 0))
    with pytest.raises(ValueError, match="contiguous"):
        D.draws(key.t().contiguous().t(), ctr, [D.Slot((1,), "float")])
    with pytest.raises(ValueError, match="one device"):
        D.draws(key, ctr.cpu(), [D.Slot((1,), "float")])


def _fit(device, G=16, A=4, seed=0, bw_sys=2.0):
    rng = np.random.default_rng(seed)
    return FitnessFn(table_from_arrays(rng.uniform(0.05, 5.0, (G, A)),
                                       rng.uniform(0.01, 10.0, (G, A)),
                                       rng.uniform(1e6, 1e9, G)),
                     bw_sys=bw_sys, device=device)


def _same(a, b):
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_accel, b.best_accel)
    np.testing.assert_array_equal(a.best_prio, b.best_prio)
    np.testing.assert_array_equal(a.history_best, b.history_best)


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [400, 450], ids=["spent", "evolve_last"])
def test_captured_replays_equal_the_eager_loop(cuda, budget):
    graphs.clear()
    fit = _fit(cuda)
    s = MagmaStrategy(magma.MagmaConfig(population=20))
    for seed in (0, 7, 2 ** 31 + 5):        # the first seed captures
        got = run_strategy(s, fit, budget=budget, seed=seed, device=cuda,
                           keep_population=True)
        want = driver._search(s, fit, budget, seed, cuda, "scan", None, True,
                              capture=False)
        _same(got, want)
        assert torch.equal(got.final_population.accel,
                           want.final_population.accel)


@pytest.mark.gpu
def test_sweep_rows_equal_standalone_searches(cuda):
    fits = [_fit(cuda, seed=k, bw_sys=b) for k, b in ((0, 1.0), (1, 4.0))]
    s = MagmaStrategy(magma.MagmaConfig(population=20))
    seeds = (3, 4, 5)
    res = run_sweep(fits, budget=300, seeds=seeds, strategy=s, device=cuda)
    for i, fit in enumerate(fits):
        for k, seed in enumerate(seeds):
            _same(res.result(i, k), run_strategy(s, fit, budget=300,
                                                 seed=seed, device=cuda))


@pytest.mark.gpu
def test_launch_counter_counts_one_a_tell(cuda):
    graphs.clear()
    metric = get_registry().counter("repro_draws_launches_total")
    fit = _fit(cuda, G=20, A=8)
    s = MagmaStrategy(magma.MagmaConfig(population=25))
    generations, evolve_last = plan_generations(1_000, 25)
    tells = generations - 1 + evolve_last
    for first in (True, False):
        before, counted = metric.value(), D.LAUNCHES["draws"]
        told = graphs.tells("cuda").get("magma", 0)
        run_strategy(s, fit, budget=1_000, seed=1, device=cuda)
        warm = 1 if first else 0            # the warm generation's
        assert metric.value() - before == tells + warm
        assert D.LAUNCHES["draws"] - counted == tells + warm
        assert graphs.tells("cuda")["magma"] - told == tells + warm


@pytest.mark.gpu
def test_an_elite_only_search_launches_no_draw_kernel(cuda):
    graphs.clear()
    fit = _fit(cuda)
    s = MagmaStrategy(magma.MagmaConfig(population=1)).bind(fit.num_accels)
    assert s.n_elite == s.ask_size == 1
    params = FitnessParams(*(t[None] for t in fit.params))
    for first in (True, False):
        state = s.init(row_generators([4], cuda), params)
        drawn, evaluated = D.LAUNCHES["draws"], mk.LAUNCHES["makespan"]
        told = graphs.tells("cuda").get("magma", 0)
        *_, hist, after = driver.scan_strategy(
            s, state, params, fit.objective_spec, fit.group_size, 5, False)
        torch.cuda.synchronize()
        assert after.ctr.tolist() == [4] and hist.shape == (1, 5)
        assert torch.equal(after.accel, state.accel)
        assert D.LAUNCHES["draws"] == drawn
        assert mk.LAUNCHES["makespan"] - evaluated == 5 + first
        assert graphs.tells("cuda")["magma"] - told == 4 + first

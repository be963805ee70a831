"""MAGMA's counter-based draws (``repro_torch.kernels.draws``) on the CPU:
the plain version, which the card's kernel is held to bitwise
(``tests/test_torch_draws_gpu.py``).

- Philox4x32-10 gives the published known answers (Random123's
  ``kat_vectors``);
- a row's draws are a function of its key and counter alone: row r is
  bitwise the same drawn among 48 rows or alone, and the next counter
  draws anew;
- every slot of a generation is uniform over its range by a chi-squared
  test at 9,000 values (bound: the 1 - 1e-4 quantile);
- ``MagmaStrategy`` keys each row from its generator right after the
  population and advances the counter once a tell, a generation with no
  children (P = n_elite) too;
- the plain route counts no kernel launch; the graph engine and the
  host-stepped loop count each strategy's tells by device
  (``graphs.tells``), which a card's draw launches are held to;
- only MAGMA's memo fingerprints name its draw stream.

The module imports no JAX.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import magma  # noqa: E402
from repro_torch.core.encoding import (random_population,  # noqa: E402
                                       row_generators)
from repro_torch.core.fitness import FitnessFn, FitnessParams  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         get_strategy, plan_generations,
                                         run_strategy)
from repro_torch.core.strategies import graphs  # noqa: E402
from repro_torch.core.strategies.driver import scan_strategy  # noqa: E402
from repro_torch.memo import strategy_signature  # noqa: E402
from repro_torch.kernels import draws as D  # noqa: E402
from repro_torch.obs import get_registry  # noqa: E402

CFG = magma.MagmaConfig()


def _words(*values):
    return [torch.tensor([v], dtype=torch.int64) for v in values]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(ctr, key, want):
    got = D.philox(*_words(*ctr), *_words(*key))
    assert tuple(int(w) for w in got) == want


def test_element_layout_is_the_counter():
    """Element e of slot s is word e % 4 of the block at (e // 4, s,
    ctr low, ctr high), as the kernel's note and the module say."""
    key = torch.tensor([[0x1234, 0xfedcba98]])
    ctr = torch.tensor([2 ** 33 + 7])
    slot = D.Slot((11,), "float")
    out = D.draws_plain(key, ctr, [D.Slot((3,), "int", 0, 5), slot])[0][1][0]
    for e in range(11):
        u = D.philox(*_words(e // 4, 1, 7, 2), *_words(0x1234, 0xfedcba98))
        assert float(out[e]) == (int(u[e % 4]) >> 8) * 2.0 ** -24


@pytest.mark.parametrize("n,G,A", [(90, 100, 4), (9, 17, 6), (3, 1, 1)])
def test_a_row_draws_the_same_alone_or_among_48(n, G, A):
    gen = torch.Generator().manual_seed(G)
    key = torch.randint(0, 2 ** 32, (48, 2), generator=gen)
    ctr = torch.randint(0, 2 ** 40, (48,), generator=gen)
    many, many_next = magma.draw_generation_rows(key, ctr, n, G, A, CFG)
    assert torch.equal(many_next, ctr + 1)
    for r in (0, 17, 47):
        one, _ = magma.draw_generation_rows(key[r:r + 1], ctr[r:r + 1], n, G,
                                            A, CFG)
        for name, a, b in zip(magma.GenerationDraws._fields, one, many):
            assert torch.equal(a[0], b[r]), (r, name)


def test_the_next_counter_draws_anew():
    key = torch.tensor([[5, 6], [5, 6]])
    a, b = (magma.draw_generation_rows(key, torch.tensor([c, c + 1]), 90,
                                       100, 8, CFG)[0] for c in (0, 1))
    for name, x, y in zip(magma.GenerationDraws._fields, a, b):
        assert torch.equal(x[1], y[0]), name           # both counter 1
        assert not torch.equal(x[0], x[1]), name       # counter 0 -> 1
        assert not torch.equal(x[1], y[1]), name       # counter 1 -> 2


def _chi2_bound(df: int, tail_z: float = 3.719) -> float:
    """The 1 - 1e-4 quantile of chi-squared with ``df`` degrees of freedom
    (Wilson-Hilferty; a little above the exact value at df = 1)."""
    h = 2.0 / (9.0 * df)
    return df * (1.0 - h + tail_z * math.sqrt(h)) ** 3


@pytest.mark.parametrize("key,ctr", [((0, 0), 0), ((0xdeadbeef, 7), 99),
                                     ((123456789, 0xffffffff), 2 ** 32 + 1)])
def test_every_slot_is_uniform_at_9000_values(key, ctr):
    slots = [s._replace(shape=(9000,))
             for s in magma.generation_slots(90, 100, 8, CFG)]
    out, _ = D.draws_plain(torch.tensor([key]), torch.tensor([ctr]), slots)
    for i, (s, x) in enumerate(zip(slots, out)):
        x = x[0]
        if s.kind == "int":
            assert int(x.min()) >= s.lo and int(x.max()) < s.hi, i
            counts = torch.bincount((x - s.lo).long(), minlength=s.hi - s.lo)
        elif s.kind == "float":
            assert float(x.min()) >= 0.0 and float(x.max()) < 1.0, i
            counts = torch.bincount((x * 64).long(), minlength=64)
        else:
            counts = torch.bincount(x.long(), minlength=2)
        k = counts.numel()
        if k < 2:
            continue
        want = 9000 / k
        chi2 = float(((counts.double() - want) ** 2 / want).sum())
        assert chi2 < _chi2_bound(k - 1), (i, s, chi2)


def test_plain_version_checks_its_inputs():
    key = torch.zeros((2, 2), dtype=torch.int64)
    ctr = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="key"):
        D.draws(key.int(), ctr, [D.Slot((1,), "float")])
    with pytest.raises(ValueError, match="ctr"):
        D.draws(key, ctr[:1], [D.Slot((1,), "float")])
    with pytest.raises(ValueError, match="int slot"):
        D.draws(key, ctr, [D.Slot((1,), "int", 3, 3)])
    with pytest.raises(ValueError, match="slots"):
        D.draws(key, ctr, [D.Slot((1,), "float")] * (D.MAX_SLOTS + 1))
    with pytest.raises(ValueError, match="CUDA"):
        D.draws_cuda(key, ctr, [D.Slot((1,), "float")])


def _fit(G=12, A=3, seed=0):
    rng = np.random.default_rng(seed)
    return FitnessFn(table_from_arrays(rng.uniform(0.05, 5.0, (G, A)),
                                       rng.uniform(0.01, 10.0, (G, A)),
                                       rng.uniform(1e6, 1e9, G)),
                     bw_sys=2.0, device="cpu")


def test_magma_keys_each_row_after_its_population():
    fit, seeds = _fit(), [3, 11]
    s = MagmaStrategy(magma.MagmaConfig(population=10)).bind(fit.num_accels)
    params = FitnessParams(*(t[None].expand((2,) + t.shape)
                             for t in fit.params))
    state = s.init(row_generators(seeds, "cpu"), params)
    for r, seed in enumerate(seeds):
        gen = torch.Generator().manual_seed(seed)
        pop = random_population(gen, 10, fit.group_size, fit.num_accels,
                                "cpu")
        assert torch.equal(pop.accel, state.accel[r])
        want = torch.randint(0, 2 ** 32, (2,), generator=gen)
        assert torch.equal(state.key[r], want)
    assert state.ctr.tolist() == [0, 0]
    fitness = torch.zeros((2, 10))
    after = s.tell(state, fitness)
    assert after.ctr.tolist() == [1, 1] and after.key is state.key


def test_a_cpu_search_launches_no_draw_kernel():
    metric = get_registry().counter("repro_draws_launches_total")
    before, counted = metric.value(), D.LAUNCHES["draws"]
    run_strategy(MagmaStrategy(magma.MagmaConfig(population=10)), _fit(),
                 budget=50, seed=0, device="cpu")
    assert metric.value() == before and D.LAUNCHES["draws"] == counted


def test_no_children_draw_nothing_and_advance_the_counter():
    slots = magma.generation_slots(0, 100, 8, CFG)
    out, nxt = D.draws(torch.tensor([[1, 2], [3, 4]]), torch.tensor([5, 0]),
                       slots)
    assert [tuple(t.shape) for t in out] == [(2,) + s.shape for s in slots]
    assert [t.dtype for t in out] == [torch.int32, torch.int32, torch.float32,
                                      torch.bool] + [torch.int32] * 5 + [
        torch.float32, torch.int32, torch.float32]
    assert nxt.tolist() == [6, 1]


def test_an_elite_only_search_advances_its_counter():
    fit = _fit()
    s = MagmaStrategy(magma.MagmaConfig(population=1)).bind(fit.num_accels)
    assert s.n_elite == s.ask_size == 1
    params = FitnessParams(*(t[None] for t in fit.params))
    state = s.init(row_generators([4], "cpu"), params)
    *_, hist, after = scan_strategy(s, state, params, fit.objective_spec,
                                    fit.group_size, 5, False)
    assert hist.shape == (1, 5) and after.ctr.tolist() == [4]
    assert torch.equal(after.accel, state.accel)      # the elite, kept


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_tells_are_counted_by_strategy_and_device(engine):
    generations, evolve_last = plan_generations(50, 10)
    for name in ("magma", "pso"):
        s = (MagmaStrategy(magma.MagmaConfig(population=10))
             if name == "magma" else get_strategy(name, population=10))
        before = graphs.tells("cpu").get(name, 0)
        card = graphs.tells("cuda").get(name, 0)
        run_strategy(s, _fit(), budget=50, seed=0, device="cpu",
                     engine=engine)
        assert graphs.tells("cpu")[name] - before == \
            generations - 1 + evolve_last
        assert graphs.tells("cuda").get(name, 0) == card


def test_only_magma_names_its_draw_stream_in_memo_fingerprints():
    m = MagmaStrategy(magma.MagmaConfig(population=10)).bind(3)
    assert strategy_signature(m) == repr(m) + "|draws=philox4x32-10-ctr"
    for name in ("random", "stdga", "de", "pso", "nsga2"):
        other = get_strategy(name, population=10).bind(3)
        assert strategy_signature(other) == repr(other), name

"""The generation engine (``repro_torch.core.strategies.graphs``) on the CPU.

On a card a search's whole ask/tell loop is one replay of a CUDA graph
of the static-buffer step; here the same loop runs eagerly through
``driver.scan_steps``.  Held here:

- the step equals the host-stepped ``engine="loop"`` bitwise for every
  device-resident strategy, at R = 1 (``run_strategy``) and R = 3
  (``run_sweep`` rows), with ``evolve_last`` true and false, and with a
  ``Population`` / ``WarmStart`` hand-off where a strategy takes one;
- a sweep row equals its standalone search;
- the whole loop as one span equals it one generation a span and in
  spans with a remainder, histories and final states too, and each row
  its ``engine="loop"`` search: every strategy, R = 1 and 3, both last
  generations, warm-started rows;
- equal-but-distinct configurations give one cache key and share one
  step; another (R, P, G, A) gives another key, another generation
  count another span of the step; two loops of one key live at once get
  a step each;
- the slice against the reference: MAGMA's generations run through the
  step with the reference's own draws injected give bitwise the
  populations of the reference's generation body
  (``repro.core.magma._next_generation_body``) fed the same fitness, and
  the reference's fitness agrees within rtol 1e-5;
- the launch-count diversion, ``RecompileGuard``'s count of a capture,
  and the operator CDF's cache, which a captured graph reads by address.

Card-only checks (captured equals loop, replays under other seeds,
captures after warmup, launches per replay) are in
``tests/test_torch_graph_gpu.py``.
"""
from typing import NamedTuple, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import magma as ref_magma  # noqa: E402
from repro.core.fitness import FitnessFn as RefFitnessFn  # noqa: E402
from repro.core.job_analyzer import table_from_arrays as ref_table  # noqa: E402
from repro_torch.core import magma  # noqa: E402
from repro_torch.core.encoding import Population  # noqa: E402
from repro_torch.core.fitness import FitnessFn, FitnessParams  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.strategies import (MagmaStrategy,  # noqa: E402
                                         WarmStart, get_strategy,
                                         plan_generations, run_strategy)
from repro_torch.core.strategies import graphs  # noqa: E402
from repro_torch.core.strategies.driver import (run_interleaved,  # noqa: E402
                                                scan_steps, scan_strategy)
from repro_torch.core.encoding import row_generators  # noqa: E402
from repro_torch.core.sweep import SweepConfig, run_rows, run_sweep  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import draws as draws_kernel  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.lint.runtime import RecompileError, RecompileGuard  # noqa: E402
from repro_torch.obs import get_registry  # noqa: E402

STRATEGIES = ("magma", "random", "stdga", "de", "pso", "nsga2")
P = 8


def _problem(G=16, A=4, seed=0, bw_sys=2.0):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.05, 5.0, (G, A))
    bw = rng.uniform(0.01, 10.0, (G, A))
    flops = rng.uniform(1e6, 1e9, G)
    return (RefFitnessFn(ref_table(lat, bw, flops), bw_sys=bw_sys),
            FitnessFn(table_from_arrays(lat, bw, flops), bw_sys=bw_sys,
                      device="cpu"))


FIT = _problem()[1]


def _strategy(name, pop=P):
    if name == "magma":
        return MagmaStrategy(magma.MagmaConfig(population=pop))
    return get_strategy(name, population=pop)


def _budget(evolve_last, gens=4):
    return P * gens + (3 if evolve_last else 0)


def _same(a, b, population=False):
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_accel, b.best_accel)
    np.testing.assert_array_equal(a.best_prio, b.best_prio)
    np.testing.assert_array_equal(a.history_best, b.history_best)
    if population:
        assert torch.equal(a.final_population.accel,
                           b.final_population.accel)
        assert torch.equal(a.final_population.prio, b.final_population.prio)


@pytest.mark.parametrize("evolve_last", [True, False],
                         ids=["evolve_last", "spent"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_step_equals_loop_one_row(name, evolve_last):
    s = _strategy(name)
    keep = s.supports_init_population
    budget = _budget(evolve_last)
    assert plan_generations(budget, P)[1] == evolve_last
    got = run_strategy(s, FIT, budget=budget, seed=5, device="cpu",
                       keep_population=keep)
    want = run_strategy(s, FIT, budget=budget, seed=5, device="cpu",
                        engine="loop", keep_population=keep)
    _same(got, want, population=keep)


@pytest.mark.parametrize("evolve_last", [True, False],
                         ids=["evolve_last", "spent"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_step_equals_loop_three_rows(name, evolve_last):
    s = _strategy(name)
    budget = _budget(evolve_last)
    seeds = (2, 7, 11)
    res = run_sweep([FIT], budget=budget, seeds=seeds, strategy=s,
                    device="cpu")
    assert res.padded_rows == 3 and res.chunk_rows == 3
    for k, seed in enumerate(seeds):
        _same(res.result(0, k), run_strategy(
            s, FIT, budget=budget, seed=seed, device="cpu", engine="loop"))


def _hand_off(kind, G=16, A=4, seed=0):
    rng = np.random.default_rng(seed)
    accel = rng.integers(0, A, (P, G)).astype(np.int32)
    prio = rng.random((P, G)).astype(np.float32)
    if kind == "population":
        return Population(accel=torch.as_tensor(accel),
                          prio=torch.as_tensor(prio))
    return WarmStart(accel=accel, prio=prio, jitter=np.float32(0.05))


@pytest.mark.parametrize("evolve_last", [True, False],
                         ids=["evolve_last", "spent"])
@pytest.mark.parametrize("kind", ["population", "warm_start"])
@pytest.mark.parametrize("name", ["magma", "nsga2"])
def test_step_with_hand_off_equals_loop(name, kind, evolve_last):
    s = _strategy(name)
    budget = _budget(evolve_last)
    init = _hand_off(kind)
    got = run_strategy(s, FIT, budget=budget, seed=3, device="cpu",
                       init_population=init, keep_population=True)
    want = run_strategy(s, FIT, budget=budget, seed=3, device="cpu",
                        engine="loop", init_population=init,
                        keep_population=True)
    _same(got, want, population=True)


@pytest.mark.parametrize("name", ["magma", "nsga2"])
def test_warm_rows_equal_loop(name):
    s = _strategy(name).bind(FIT.num_accels)
    seeds = np.array([4, 9, 13])
    warms = [_hand_off("warm_start", seed=k) for k in range(3)]
    warm = WarmStart(accel=np.stack([w.accel for w in warms]),
                     prio=np.stack([w.prio for w in warms]),
                     jitter=np.float32(0.05))
    budget = _budget(True)
    gens, evolve_last = plan_generations(budget, P)
    rows = FitnessParams(*(torch.stack([t] * 3) for t in FIT.params))
    rr = run_rows(rows, seeds, strategy=s, generations=gens,
                  evolve_last=evolve_last, objective=FIT.objective_spec,
                  device="cpu", warm=warm)
    for i, seed in enumerate(seeds):
        want = run_strategy(s, FIT, budget=budget, seed=int(seed),
                            device="cpu", engine="loop",
                            init_population=warms[i])
        assert rr.best_fitness[i] == want.best_fitness
        np.testing.assert_array_equal(rr.best_accel[i], want.best_accel)
        np.testing.assert_array_equal(rr.best_prio[i], want.best_prio)
        np.testing.assert_array_equal(rr.history_best[i], want.history_best)


def test_sweep_rows_equal_standalone_searches():
    """Four rows in chunks of three (the last padded): each row is its
    standalone search, though the two run under other step keys (R = 3
    and R = 1)."""
    s = _strategy("magma")
    budget = _budget(False)
    seeds = (0, 1)
    fits = [FIT, _problem(seed=1, bw_sys=5.0)[1]]
    res = run_sweep(fits, budget=budget, seeds=seeds, strategy=s,
                    sweep=SweepConfig(chunk_rows=3), device="cpu")
    assert res.num_chunks == 2 and res.padded_rows == 6
    for i, fit in enumerate(fits):
        for k, seed in enumerate(seeds):
            _same(res.result(i, k), run_strategy(s, fit, budget=budget,
                                                 seed=seed, device="cpu"))


def _key(strategy, fit, rows=1, seeds=None):
    s = strategy.bind(fit.num_accels)
    params = FitnessParams(*(torch.stack([t] * rows) for t in fit.params))
    state = s.init(row_generators(seeds or range(rows), "cpu"), params)
    return graphs.step_key(s, params, state, fit.objective_spec,
                           fit.group_size)


def test_equal_configs_give_one_key_and_share_one_step():
    a = MagmaStrategy(magma.MagmaConfig(population=P))
    b = MagmaStrategy(magma.MagmaConfig(population=P))
    assert a is not b and a.cfg is not b.cfg
    ka, kb = _key(a, FIT), _key(b, FIT, seeds=[99])
    assert ka == kb and hash(ka) == hash(kb)
    budget = _budget(False)
    run_strategy(a, FIT, budget=budget, seed=0, device="cpu")
    run_strategy(b, FIT, budget=budget, seed=1, device="cpu")
    assert sum(1 for info in graphs.steps_info()
               if info["label"] == ka.label()) == 1


def test_other_shapes_give_other_keys():
    base = _key(_strategy("magma"), FIT)
    others = {
        "R": _key(_strategy("magma"), FIT, rows=2),
        "P": _key(_strategy("magma", pop=P + 2), FIT),
        "G": _key(_strategy("magma"), _problem(G=12)[1]),
        "A": _key(_strategy("magma"), _problem(A=3)[1]),
        "strategy": _key(_strategy("random"), FIT),
        "config": _key(MagmaStrategy(magma.MagmaConfig(
            population=P, mutation_rate=0.2)), FIT),
    }
    for what, key in others.items():
        assert key != base, what
    assert len(set(others.values())) == len(others)


def test_interleaved_loops_of_one_key_get_a_step_each():
    s = _strategy("de").bind(FIT.num_accels)
    params = FitnessParams(*(t[None] for t in FIT.params))
    gens, evolve_last = plan_generations(_budget(False), P)

    def loop(seed):
        state = s.init(row_generators([seed], "cpu"), params)
        return scan_steps(s, state, params, FIT.objective_spec,
                          FIT.group_size, gens, evolve_last)

    key = _key(s, FIT)
    graphs.clear()
    both = run_interleaved([loop(1), loop(2)])
    assert sum(1 for info in graphs.steps_info()
               if info["label"] == key.label()) == 2
    for seed, got in zip((1, 2), both):
        want = run_interleaved([loop(seed)])[0]
        for a, b in zip(got[:4], want[:4]):
            assert torch.equal(a, b)


def test_scan_steps_yields_once_a_generation(monkeypatch):
    s = _strategy("pso").bind(FIT.num_accels)
    monkeypatch.setattr(type(s), "graph_span", 1)   # a graph a generation
    params = FitnessParams(*(t[None] for t in FIT.params))
    state = s.init(row_generators([0], "cpu"), params)
    steps = scan_steps(s, state, params, FIT.objective_spec, FIT.group_size,
                       5, False)
    n = 0
    with pytest.raises(StopIteration) as stop:
        while True:
            next(steps)
            n += 1
    assert n == 5
    bf, ba, bp, hist, _ = stop.value.value
    assert hist.shape == (1, 5) and bool(torch.all(hist[:, -1] == bf))


def test_plan_spans():
    assert graphs.plan_spans(5, False) == [(5, False)]
    assert graphs.plan_spans(5, True) == [(5, True)]
    assert graphs.plan_spans(3, False, 1) == [(1, True), (1, True),
                                              (1, False)]
    assert graphs.plan_spans(7, False, 3) == [(3, True), (3, True),
                                              (1, False)]
    assert graphs.plan_spans(6, True, 3) == [(3, True), (3, True)]
    assert graphs.plan_spans(6, False, 3) == [(3, True), (3, False)]
    assert graphs.plan_spans(2, True, 9) == [(2, True)]


def test_scan_steps_yields_once_a_loop(monkeypatch):
    """By default the whole loop is one span: one run, one yield."""
    s = _strategy("pso").bind(FIT.num_accels)
    params = FitnessParams(*(t[None] for t in FIT.params))

    def loop():
        state = s.init(row_generators([0], "cpu"), params)
        return scan_steps(s, state, params, FIT.objective_spec,
                          FIT.group_size, 5, False)

    before = graphs.totals()["runs"]
    steps, n = loop(), 0
    with pytest.raises(StopIteration) as stop:
        while True:
            next(steps)
            n += 1
    assert n == 1 and graphs.totals()["runs"] == before + 1
    monkeypatch.setattr(type(s), "graph_span", 1)
    want = run_interleaved([loop()])[0]
    for a, b in zip(stop.value.value[:4], want[:4]):
        assert torch.equal(a, b)


def _rows(rows):
    return FitnessParams(*(torch.stack([t] * rows) for t in FIT.params))


def _loop_spans(monkeypatch, s, params, seeds, budget, warm=None):
    """The rows' loop with the whole loop as one span, one a generation,
    and two a span with a remainder: each result, and the spans run."""
    gens, evolve_last = plan_generations(budget, P)
    out = {}
    for span in (None, 1, 2):
        monkeypatch.setattr(type(s), "graph_span", span)
        state = s.init(row_generators(seeds, "cpu"), params,
                       init_population=warm)
        before = graphs.totals()["runs"]
        out[span] = run_interleaved([scan_steps(
            s, state, params, FIT.objective_spec, FIT.group_size, gens,
            evolve_last)])[0]
        tell_last = evolve_last or getattr(s, "multi_objective", False)
        assert graphs.totals()["runs"] - before == len(
            graphs.plan_spans(gens, tell_last, span))
    for span in (1, 2):
        for a, b in zip(out[None][:4], out[span][:4]):
            assert torch.equal(a, b), span
        for a, b in zip(graphs.state_tensors(out[None][4]),
                        graphs.state_tensors(out[span][4])):
            assert torch.equal(a, b), span
    return out[None]


@pytest.mark.parametrize("evolve_last", [True, False],
                         ids=["evolve_last", "spent"])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("name", STRATEGIES)
def test_loop_span_equals_per_generation_and_loop(name, rows, evolve_last,
                                                  monkeypatch):
    """The whole loop as one span equals it a generation at a time (and
    in spans of two with a remainder), histories and final states too,
    and every row its host-stepped ``engine="loop"`` search."""
    s = _strategy(name).bind(FIT.num_accels)
    seeds = [2, 7, 11][:rows]
    budget = _budget(evolve_last, gens=5)
    bf, ba, bp, hist, _ = _loop_spans(monkeypatch, s, _rows(rows), seeds,
                                      budget)
    for r, seed in enumerate(seeds):
        want = run_strategy(s, FIT, budget=budget, seed=seed, device="cpu",
                            engine="loop")
        assert float(bf[r]) == want.best_fitness
        np.testing.assert_array_equal(ba[r].numpy(), want.best_accel)
        np.testing.assert_array_equal(bp[r].numpy(), want.best_prio)
        np.testing.assert_array_equal(hist[r].numpy().astype(np.float64),
                                      want.history_best)


@pytest.mark.parametrize("name", ["magma", "nsga2"])
def test_loop_span_with_warm_rows_equals_per_generation_and_loop(
        name, monkeypatch):
    s = _strategy(name).bind(FIT.num_accels)
    seeds = [4, 9, 13]
    warms = [_hand_off("warm_start", seed=k) for k in range(3)]
    warm = WarmStart(accel=torch.as_tensor(np.stack([w.accel for w in warms])),
                     prio=torch.as_tensor(np.stack([w.prio for w in warms])),
                     jitter=torch.full((3,), 0.05))
    budget = _budget(True, gens=5)
    bf, ba, bp, hist, _ = _loop_spans(monkeypatch, s, _rows(3), seeds,
                                      budget, warm)
    for r, seed in enumerate(seeds):
        want = run_strategy(s, FIT, budget=budget, seed=seed, device="cpu",
                            engine="loop", init_population=warms[r])
        assert float(bf[r]) == want.best_fitness
        np.testing.assert_array_equal(ba[r].numpy(), want.best_accel)
        np.testing.assert_array_equal(bp[r].numpy(), want.best_prio)
        np.testing.assert_array_equal(hist[r].numpy().astype(np.float64),
                                      want.history_best)


def test_equal_configs_share_a_loop_key_and_other_generations_another():
    """A loop's graph key is its step's key and its span: equal
    configurations run one span of one step; another generation count
    or a last generation that tells adds a span to that step."""
    a = MagmaStrategy(magma.MagmaConfig(population=P))
    b = MagmaStrategy(magma.MagmaConfig(population=P))
    key = _key(a, FIT)
    graphs.clear()

    def spans():
        found = [info["spans"] for info in graphs.steps_info()
                 if info["label"] == key.label()]
        assert len(found) == 1
        return found[0]

    run_strategy(a, FIT, budget=_budget(False), seed=0, device="cpu")
    run_strategy(b, FIT, budget=_budget(False), seed=1, device="cpu")
    assert spans() == [(4, False)]
    run_strategy(b, FIT, budget=_budget(False, gens=6), seed=0,
                 device="cpu")
    run_strategy(a, FIT, budget=_budget(True), seed=0, device="cpu")
    assert spans() == [(4, False), (4, True), (6, False)]


def test_capture_needs_a_card():
    s = _strategy("random").bind(FIT.num_accels)
    params = FitnessParams(*(t[None] for t in FIT.params))
    state = s.init(row_generators([0], "cpu"), params)
    with pytest.raises(ValueError, match="needs a card"):
        scan_strategy(s, state, params, FIT.objective_spec, FIT.group_size,
                      2, False, capture=True)


def test_a_state_field_the_step_cannot_carry_raises():
    class Odd(NamedTuple):
        gens: Tuple[torch.Generator, ...]
        X: torch.Tensor
        note: str

    state = Odd(gens=row_generators([0], "cpu"), X=torch.zeros(1, P, 4),
                note="host")
    with pytest.raises(TypeError, match="note"):
        graphs.state_tensors(state)


def test_launches_inside_counted_into_go_to_its_dict():
    metric = get_registry().counter("repro_draws_launches_total")
    before, drawn = mk.LAUNCHES["makespan"], metric.value()
    with _build.counted_into({}) as captured:
        _build.count_launch("makespan")
        _build.count_launch("makespan")
        _build.count_launch("draws")
    assert captured == {"makespan": 2, "draws": 1}
    assert mk.LAUNCHES["makespan"] == before and metric.value() == drawn
    _build.add_launches(captured)
    assert mk.LAUNCHES["makespan"] == before + 2
    assert metric.value() == drawn + 1 and draws_kernel.LAUNCHES["draws"] >= 1
    _build.count_launch("makespan")
    assert mk.LAUNCHES["makespan"] == before + 3


def test_recompile_guard_counts_a_capture():
    # a capture reports itself as this compile event (graphs._capture)
    name = "cuda graph magma R=1 P=100 G=100 A=8 throughput cuda:0"
    with RecompileGuard(label="graphs") as guard:
        _build.notify_compile(name, 0.01)          # before the boundary
        guard.warmup()
        assert guard.post_warmup == []
        _build.notify_compile(name + " last", 0.01)
        assert guard.post_warmup == [name + " last"]
        with pytest.raises(RecompileError, match="cuda graph magma R=1"):
            guard.check()
        guard.warmup()                    # accept it, so __exit__ passes
    assert guard.warmup_compiles == [name, name + " last"]
    _build.notify_compile(name, 0.01)     # the guard has left
    assert len(guard.compiles) == 2


def test_the_operator_cdf_outlives_any_number_of_other_configs():
    """A captured graph reads the CDF by its address: the cache that
    holds it must not drop it, however many configurations follow."""
    dev = torch.device("cpu")
    first = magma._operator_cdf(magma.MagmaConfig(population=P), dev)
    for i in range(40):
        magma._operator_cdf(magma.MagmaConfig(
            population=P, p_crossover_gen=0.01 * (i + 1)), dev)
    assert magma._operator_cdf(magma.MagmaConfig(population=P),
                               dev) is first


# ---------------------------------------------------------------------------
# the slice against the reference, the reference's draws injected
# ---------------------------------------------------------------------------
def _reference_draws(gen_key, n_child, G, A, n_elite):
    """The twelve draws of ``_next_generation_body``, in its split order."""
    (kd, km, kop, kwh, kpv, kra, krb, kac, krr, kmm, kma,
     kmp) = jax.random.split(gen_key, 12)
    return magma.GenerationDraws(
        dads=jax.random.randint(kd, (n_child,), 0, n_elite),
        moms=jax.random.randint(km, (n_child,), 0, n_elite),
        u_op=jax.random.uniform(kop, (n_child,)),
        which=jax.random.bernoulli(kwh, shape=(n_child, 1)),
        pivot=jax.random.randint(kpv, (n_child, 1), 1, max(G, 2)),
        ra=jax.random.randint(kra, (n_child, 1), 0, G),
        rb=jax.random.randint(krb, (n_child, 1), 0, G),
        a_sel=jax.random.randint(kac, (n_child, 1), 0, A),
        rebalance=jax.random.randint(krr, (n_child, G), 0, A,
                                     dtype=jnp.int32),
        u_mut=jax.random.uniform(kmm, (n_child, G)),
        mut_accel=jax.random.randint(kma, (n_child, G), 0, A,
                                     dtype=jnp.int32),
        mut_prio=jax.random.uniform(kmp, (n_child, G), dtype=jnp.float32),
    )


class InjectedState(NamedTuple):
    gens: Tuple[torch.Generator, ...]
    accel: torch.Tensor      # (1, P, G)
    prio: torch.Tensor       # (1, P, G)
    t: torch.Tensor          # (1,) int64: the generation to draw for
    dads: torch.Tensor       # this and the rest: (T, 1, ...) draws
    moms: torch.Tensor
    u_op: torch.Tensor
    which: torch.Tensor
    pivot: torch.Tensor
    ra: torch.Tensor
    rb: torch.Tensor
    a_sel: torch.Tensor
    rebalance: torch.Tensor
    u_mut: torch.Tensor
    mut_accel: torch.Tensor
    mut_prio: torch.Tensor


class InjectedMagma(MagmaStrategy):
    """MAGMA whose ``tell`` reads generation ``t``'s draws from its state
    (the reference's, stacked) instead of drawing them."""

    def tell(self, state, fitness):
        draws = magma.GenerationDraws(*(
            torch.index_select(getattr(state, f), 0, state.t)[0]
            for f in magma.GenerationDraws._fields))
        accel, prio = magma.next_generation_body(
            state.accel, state.prio, fitness, draws, self.cfg,
            self.num_accels, self.n_elite)
        return state._replace(accel=accel, prio=prio, t=state.t + 1)


@pytest.mark.parametrize("evolve_last", [True, False],
                         ids=["evolve_last", "spent"])
def test_magma_through_the_step_with_reference_draws(evolve_last):
    ref_fit, fit = _problem(G=20, A=4, seed=3)
    cfg = magma.MagmaConfig(population=12)
    G, A, Pp, n_elite = 20, 4, cfg.population, cfg.n_elite
    T = 5
    rng = np.random.default_rng(7)
    accel = rng.integers(0, A, (Pp, G)).astype(np.int32)
    prio = rng.random((Pp, G)).astype(np.float32)

    # the reference's generations, each population's fitness the port's
    # (the two fitnesses agree to rtol 1e-5, not bitwise, and a near tie
    # among the elites would order them differently): the step is held
    # to the reference's generation body, the fitness to the reference's
    keys = jax.random.split(jax.random.PRNGKey(11), T)
    ra, rp = jnp.asarray(accel), jnp.asarray(prio)
    hist, best = [], -np.inf
    pops = []
    for g in range(T):
        a, p = np.array(ra), np.array(rp)
        f = fit(torch.as_tensor(a), torch.as_tensor(p)).numpy()
        np.testing.assert_allclose(f, np.asarray(ref_fit(ra, rp)),
                                   rtol=1e-5)
        best = max(best, float(f.max()))
        hist.append(best)
        if g + 1 < T or evolve_last:
            ra, rp = ref_magma._next_generation_body(
                keys[g], ra, rp, jnp.asarray(f), cfg, A, n_elite)
        pops.append((np.asarray(ra), np.asarray(rp)))
    # lint: disable=L001(the port must be fed the very draws of these keys)
    draws = [_reference_draws(keys[g], Pp - n_elite, G, A, n_elite)
             for g in range(T)]
    stacked = {name: torch.stack([torch.as_tensor(np.array(d[j]))[None]
                                  for d in draws])
               for j, name in enumerate(magma.GenerationDraws._fields)}

    s = InjectedMagma(cfg).bind(A)
    params = FitnessParams(*(t[None] for t in fit.params))
    state = InjectedState(
        gens=row_generators([0], "cpu"),
        accel=torch.as_tensor(accel)[None], prio=torch.as_tensor(prio)[None],
        t=torch.zeros(1, dtype=torch.int64), **stacked)
    bf, ba, bp, got_hist, out = scan_strategy(
        s, state, params, fit.objective_spec, G, T, evolve_last)
    np.testing.assert_array_equal(out.accel[0].numpy(), pops[-1][0])
    np.testing.assert_array_equal(out.prio[0].numpy(), pops[-1][1])
    assert int(out.t) == (T if evolve_last else T - 1)
    np.testing.assert_array_equal(got_hist[0].numpy(),
                                  np.asarray(hist, dtype=np.float32))

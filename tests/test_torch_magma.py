"""Port parity: one MAGMA generation and the search's budget plan.

The reference draws a generation's random numbers from a JAX key inside
``repro.core.magma._next_generation_body``.  Here the test recomputes
those twelve draws from the same key, hands them to the port's
deterministic ``next_generation_body``, and requires the next population
to be bitwise the reference's.  ``draw_generation`` must give the same
shapes, ranges and dtypes from a ``torch.Generator``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import magma as ref_magma  # noqa: E402
from repro.core.fitness import FitnessFn as RefFitnessFn  # noqa: E402
from repro.core.job_analyzer import table_from_arrays as ref_table  # noqa: E402
from repro.core.strategies import get_strategy as ref_get  # noqa: E402
from repro.core.strategies import plan_generations as ref_plan  # noqa: E402
from repro.core.strategies import run_strategy as ref_run  # noqa: E402
from repro_torch.convert import population_from_numpy  # noqa: E402
from repro_torch.core import magma  # noqa: E402
from repro_torch.core.fitness import FitnessFn  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.strategies import (get_strategy,  # noqa: E402
                                         plan_generations, run_strategy)

CONFIGS = [
    magma.MagmaConfig(),
    magma.MagmaConfig(population=37, elite_frac=0.2, mutation_rate=0.3,
                      p_crossover_gen=0.3, p_crossover_rg=0.3,
                      p_crossover_accel=0.3),
    magma.MagmaConfig(population=20, enable_crossover_gen=False),
]


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


@pytest.mark.parametrize("cfg", CONFIGS, ids=["paper", "mixed", "ablated"])
@pytest.mark.parametrize("G,A", [(23, 5), (100, 8), (1, 3)])
def test_generation_bitwise_with_reference_draws(cfg, G, A):
    P, n_elite = cfg.population, cfg.n_elite
    rng = np.random.default_rng(G * 31 + A)
    accel = rng.integers(0, A, (P, G)).astype(np.int32)
    prio = rng.random((P, G)).astype(np.float32)
    # quantized fitness: ties among the elites exercise the stable order
    fit = np.round(rng.random(P) * 8).astype(np.float32)
    gen_key = jax.random.PRNGKey(G + A + P)

    want_accel, want_prio = ref_magma._next_generation_body(
        gen_key, jnp.asarray(accel), jnp.asarray(prio), jnp.asarray(fit),
        cfg, A, n_elite)
    # lint: disable=L001(the port must be fed the very draws of this key)
    ref_draws = _reference_draws(gen_key, P - n_elite, G, A, n_elite)

    draws = magma.GenerationDraws(*(torch.tensor(np.asarray(d))
                                    for d in ref_draws))
    pop = population_from_numpy(accel, prio, "cpu")
    got_accel, got_prio = magma.next_generation_body(
        pop.accel, pop.prio, torch.as_tensor(fit), draws, cfg, A, n_elite)
    assert got_accel.dtype == torch.int32 and got_prio.dtype == torch.float32
    np.testing.assert_array_equal(got_accel.numpy(), np.asarray(want_accel))
    np.testing.assert_array_equal(got_prio.numpy(), np.asarray(want_prio))


@pytest.mark.parametrize("cfg", CONFIGS[:2], ids=["paper", "mixed"])
def test_draws_shapes_ranges_dtypes_match_reference(cfg):
    G, A = 17, 6
    n_child = cfg.population - cfg.n_elite
    ref = _reference_draws(jax.random.PRNGKey(0), n_child, G, A, cfg.n_elite)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    got = magma.draw_generation(gen, n_child, G, A, cfg)
    highs = dict(dads=cfg.n_elite, moms=cfg.n_elite, pivot=G, ra=G, rb=G,
                 a_sel=A, rebalance=A, mut_accel=A)
    for name, r, g in zip(magma.GenerationDraws._fields, ref, got):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, name
        assert g.numpy().dtype == r.dtype, name
        if name in highs:
            lo = 1 if name == "pivot" else 0
            assert int(g.min()) >= lo and int(g.max()) < highs[name], name
        elif g.dtype == torch.float32:
            assert float(g.min()) >= 0.0 and float(g.max()) < 1.0, name


def _tiny_problem():
    rng = np.random.default_rng(0)
    G, A = 8, 2
    lat = rng.uniform(0.05, 5.0, (G, A))
    bw = rng.uniform(0.01, 10.0, (G, A))
    flops = rng.uniform(1e6, 1e9, G)
    return (RefFitnessFn(ref_table(lat, bw, flops), bw_sys=2.0),
            FitnessFn(table_from_arrays(lat, bw, flops), bw_sys=2.0,
                      device="cpu"))


@pytest.mark.parametrize("budget", [10_000, 250, 99])
def test_budget_plan_and_history_match_reference(budget):
    assert plan_generations(budget, 100) == ref_plan(budget, 100)
    ref_fit, fit = _tiny_problem()
    want = ref_run(ref_get("magma"), ref_fit, budget=budget, seed=0)
    got = run_strategy(get_strategy("magma"), fit, budget=budget, seed=0,
                       device="cpu")
    np.testing.assert_array_equal(got.history_samples, want.history_samples)
    assert got.n_samples == want.n_samples
    assert got.history_best.shape == want.history_best.shape
    assert np.all(np.diff(got.history_best) >= 0)
    assert got.history_best[-1] == got.best_fitness


def test_same_seed_same_search_and_population_hand_off():
    _, fit = _tiny_problem()
    a = magma.magma_search(fit, budget=500, seed=3, device="cpu",
                           keep_population=True)
    b = magma.magma_search(fit, budget=500, seed=3, device="cpu")
    assert a.best_fitness == b.best_fitness
    np.testing.assert_array_equal(a.best_accel, b.best_accel)
    assert b.final_population is None
    c = magma.magma_search(fit, budget=500, seed=4, device="cpu",
                           init_population=a.final_population)
    assert c.best_fitness >= a.best_fitness   # elites survive the hand-off

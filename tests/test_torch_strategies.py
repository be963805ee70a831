"""Port parity: the strategy API — MAGMA's single-child operators, the
device-resident baselines' generations, the registry, and whole searches.

The two packages draw from different generators (JAX threefry, torch
Philox), so a step is held exactly by injecting the reference's own
random draws: the test recomputes them from the reference's key, in its
split order, and hands them to the port's deterministic body.  Genomes
and states must then be bitwise the reference's.

A whole search is judged over seeds, as ``tests/test_torch_m3e.py`` judges
MAGMA: on S2 / Mix at G=20 with a 1,000-sample budget, the geomean of the
port's best fitness over eight seeds must lie within ``RATIO_TOL`` of the
reference's, per method.  ``measure_ratio_spread`` below is the
measurement behind that tolerance (run this file as a script): on the
CPU, over five disjoint sets of eight seeds, the ratios ranged over
0.9806-1.0299 (random), 0.9974-1.0038 (stdga), 0.9783-1.0152 (de) and
0.9716-1.0163 (pso); MAGMA's 0.9955-1.0101.
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
from repro.core.m3e import M3E as RefM3E  # noqa: E402
from repro.core.strategies import base as ref_base  # noqa: E402
from repro.core.strategies import blackbox as ref_bb  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core import magma  # noqa: E402
from repro_torch.core.m3e import M3E, geomean  # noqa: E402
from repro_torch.core.strategies import (HostSearchStrategy,  # noqa: E402
                                         available, decode_continuous,
                                         get_strategy, strategy_info)
from repro_torch.core.strategies import blackbox as bb  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

SEEDS = range(8)
BUDGET = 1_000
RATIO_TOL = {"magma": 0.03, "random": 0.04, "stdga": 0.03, "de": 0.03,
             "pso": 0.04}


def _t(x):
    return torch.as_tensor(np.array(x))


def _pair(rng, G, A):
    accel = rng.integers(0, A, (2, G)).astype(np.int32)
    prio = rng.random((2, G)).astype(np.float32)
    return ((jnp.asarray(accel[0]), jnp.asarray(prio[0])),
            (jnp.asarray(accel[1]), jnp.asarray(prio[1])),
            (_t(accel[0]), _t(prio[0])), (_t(accel[1]), _t(prio[1])))


def _child_draws(draws, i, cfg):
    """Child ``i``'s numbers from one row's unbatched generation draws,
    its operator chosen by the body's inverse CDF."""
    cdf = magma._operator_cdf(cfg, draws.u_op.device)
    op = int(torch.searchsorted(cdf, draws.u_op[i:i + 1], right=True)[0])
    return magma.ChildDraws(
        op=op, which=bool(draws.which[i, 0]), pivot=int(draws.pivot[i, 0]),
        ra=int(draws.ra[i, 0]), rb=int(draws.rb[i, 0]),
        a_sel=int(draws.a_sel[i, 0]), rebalance=draws.rebalance[i],
        u_mut=draws.u_mut[i], mut_accel=draws.mut_accel[i],
        mut_prio=draws.mut_prio[i])


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# MAGMA's single-child operators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,A", [(13, 4), (20, 8)])
@pytest.mark.parametrize("seed", range(2))
def test_single_child_operators_equal_reference(G, A, seed):
    rng = np.random.default_rng(seed)
    jdad, jmom, dad, mom = _pair(rng, G, A)
    key = jax.random.PRNGKey(seed)
    k_mu, k_gen, k_rg, k_ac, k_child = jax.random.split(key, 5)

    km, ka, kp = jax.random.split(k_mu, 3)
    draws = (jax.random.uniform(km, (G,)),
             jax.random.randint(ka, (G,), 0, A, dtype=jnp.int32),
             jax.random.uniform(kp, (G,), dtype=jnp.float32))
    # lint: disable=L001(the reference splits the key the port's draws came from)
    want = ref_magma._mutate(k_mu, jdad[0], jdad[1], 0.3, A)
    _eq(magma._mutate(dad[0], dad[1], 0.3, *map(_t, draws)), want)

    kg, kpv = jax.random.split(k_gen)
    which = bool(jax.random.bernoulli(kg))
    pivot = int(jax.random.randint(kpv, (), 1, G))
    # lint: disable=L001(the reference splits the key the port's draws came from)
    want = ref_magma._crossover_gen(k_gen, jdad, jmom)
    _eq(magma._crossover_gen(dad, mom, which, pivot), want)

    k1, k2 = jax.random.split(k_rg)
    a, b = (int(jax.random.randint(k, (), 0, G)) for k in (k1, k2))
    # lint: disable=L001(the reference splits the key the port's draws came from)
    want = ref_magma._crossover_rg(k_rg, jdad, jmom)
    _eq(magma._crossover_rg(dad, mom, a, b), want)

    ka, kr = jax.random.split(k_ac)
    a_sel = int(jax.random.randint(ka, (), 0, A))
    rnd = _t(jax.random.randint(kr, (G,), 0, A, dtype=jnp.int32))
    # lint: disable=L001(the reference splits the key the port's draws came from)
    want = ref_magma._crossover_accel(k_ac, jdad, jmom, A)
    _eq(magma._crossover_accel(dad, mom, a_sel, rnd), want)

    cfg = magma.MagmaConfig(p_crossover_gen=0.3, p_crossover_rg=0.3,
                            p_crossover_accel=0.3, mutation_rate=0.2)
    kop, kg, krg, kac, kmu = jax.random.split(k_child, 5)
    p = jnp.array([0.3, 0.3, 0.3])
    p = jnp.concatenate([p, jnp.maximum(1.0 - p.sum(), 0.0)[None]])
    op = int(jax.random.choice(kop, 4, p=p / p.sum()))
    kw, kpv = jax.random.split(kg)
    k1, k2 = jax.random.split(krg)
    ka, kr = jax.random.split(kac)
    km, kma, kmp = jax.random.split(kmu, 3)
    d = magma.ChildDraws(
        op=op, which=bool(jax.random.bernoulli(kw)),
        pivot=int(jax.random.randint(kpv, (), 1, G)),
        ra=int(jax.random.randint(k1, (), 0, G)),
        rb=int(jax.random.randint(k2, (), 0, G)),
        a_sel=int(jax.random.randint(ka, (), 0, A)),
        rebalance=_t(jax.random.randint(kr, (G,), 0, A, dtype=jnp.int32)),
        u_mut=_t(jax.random.uniform(km, (G,))),
        mut_accel=_t(jax.random.randint(kma, (G,), 0, A, dtype=jnp.int32)),
        mut_prio=_t(jax.random.uniform(kmp, (G,), dtype=jnp.float32)))
    # lint: disable=L001(the reference splits the key the port's draws came from)
    want = ref_magma._make_child(k_child, jdad, jmom, cfg, A)
    _eq(magma._make_child(dad, mom, d, cfg), want)


@pytest.mark.parametrize("cfg", [magma.MagmaConfig(population=30),
                                 magma.MagmaConfig(population=25,
                                                   p_crossover_gen=0.3,
                                                   p_crossover_rg=0.3,
                                                   p_crossover_accel=0.3)])
def test_batched_generation_equals_make_child_per_child_and_row(cfg):
    R, P, G, A = 3, cfg.population, 17, 6
    rng = np.random.default_rng(P)
    accel = _t(rng.integers(0, A, (R, P, G)).astype(np.int32))
    prio = _t(rng.random((R, P, G)).astype(np.float32))
    fit = _t(np.round(rng.random((R, P)) * 6).astype(np.float32))
    gens = []
    for r in range(R):
        gens.append(torch.Generator().manual_seed(40 + r))
    n = P - cfg.n_elite
    draws = magma.draw_generation_rows(gens, n, G, A, cfg)
    got_a, got_p = magma.next_generation_body(accel, prio, fit, draws, cfg,
                                              A, cfg.n_elite)
    for r in range(R):
        row = magma.GenerationDraws(*(d[r] for d in draws))
        a1, p1 = magma.next_generation_body(accel[r], prio[r], fit[r], row,
                                            cfg, A, cfg.n_elite)
        assert torch.equal(a1, got_a[r]) and torch.equal(p1, got_p[r])
        order = torch.argsort(-fit[r], stable=True)[:cfg.n_elite]
        e_a, e_p = accel[r][order], prio[r][order]
        for i in range(n):
            dad = (e_a[row.dads[i]], e_p[row.dads[i]])
            mom = (e_a[row.moms[i]], e_p[row.moms[i]])
            ca, cp = magma._make_child(dad, mom,
                                       _child_draws(row, i, cfg), cfg)
            assert torch.equal(ca, got_a[r, cfg.n_elite + i])
            assert torch.equal(cp, got_p[r, cfg.n_elite + i])
    one = magma.draw_generation(torch.Generator().manual_seed(40), n, G, A,
                                cfg)
    for d1, dr in zip(one, draws):
        assert torch.equal(d1, dr[0])


# ---------------------------------------------------------------------------
# device-resident baselines: one step with the reference's draws injected
# ---------------------------------------------------------------------------
def _state_arrays(seed, P, d):
    rng = np.random.default_rng(seed)
    X = rng.random((P, d)).astype(np.float32)
    fit = np.round(rng.random(P) * 5).astype(np.float32)   # ties
    return X, fit


@pytest.mark.parametrize("P,G,A", [(20, 10, 4), (33, 16, 8)])
def test_decode_continuous_equals_reference(P, G, A):
    X, _ = _state_arrays(1, P, 2 * G)
    X[0, :G] = 1.0                                  # the top edge clamps
    want = ref_base.decode_continuous(jnp.asarray(X), A)
    _eq(decode_continuous(_t(X)[None], A), [w[None] for w in want])


@pytest.mark.parametrize("P,G", [(20, 10), (41, 16)])
def test_stdga_step_equals_reference(P, G):
    d = 2 * G
    X, fit = _state_arrays(P, P, d)
    strat = ref_bb.StdGAStrategy(population=P, num_accels=4)
    key = jax.random.PRNGKey(P)
    want = strat.tell(ref_bb.StdGAState(key=key, X=jnp.asarray(X)),
                      jnp.asarray(fit))
    # lint: disable=L001(the port is fed the very draws of this key)
    _, kd, km, kc, kp, kmask, kmut = jax.random.split(key, 7)
    ne, n = strat.n_elite, P - strat.n_elite
    draws = bb.StdGADraws(
        dads=jax.random.randint(kd, (n,), 0, ne),
        moms=jax.random.randint(km, (n,), 0, ne),
        u_cross=jax.random.uniform(kc, (n, 1)),
        pivot=jax.random.randint(kp, (n, 1), 1, max(d, 2)),
        u_mut=jax.random.uniform(kmask, (n, d)),
        mut=jax.random.uniform(kmut, (n, d)))
    got = bb.stdga_body(_t(X)[None], _t(fit)[None],
                        bb.StdGADraws(*(_t(x)[None] for x in draws)), ne,
                        strat.crossover_rate, strat.mutation_rate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.X))
    assert get_strategy("std_ga", population=P).n_elite == ne


@pytest.mark.parametrize("P,G", [(20, 10), (37, 16)])
def test_de_step_equals_reference(P, G):
    d = 2 * G
    X, fit = _state_arrays(P + 1, P, d)
    strat = ref_bb.DEStrategy(population=P, num_accels=4)
    key = jax.random.PRNGKey(P)
    state = ref_bb.DEState(key=key, X=jnp.asarray(X), fit=jnp.asarray(fit),
                           trial=jnp.asarray(X))
    rstate, _, _ = strat.ask(state)
    # lint: disable=L001(the port is fed the very draws of this key)
    _, ki, kc, kj = jax.random.split(key, 4)
    idx = jax.vmap(lambda k: jax.random.choice(k, P, (3,), replace=False))(
        jax.random.split(ki, P))
    draws = bb.DEDraws(idx=_t(idx)[None],
                       u_cross=_t(jax.random.uniform(kc, (P, d)))[None],
                       jrand=_t(jax.random.randint(kj, (P,), 0, d))[None])
    trial = bb.de_trial(_t(X)[None], draws, 0.8, 0.8)
    np.testing.assert_array_equal(trial[0].numpy(), np.asarray(rstate.trial))
    new_fit = np.round(np.random.default_rng(2).random(P) * 5).astype(
        np.float32)
    want = strat.tell(rstate, jnp.asarray(new_fit))
    port = bb.DEStrategy(population=P, num_accels=4)
    got = port.tell(bb.DEState(gens=(), X=_t(X)[None], fit=_t(fit)[None],
                               trial=trial), _t(new_fit)[None])
    np.testing.assert_array_equal(got.X[0].numpy(), np.asarray(want.X))
    np.testing.assert_array_equal(got.fit[0].numpy(), np.asarray(want.fit))
    # the port's donor draw: distinct, in range, every row its own
    g = draws_rows = bb.draw_de((torch.Generator().manual_seed(0),), P, d)
    i = g.idx[0]
    assert int(i.min()) >= 0 and int(i.max()) < P
    assert bool((i[:, 0] != i[:, 1]).all() & (i[:, 0] != i[:, 2]).all()
                & (i[:, 1] != i[:, 2]).all())
    assert draws_rows.u_cross.shape == (1, P, d)


@pytest.mark.parametrize("P,G", [(20, 10), (29, 16)])
def test_pso_step_equals_reference(P, G):
    d = 2 * G
    rng = np.random.default_rng(P)
    arr = {k: rng.random((P, d)).astype(np.float32)
           for k in ("X", "V", "pbest")}
    arr["V"] = (arr["V"] - 0.5) * 0.1
    pbest_f = np.round(rng.random(P) * 4).astype(np.float32)
    pbest_f[:3] = -np.inf
    gbest = rng.random(d).astype(np.float32)
    fit = np.round(rng.random(P) * 6).astype(np.float32)
    strat = ref_bb.PSOStrategy(population=P, num_accels=4)
    key = jax.random.PRNGKey(P)
    want = strat.tell(ref_bb.PSOState(
        key=key, X=jnp.asarray(arr["X"]), V=jnp.asarray(arr["V"]),
        pbest=jnp.asarray(arr["pbest"]), pbest_f=jnp.asarray(pbest_f),
        gbest=jnp.asarray(gbest), gbest_f=jnp.float32(3.0)),
        jnp.asarray(fit))
    # lint: disable=L001(the port is fed the very draws of this key)
    _, kr = jax.random.split(key)
    r = _t(jax.random.uniform(kr, (2, P, d)))[None]
    got = bb.pso_body(bb.PSOState(
        gens=(), X=_t(arr["X"])[None], V=_t(arr["V"])[None],
        pbest=_t(arr["pbest"])[None], pbest_f=_t(pbest_f)[None],
        gbest=_t(gbest)[None], gbest_f=torch.tensor([3.0])), _t(fit)[None],
        r, 0.8, 0.8, 1.6)
    for name in ("X", "V", "pbest", "pbest_f", "gbest", "gbest_f"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_random_tell_redraws_uniform_batch():
    gens = (torch.Generator().manual_seed(3), torch.Generator().manual_seed(4))
    strat = bb.RandomStrategy(population=12, num_accels=4)
    params = type("P", (), {"lat": torch.zeros((2, 9, 4))})()
    state = strat.init(gens, params)
    nxt = strat.tell(state, torch.zeros((2, 12)))
    assert nxt.X.shape == (2, 12, 18) and not torch.equal(nxt.X, state.X)
    assert float(nxt.X.min()) >= 0.0 and float(nxt.X.max()) < 1.0
    alone = strat.init((torch.Generator().manual_seed(4),), params)
    assert torch.equal(alone.X[0], state.X[1])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry_kinds_and_host_adapters():
    assert available(device_resident=True) == (
        "de", "magma", "nsga2", "pso", "random", "stdga")
    assert available(device_resident=False) == (
        "a2c", "ai_mt_like", "cmaes", "herald_like", "ppo2", "tbpsa")
    assert strategy_info("std_ga").name == "stdga"
    assert strategy_info("cma_es").name == "cmaes"
    host = get_strategy("tbpsa")
    assert isinstance(host, HostSearchStrategy) and not host.device_resident
    with pytest.raises(ValueError, match="host-only"):
        host.ask_size
    with pytest.raises(ValueError, match="population"):
        get_strategy("de", cfg=None)


# ---------------------------------------------------------------------------
# whole searches, statistically
# ---------------------------------------------------------------------------
def _problems():
    ref = RefM3E(ref_setting("S2"), bw_sys=16 * GB)
    port = M3E(get_setting("S2"), bw_sys=16 * GB, device="cpu")
    return (ref, ref_groups("Mix", group_size=20, seed=0)[0],
            port, build_task_groups("Mix", group_size=20, seed=0)[0])


def _ratio(method, seeds):
    ref, ref_group, port, group = _problems()
    want = [ref.search(ref_group, method=method, budget=BUDGET, seed=s)
            .best_fitness for s in seeds]
    got = []
    for s in seeds:
        res = port.search(group, method=method, budget=BUDGET, seed=s)
        assert res.n_samples == BUDGET and res.history_best.shape == (10,)
        got.append(res.best_fitness)
    return geomean(got) / geomean(want)


@pytest.mark.parametrize("method", ["random", "stdga", "de", "pso"])
def test_search_geomean_matches_reference(method):
    ratio = _ratio(method, SEEDS)
    assert abs(ratio - 1.0) <= RATIO_TOL[method], ratio


def measure_ratio_spread(n_sets=5):
    """The measurement behind ``RATIO_TOL``: per method, the geomean ratio
    over ``n_sets`` disjoint sets of eight seeds."""
    for method in RATIO_TOL:
        ratios = [_ratio(method, range(8 * k, 8 * k + 8))
                  for k in range(n_sets)]
        print(f"{method}: port/reference geomean ratios "
              f"{', '.join(f'{r:.4f}' for r in ratios)}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_strategies.py
    measure_ratio_spread()

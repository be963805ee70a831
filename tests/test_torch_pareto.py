"""Port parity: the multi-objective tier — ``core/pareto.py``, NSGA-II and
``M3E.search_front``.

``nd_ranks``, ``crowding_distance``, ``crowded_order``,
``non_dominated_mask`` and ``hypervolume`` must equal the reference's
exactly on random matrices with ties (objective values drawn from a few
levels).  One NSGA-II generation, fed the reference's own random draws
(recomputed from its key in its split order), must give the reference's
survivors (archive genomes and objectives) bitwise, and its offspring
within 1e-6: the SBX spread and the polynomial mutation raise to
fractional powers, and XLA's float32 ``pow`` is not PyTorch's -- they
differ by one ulp on ~0.3-0.6% of draws (measured on the CPU, 1,163 of
200,000 at the SBX exponent; neither is correctly rounded), which the
offspring arithmetic carries at most a few ulps further.
``search_front`` returns non-dominated points whose objective rows equal
``FitnessFn.objectives`` of their genomes at rtol 1e-5 (the reference's
values, through the reference's evaluator), and an nsga2 sweep row
equals its standalone search.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import pareto as ref_pareto  # noqa: E402
from repro.core.m3e import M3E as RefM3E  # noqa: E402
from repro.core.strategies import nsga2 as ref_nsga2  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core import pareto  # noqa: E402
from repro_torch.core.m3e import M3E  # noqa: E402
from repro_torch.core.strategies import (get_strategy,  # noqa: E402
                                         run_strategy)
from repro_torch.core.strategies import nsga2  # noqa: E402
from repro_torch.core.sweep import run_sweep  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402


def _t(x):
    return torch.as_tensor(np.array(x))


def _matrix(seed, N, M, levels):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, (N, M)) / levels).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("N,M,levels", [(12, 2, 4), (40, 3, 5), (64, 2, 50),
                                        (17, 1, 3)])
def test_ranks_crowding_and_order_equal_reference(seed, N, M, levels):
    F = _matrix(seed, N, M, levels)
    want_rank = ref_pareto.nd_ranks(jnp.asarray(F))
    rank = pareto.nd_ranks(_t(F))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want_rank))
    want_crowd = ref_pareto.crowding_distance(jnp.asarray(F), want_rank)
    crowd = pareto.crowding_distance(_t(F), rank)
    np.testing.assert_array_equal(crowd.numpy(), np.asarray(want_crowd))
    np.testing.assert_array_equal(
        pareto.crowded_order(rank, crowd).numpy(),
        np.asarray(ref_pareto.crowded_order(want_rank, want_crowd)))
    np.testing.assert_array_equal(
        pareto.domination_matrix(_t(F)).numpy(),
        np.asarray(ref_pareto.domination_matrix(jnp.asarray(F))))
    # rows stay independent
    two = pareto.nd_ranks(_t(np.stack([F, F[::-1].copy()])))
    assert torch.equal(two[0], rank)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("M", [2, 3])
def test_front_mask_and_hypervolume_equal_reference(seed, M):
    F = _matrix(seed, 30, M, 6)
    np.testing.assert_array_equal(pareto.non_dominated_mask(F),
                                  ref_pareto.non_dominated_mask(F))
    ref = np.full(M, -0.1)
    assert pareto.hypervolume(F, ref) == ref_pareto.hypervolume(F, ref)


@pytest.mark.parametrize("P,G,M", [(16, 8, 2), (24, 12, 3), (20, 10, 1)])
def test_nsga2_generation_equals_reference_with_its_draws(P, G, M):
    d = 2 * G
    rng = np.random.default_rng(P + M)
    X = rng.random((P, d)).astype(np.float32)
    arch_X = rng.random((P, d)).astype(np.float32)
    arch_F = _matrix(P, P, M, 5)
    fit = _matrix(P + 1, P, M, 5)
    strat = ref_nsga2.NSGA2Strategy(pop_size=P, num_accels=4)
    key = jax.random.PRNGKey(P)
    want = strat.tell(ref_nsga2.NSGA2State(
        key=key, X=jnp.asarray(X), arch_X=jnp.asarray(arch_X),
        arch_F=jnp.asarray(arch_F)),
        jnp.asarray(fit if M > 1 else fit[:, 0]))
    # lint: disable=L001(the port is fed the very draws of this key)
    _, ka, kb, ksel, ku, kdel, kmask = jax.random.split(key, 7)
    draws = nsga2.NSGA2Draws(
        t1=jax.random.randint(ka, (2, P), 0, P),
        t2=jax.random.randint(kb, (2, P), 0, P),
        u=jax.random.uniform(ku, (P, d)),
        u_cross=jax.random.uniform(ksel, (P, 1)),
        u_delta=jax.random.uniform(kdel, (P, d)),
        u_mut=jax.random.uniform(kmask, (P, d)))
    got = nsga2.nsga2_body(
        nsga2.NSGA2State(gens=(), X=_t(X)[None], arch_X=_t(arch_X)[None],
                         arch_F=_t(arch_F)[None]), _t(fit)[None],
        nsga2.NSGA2Draws(*(_t(x)[None] for x in draws)), 15.0, 20.0, 0.9)
    for name in ("arch_X", "arch_F"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.X[0].numpy(), np.asarray(want.X), rtol=0,
                               atol=1e-6)
    accel = np.array([[0, 3, 1]], np.int32)
    prio = np.array([[0.25, 0.5, 0.75]], np.float32)
    np.testing.assert_array_equal(
        nsga2.encode_continuous(_t(accel), _t(prio), 4).numpy(),
        np.asarray(ref_nsga2.encode_continuous(jnp.asarray(accel),
                                               jnp.asarray(prio), 4)))


def _problems():
    return (RefM3E(ref_setting("S2"), bw_sys=16 * GB),
            ref_groups("Mix", group_size=12, seed=0)[0],
            M3E(get_setting("S2"), bw_sys=16 * GB, device="cpu"),
            build_task_groups("Mix", group_size=12, seed=0)[0])


def test_search_front_points_are_non_dominated_and_evaluate_back():
    ref, ref_group, port, group = _problems()
    objectives = ("latency", "energy", "edp")
    front = port.search_front(group, objectives, budget=320, seed=1,
                              strategy_kwargs={"population": 32})
    assert len(front) >= 1 and front.names == objectives
    assert pareto.non_dominated_mask(front.objectives).all()
    ref_fit = ref.prepare(ref_group, objective=objectives)
    want = np.asarray(ref_fit.objectives(jnp.asarray(front.accel),
                                         jnp.asarray(front.prio)))
    np.testing.assert_allclose(front.objectives, want, rtol=1e-5)
    assert front.n_samples == 320
    assert np.all(np.diff(front.objectives[:, 0]) <= 0)
    with pytest.raises(ValueError, match="single-objective"):
        port.search_front(group, objectives, method="magma", budget=100)


def test_nsga2_sweep_rows_equal_standalone_and_loop_engine():
    _, _, port, group = _problems()
    objectives = ("latency", "energy")
    fits = [port.prepare(group, objective=objectives),
            M3E(get_setting("S2"), bw_sys=64 * GB, device="cpu").prepare(
                group, objective=objectives)]
    strategy = get_strategy("nsga2", population=16)
    res = run_sweep(fits, budget=160, seeds=[0, 5], strategy=strategy,
                    device="cpu")
    for s, fit in enumerate(fits):
        for k, seed in enumerate((0, 5)):
            want = run_strategy(strategy, fit, budget=160, seed=seed,
                                device="cpu")
            assert res.best_fitness[s, k] == want.best_fitness
            np.testing.assert_array_equal(res.history_best[s, k],
                                          want.history_best)
    loop = run_strategy(strategy, fits[0], budget=160, seed=0, device="cpu",
                        engine="loop")
    assert loop.best_fitness == res.best_fitness[0, 0]
    np.testing.assert_array_equal(loop.best_accel, res.best_accel[0, 0])

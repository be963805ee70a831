"""Port parity: stacked scenarios and the batched (scenario x seed) sweep.

Stacking and the row-batched fitness are held against the reference
(``repro.core.fitness``) on the same scenarios: stacked tables bitwise,
the batched fitness at rtol 1e-5 (the tolerance of
``tests/test_torch_fitness.py``).  The sweep's own guarantee is held
bitwise on the CPU, as ``tests/test_sweep.py`` holds the reference's:
every row ``[s, k]`` of ``run_sweep`` equals the standalone
``run_strategy`` of scenario s and seed ``seeds[k]``, for MAGMA and each
device-resident baseline, chunked or not, with a partial last chunk,
and with its rows split over a device list of one, two or four CPU
entries (the shard, pad and gather code of several cards); and the
host-stepped ``engine="loop"`` equals the device loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.core import fitness as ref_fitness  # noqa: E402
from repro.core.job_analyzer import table_from_arrays as ref_table  # noqa: E402
from repro_torch.core.fitness import (FitnessFn, FitnessParams,  # noqa: E402
                                      evaluate_params, normalize_scenarios,
                                      stack_fitness_params)
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402
from repro_torch.core.magma import (MagmaConfig, magma_search,  # noqa: E402
                                    magma_search_batch)
from repro_torch.core.strategies import (available, get_strategy,  # noqa: E402
                                         run_strategy)
from repro_torch.core.sweep import (RowsResult, SweepConfig,  # noqa: E402
                                    SweepResult, run_rows, run_sweep)

BUDGET = 100
CFG = MagmaConfig(population=20)
KW = {"magma": {"cfg": CFG}, "random": {"population": 20},
      "stdga": {"population": 20}, "de": {"population": 20},
      "pso": {"population": 20}}
DEVICE_METHODS = sorted(KW)


def _arrays(seed, G=12, A=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 5.0, (G, A)), rng.uniform(0.01, 10.0, (G, A)),
            rng.uniform(1e6, 1e9, G), rng.uniform(0.1, 2.0, (G, A)))


def _scenario(seed, A=4, objective="throughput", G=12, bw_sys=None):
    lat, bw, flops, energy = _arrays(seed, G, A)
    bw_sys = 0.5 + seed if bw_sys is None else bw_sys
    return (FitnessFn(table_from_arrays(lat, bw, flops, energy), bw_sys=bw_sys,
                      objective=objective, device="cpu"),
            ref_fitness.FitnessFn(ref_table(lat, bw, flops, energy),
                                  bw_sys=bw_sys, objective=objective))


def _grid(n, A=4, objectives=("throughput",)):
    pairs = [_scenario(10 + i, A, objectives[i % len(objectives)])
             for i in range(n)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _assert_row(res, s, k, want):
    assert res.best_fitness[s, k] == want.best_fitness
    np.testing.assert_array_equal(res.best_accel[s, k], want.best_accel)
    np.testing.assert_array_equal(res.best_prio[s, k], want.best_prio)
    np.testing.assert_array_equal(res.history_best[s, k], want.history_best)


def _assert_same(a, b):
    for name in ("best_fitness", "best_accel", "best_prio", "history_best"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("A", [4, 8])
def test_stacked_tables_bitwise_equal_reference(A):
    fns, refs = _grid(3, A, ("throughput", "latency", "edp"))
    got = stack_fitness_params(fns)
    want = ref_fitness.stack_fitness_params(refs)
    for name, g, w in zip(FitnessParams._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    spec = normalize_scenarios(fns)
    ref_spec = ref_fitness.normalize_scenarios(refs)
    assert spec.num_accels == ref_spec.num_accels == A
    assert spec.objective is None and ref_spec.objective is None
    same = normalize_scenarios(_grid(2, A)[0])
    assert same.objective.token == "throughput"


def test_stacking_errors_match_reference():
    a4 = _scenario(1, 4)
    a8 = _scenario(2, 8)
    msgs = []
    for stack, fns in ((ref_fitness.stack_fitness_params, [a4[1], a8[1]]),
                       (stack_fitness_params, [a4[0], a8[0]])):
        with pytest.raises(ValueError, match=r"share \(G, A\)") as e:
            stack(fns)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    vec = _scenario(3, 4, ("latency", "energy"))
    scal = _scenario(4, 4, "latency")
    for norm, fns in ((ref_fitness.normalize_scenarios, [vec[1], scal[1]]),
                      (normalize_scenarios, [vec[0], scal[0]])):
        with pytest.raises(ValueError, match="mixed objectives"):
            norm(fns)
    with pytest.raises(ValueError, match="num_accels"):
        normalize_scenarios(stack_fitness_params([a4[0]]))


# ---------------------------------------------------------------------------
# the row-batched fitness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("A", [4, 8])
@pytest.mark.parametrize("objective", ["throughput", "energy", None])
def test_batched_fitness_equals_rows_and_reference(A, objective):
    objectives = ("throughput", "latency", "energy", "edp")
    fns, refs = _grid(4, A, objectives if objective is None
                      else (objective,))
    params = stack_fitness_params(fns)
    ref_params = ref_fitness.stack_fitness_params(refs)
    rng = np.random.default_rng(A)
    accel = rng.integers(0, A, (4, 9, 12)).astype(np.int32)
    prio = rng.random((4, 9, 12)).astype(np.float32)
    got = evaluate_params(params, torch.as_tensor(accel),
                          torch.as_tensor(prio), num_accels=A,
                          objective=objective).numpy()
    assert got.shape == (4, 9)
    for r in range(4):
        one = FitnessParams(*(t[r:r + 1] for t in params))
        row = evaluate_params(one, torch.as_tensor(accel[r:r + 1]),
                              torch.as_tensor(prio[r:r + 1]), num_accels=A,
                              objective=objective).numpy()
        np.testing.assert_array_equal(got[r], row[0])
        alone = fns[r](torch.as_tensor(accel[r]), torch.as_tensor(prio[r]))
        if objective is not None:
            np.testing.assert_array_equal(got[r], alone.numpy())
    want = np.asarray(jnp.stack([ref_fitness.evaluate_params(
        type(ref_params)(*(x[r] for x in ref_params)), jnp.asarray(accel[r]),
        jnp.asarray(prio[r]), num_accels=A, objective=objective)
        for r in range(4)]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", DEVICE_METHODS)
@pytest.mark.parametrize("A", [4, 8])
def test_sweep_rows_equal_standalone_runs(method, A):
    fns, _ = _grid(2, A)
    seeds = [0, 3]
    strategy = get_strategy(method, **KW[method])
    res = run_sweep(fns, budget=BUDGET, seeds=seeds, strategy=strategy,
                    device="cpu")
    assert isinstance(res, SweepResult)
    assert res.best_fitness.shape == (2, 2) and res.rows == 4
    assert res.history_best.shape == (2, 2, BUDGET // 20)
    for s, fn in enumerate(fns):
        for k, seed in enumerate(seeds):
            want = run_strategy(strategy, fn, budget=BUDGET, seed=seed,
                                device="cpu")
            _assert_row(res, s, k, want)


@pytest.mark.parametrize("method", DEVICE_METHODS)
def test_chunked_sweep_bitwise_with_partial_last_chunk(method):
    fns, _ = _grid(5)
    strategy = get_strategy(method, **KW[method])
    base = run_sweep(fns, budget=BUDGET, seeds=[7], strategy=strategy,
                     device="cpu")
    for chunk, n_chunks, padded in ((2, 3, 6), (3, 2, 6), (5, 1, 5)):
        ch = run_sweep(fns, budget=BUDGET, seeds=[7], strategy=strategy,
                       sweep=SweepConfig(chunk_rows=chunk), device="cpu")
        _assert_same(base, ch)
        assert (ch.num_chunks, ch.padded_rows, ch.rows) == \
            (n_chunks, padded, 5)
        assert len(ch.chunk_wall_s) == n_chunks
    assert base.num_chunks == 1 and base.padded_rows == 5


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("method", DEVICE_METHODS)
def test_sharded_sweep_rows_bitwise_standalone(method, ndev):
    """Five scenarios x one seed split over ``ndev`` devices in chunks of
    3 rows, rounded up to a multiple of ``ndev`` (3, 4, 4): a partial last
    chunk, and shard counts that do not divide the rows.  Every row is
    bitwise its standalone ``run_strategy``."""
    fns, _ = _grid(5)
    strategy = get_strategy(method, **KW[method])
    res = run_sweep(fns, budget=BUDGET, seeds=[7], strategy=strategy,
                    sweep=SweepConfig(chunk_rows=3, devices=("cpu",) * ndev),
                    device="cpu")
    chunk = -(-3 // ndev) * ndev
    assert (res.num_devices, res.chunk_rows, res.num_chunks,
            res.padded_rows, res.rows) == (ndev, chunk, 2, 2 * chunk, 5)
    for s, fn in enumerate(fns):
        _assert_row(res, s, 0, run_strategy(strategy, fn, budget=BUDGET,
                                            seed=7, device="cpu"))


def test_sharded_rows_keep_warm_starts_and_populations():
    """``run_rows`` over two devices with warm starts and the memo's
    population hand-off: the rows and the recorded populations equal the
    one-device run's."""
    from repro_torch.memo import ScheduleMemo

    fns, _ = _grid(3)
    spec = normalize_scenarios(fns)
    strategy = get_strategy("magma", cfg=CFG).bind(4)
    rng = np.random.default_rng(2)
    warm = (rng.integers(0, 4, (3, 20, 12)).astype(np.int32),
            rng.random((3, 20, 12)).astype(np.float32), np.float32(0.1))
    runs = []
    for devices in (("cpu",), ("cpu", "cpu")):
        memo = ScheduleMemo()
        rr = run_rows(spec.params, [5, 6, 7], strategy=strategy,
                      generations=3, evolve_last=False,
                      objective=spec.objective, device="cpu", memo=memo,
                      warm=strategy_warm(warm),
                      sweep=SweepConfig(devices=devices))
        runs.append((rr, memo.store._records))
    (one, recs1), (two, recs2) = runs
    assert two.num_devices == 2 and two.padded_rows == 4
    _assert_same(one, two)
    assert sorted(recs1) == sorted(recs2) and len(recs1) == 3
    for fp, rec in recs1.items():
        assert rec.has_population
        for name, a in rec.arrays.items():
            np.testing.assert_array_equal(recs2[fp].arrays[name], a)


def strategy_warm(warm):
    from repro_torch.core.strategies import WarmStart
    return WarmStart(*warm)


def test_ragged_grid_padding_sliced_off():
    fns, _ = _grid(3)
    res = run_sweep(fns, budget=BUDGET, cfg=CFG, seeds=[1, 4],
                    sweep=SweepConfig(chunk_rows=4), device="cpu")
    assert res.best_fitness.shape == (3, 2) and res.padded_rows == 8
    assert res.best_accel.shape == (3, 2, 12)
    for s, fn in enumerate(fns):
        for k, seed in enumerate((1, 4)):
            _assert_row(res, s, k, magma_search(fn, budget=BUDGET, cfg=CFG,
                                                seed=seed, device="cpu"))


def test_batch_api_routes_through_sweep():
    fns, _ = _grid(2)
    batch = magma_search_batch(fns, budget=BUDGET, cfg=CFG, seeds=[0, 3],
                               device="cpu")
    assert isinstance(batch, SweepResult)
    _assert_same(batch, run_sweep(fns, budget=BUDGET, cfg=CFG, seeds=[0, 3],
                                  device="cpu"))
    one = batch.result(1, 0)
    _assert_row(batch, 1, 0, one)


def test_mixed_objectives_take_the_per_row_select():
    fns, _ = _grid(4, 4, ("throughput", "latency", "energy", "edp"))
    res = run_sweep(fns, budget=BUDGET, cfg=CFG, seeds=[2], device="cpu")
    for s, fn in enumerate(fns):
        _assert_row(res, s, 0, magma_search(fn, budget=BUDGET, cfg=CFG,
                                            seed=2, device="cpu"))
    assert res.best_fitness[1, 0] < 0 < res.best_fitness[0, 0]


def test_run_rows_and_host_only_rejection():
    fns, _ = _grid(2)
    spec = normalize_scenarios(fns)
    strategy = get_strategy("magma", cfg=CFG).bind(4)
    rr = run_rows(spec.params, [5, 6], strategy=strategy, generations=3,
                  evolve_last=False, objective=spec.objective, device="cpu")
    assert isinstance(rr, RowsResult) and rr.best_fitness.shape == (2,)
    want = magma_search(fns[1], budget=60, cfg=CFG, seed=6, device="cpu")
    assert rr.best_fitness[1] == want.best_fitness
    for name in available(device_resident=False):
        with pytest.raises(ValueError, match="host-only"):
            run_sweep(fns, budget=BUDGET, strategy=name, device="cpu")
    # the schedule memo is ported: the sweep records its rows
    from repro_torch.memo import ScheduleMemo
    memo = ScheduleMemo()
    run_sweep(fns, budget=BUDGET, cfg=CFG, memo=memo, device="cpu")
    assert len(memo) == 2 and memo.stats.records == 2
    # the transfer guard and chunk tracing are ported: rows unchanged
    from repro_torch.obs import get_tracer
    base = run_sweep(fns, budget=BUDGET, cfg=CFG, device="cpu")
    guarded = run_sweep(fns, budget=BUDGET, cfg=CFG, device="cpu",
                        sweep=SweepConfig(transfer_guard=True))
    get_tracer().clear()
    traced = run_sweep(fns, budget=BUDGET, cfg=CFG, device="cpu",
                       sweep=SweepConfig(chunk_rows=1, obs={"enabled": True}))
    for res in (guarded, traced):
        np.testing.assert_array_equal(res.best_fitness, base.best_fitness)
        np.testing.assert_array_equal(res.best_accel, base.best_accel)
        np.testing.assert_array_equal(res.history_best, base.history_best)
    spans = [sp for sp in get_tracer().spans() if sp.name == "sweep.chunk"]
    assert [sp.args["chunk"] for sp in spans] == [0, 1]
    assert all(sp.args["rows"] == 1 and sp.args["devices"] == 1
               and sp.scope is None for sp in spans)
    with pytest.raises(ValueError, match="cfg"):
        run_sweep(fns, budget=BUDGET, cfg=CFG, strategy="random",
                  device="cpu")


@pytest.mark.parametrize("method", DEVICE_METHODS)
def test_loop_engine_equals_device_loop(method):
    fn, _ = _scenario(21, 8)
    strategy = get_strategy(method, **KW[method])
    scan = run_strategy(strategy, fn, budget=BUDGET + 7, seed=9,
                        device="cpu")
    loop = run_strategy(strategy, fn, budget=BUDGET + 7, seed=9,
                        device="cpu", engine="loop")
    assert scan.best_fitness == loop.best_fitness
    np.testing.assert_array_equal(scan.best_accel, loop.best_accel)
    np.testing.assert_array_equal(scan.best_prio, loop.best_prio)
    np.testing.assert_array_equal(scan.history_best, loop.history_best)
    if method == "magma":
        m = magma_search(fn, budget=BUDGET + 7, cfg=CFG, seed=9,
                         device="cpu", engine="loop", keep_population=True)
        assert m.best_fitness == scan.best_fitness
        assert tuple(m.final_population.accel.shape) == (20, 12)
    with pytest.raises(ValueError, match="engine"):
        run_strategy(strategy, fn, budget=BUDGET, device="cpu",
                     engine="warp")

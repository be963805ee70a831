"""Port parity: the whole slice, ``M3E.search(method="magma")``.

The two packages draw their random numbers from different generators
(JAX threefry, torch Philox), so a search is judged over seeds: on S2 / Mix
at G=20 with a 1,000-sample budget, the geomean of the port's best
fitness over eight seeds must lie within 3% of the reference's.  Measured
on the CPU over five disjoint sets of eight seeds, the ratio ranged from
0.9955 to 1.0101, while a search that does not evolve (one generation of
random genomes) reaches 0.82 of the evolved geomean.  Each best individual
the port returns, re-evaluated by the reference's ``FitnessFn``, must
reproduce the port's ``best_fitness`` at rtol 1e-5 (the tolerance of
``tests/test_torch_fitness.py``).
"""
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.core.m3e import M3E as RefM3E  # noqa: E402
from repro.costmodel import get_setting as ref_setting  # noqa: E402
from repro.workloads import build_task_groups as ref_groups  # noqa: E402
from repro_torch.core.m3e import M3E, geomean  # noqa: E402
from repro_torch.core.strategies import available, get_strategy  # noqa: E402
from repro_torch.costmodel import GB, get_setting  # noqa: E402
from repro_torch.workloads import build_task_groups  # noqa: E402

SEEDS = range(8)
BUDGET = 1_000
RATIO_TOL = 0.03


def _problems():
    ref = RefM3E(ref_setting("S2"), bw_sys=16 * GB)
    port = M3E(get_setting("S2"), bw_sys=16 * GB, device="cpu")
    return (ref, ref_groups("Mix", group_size=20, seed=0)[0],
            port, build_task_groups("Mix", group_size=20, seed=0)[0])


def test_search_geomean_matches_reference_and_bests_reevaluate():
    ref, ref_group, port, group = _problems()
    ref_fit = ref.prepare(ref_group)
    want, got = [], []
    for seed in SEEDS:
        want.append(ref.search(ref_group, budget=BUDGET, seed=seed)
                    .best_fitness)
        res = port.search(group, budget=BUDGET, seed=seed)
        got.append(res.best_fitness)
        assert res.n_samples == BUDGET and res.history_best.shape == (10,)
        again = float(ref_fit(jnp.asarray(res.best_accel[None]),
                              jnp.asarray(res.best_prio[None]))[0])
        assert again == pytest.approx(res.best_fitness, rel=1e-5)
        assert sorted(sum(port.describe_mapping(res), [])) == \
            list(range(20))
    ratio = geomean(got) / geomean(want)
    assert abs(ratio - 1.0) <= RATIO_TOL, (ratio, got, want)


def test_only_magma_is_registered():
    """The registry holds the reference's strategies, of the same kinds
    (the name dates from the slice that registered magma alone)."""
    from repro.core.strategies import available as ref_available
    for kind in (True, False):
        assert available(device_resident=kind) == \
            ref_available(device_resident=kind)
    assert available() == ref_available()
    with pytest.raises(ValueError, match="magma"):
        get_strategy("no_such_method")
    with pytest.raises(ValueError, match="cfg"):
        get_strategy("magma", population=10)


def test_search_refuses_tables_on_another_device():
    _, _, port, group = _problems()
    fit = port.prepare(group)
    from repro_torch.core.strategies import run_strategy
    with pytest.raises(ValueError, match="fitness tables"):
        run_strategy(get_strategy("magma"), fit, budget=100, device="meta")


def measure_ratio_spread(n_sets=5):
    """The measurement behind ``RATIO_TOL``: the geomean ratio over
    ``n_sets`` disjoint sets of eight seeds, plus the ratio a search that
    does not evolve (one generation) reaches against the evolved one."""
    ref, ref_group, port, group = _problems()
    for k in range(n_sets):
        seeds = range(8 * k, 8 * k + 8)
        want = [ref.search(ref_group, budget=BUDGET, seed=s).best_fitness
                for s in seeds]
        got = [port.search(group, budget=BUDGET, seed=s).best_fitness
               for s in seeds]
        print(f"seeds {seeds.start}-{seeds.stop - 1}: port/reference "
              f"geomean ratio {geomean(got) / geomean(want):.4f}")
    one = [ref.search(ref_group, budget=100, seed=s).best_fitness
           for s in SEEDS]
    evolved = [ref.search(ref_group, budget=BUDGET, seed=s).best_fitness
               for s in SEEDS]
    print(f"one generation / evolved geomean: "
          f"{geomean(one) / geomean(evolved):.4f}")


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_m3e.py
    measure_ratio_spread()

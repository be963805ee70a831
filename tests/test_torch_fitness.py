"""Port parity: objectives.

The four objectives of the paper, the dynamic per-scenario select and a
multi-column spec, computed by ``repro_torch.core.fitness`` and by
``repro.core.fitness`` on the same tables and genomes (the port's tables
carried across with ``repro_torch.convert``).  Tolerance rtol 1e-5: the
makespans come from simulators whose per-event A-way sums add in another
order (each event is exact elementwise), and the energies sum G float32
values in another order; neither moves a value by more than a few ulps
per event at these sizes.
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
from repro_torch.convert import (fitness_params_from_numpy,  # noqa: E402
                                 population_from_numpy)
from repro_torch.core import fitness  # noqa: E402
from repro_torch.core.job_analyzer import table_from_arrays  # noqa: E402

RTOL = 1e-5


def _scenario(seed=0, G=24, A=5, P=32):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.05, 5.0, (G, A))
    bw = rng.uniform(0.01, 10.0, (G, A))
    flops = rng.uniform(1e6, 1e9, G)
    energy = rng.uniform(0.1, 3.0, (G, A))
    accel = rng.integers(0, A, (P, G)).astype(np.int32)
    prio = rng.random((P, G)).astype(np.float32)
    return lat, bw, flops, energy, accel, prio


def _pair(objective, seed=0, bw_sys=2.0):
    lat, bw, flops, energy, accel, prio = _scenario(seed)
    ref = ref_fitness.FitnessFn(ref_table(lat, bw, flops, energy),
                                bw_sys=bw_sys, objective=objective)
    got = fitness.FitnessFn(table_from_arrays(lat, bw, flops, energy),
                            bw_sys=bw_sys, objective=objective, device="cpu")
    return ref, got, accel, prio


def test_registry_codes_match_reference():
    for name in ("throughput", "latency", "energy", "edp"):
        assert fitness.objective_info(name).code == \
            ref_fitness.objective_info(name).code
    with pytest.raises(ValueError, match="throughput"):
        fitness.objective_info("nope")


@pytest.mark.parametrize("objective", ["throughput", "latency", "energy",
                                       "edp"])
def test_scalar_objectives_match_reference(objective):
    ref, got, accel, prio = _pair(objective)
    want = np.asarray(ref(jnp.asarray(accel), jnp.asarray(prio)))
    pop = population_from_numpy(accel, prio, "cpu")
    have = got(pop.accel, pop.prio)
    assert have.dtype == torch.float32 and have.shape == (accel.shape[0],)
    np.testing.assert_allclose(have.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("code", [0, 1, 2, 3])
def test_dynamic_select_matches_reference(code):
    ref, _, accel, prio = _pair("throughput", seed=code)
    rp = ref.params._replace(objective_code=jnp.int32(code))
    want = np.asarray(ref_fitness.evaluate_params(
        rp, jnp.asarray(accel), jnp.asarray(prio), num_accels=ref.num_accels,
        objective=None))
    params = fitness_params_from_numpy(
        *(np.asarray(x) for x in rp), device="cpu")
    pop = population_from_numpy(accel, prio, "cpu")
    have = fitness.evaluate_params(params, pop.accel, pop.prio,
                                   num_accels=ref.num_accels, objective=None)
    np.testing.assert_allclose(have.numpy(), want, rtol=RTOL)


def test_multi_column_spec_matches_reference():
    spec = ("latency", "energy", "edp")
    ref, got, accel, prio = _pair(spec, seed=3)
    want = np.asarray(ref.objectives(jnp.asarray(accel), jnp.asarray(prio)))
    pop = population_from_numpy(accel, prio, "cpu")
    have = got.objectives(pop.accel, pop.prio)
    assert have.shape == (accel.shape[0], 3)
    np.testing.assert_allclose(have.numpy(), want, rtol=RTOL)
    # each column equals its scalar evaluation
    for j, name in enumerate(spec):
        _, scalar, _, _ = _pair(name, seed=3)
        assert torch.equal(have[:, j], scalar(pop.accel, pop.prio))
    with pytest.raises(ValueError, match="evaluate_objectives"):
        got(pop.accel, pop.prio)


def test_energy_objective_needs_energy_column():
    lat, bw, flops, _, _, _ = _scenario()
    with pytest.raises(ValueError, match="energy"):
        fitness.FitnessFn(table_from_arrays(lat, bw, flops), bw_sys=1.0,
                          objective="edp", device="cpu")


def test_registered_objective_reaches_the_evaluator():
    info = fitness.register_objective(
        "torch_test_half_latency", lambda params, ms, en: -0.5 * ms,
        overwrite=True)
    lat, bw, flops, energy, accel, prio = _scenario(4)
    table = table_from_arrays(lat, bw, flops, energy)
    lat_fn = fitness.FitnessFn(table, bw_sys=2.0, objective="latency",
                               device="cpu")
    half_fn = fitness.FitnessFn(table, bw_sys=2.0,
                                objective="torch_test_half_latency",
                                device="cpu")
    pop = population_from_numpy(accel, prio, "cpu")
    assert info.code >= 4
    assert torch.equal(half_fn(pop.accel, pop.prio),
                       0.5 * lat_fn(pop.accel, pop.prio))

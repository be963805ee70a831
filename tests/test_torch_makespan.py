"""Port parity: the population makespan.

On the CPU the port's makespan path runs the plain PyTorch version of the
CUDA kernel.  It must match the reference's jnp simulator, its Pallas
kernel in interpret mode and the float64 oracle, at the tolerances of
``tests/test_makespan_parity.py`` (rtol 1e-4 / atol 1e-5 between f32
simulators, whose A-way sums run in another order; rel 2e-3 against the
float64 oracle), on non-aligned shapes and scheduling edge cases.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_makespan_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.core.bw_allocator import simulate_population as ref_sim  # noqa: E402
from repro.kernels.makespan import makespan_pallas  # noqa: E402
from repro_torch.convert import population_from_numpy  # noqa: E402
from repro_torch.core.bw_allocator import (queue_tables,  # noqa: E402
                                           simulate_numpy)
from repro_torch.core.encoding import decode, decode_to_lists  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.kernels.ops import population_makespan  # noqa: E402
from repro_torch.kernels.ref import population_makespan_ref  # noqa: E402


def _problem(seed, P, G, A, one_accel=False):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.05, 5.0, (G, A))
    bw = rng.uniform(0.01, 10.0, (G, A))
    accel = (np.zeros((P, G), np.int32) if one_accel
             else rng.integers(0, A, (P, G)).astype(np.int32))
    prio = rng.random((P, G)).astype(np.float32)
    return lat, bw, accel, prio


def _tables(lat, bw, accel, prio, A, device="cpu"):
    pop = population_from_numpy(accel, prio, device)
    sched = decode(pop.accel, pop.prio, A)
    qlat, qbw = queue_tables(sched, torch.as_tensor(lat, device=device).float(),
                             torch.as_tensor(bw, device=device).float())
    return qlat.contiguous(), qbw.contiguous(), sched.count


def _check(lat, bw, accel, prio, bw_sys, A):
    latf, bwf = lat.astype(np.float32), bw.astype(np.float32)
    pop = population_from_numpy(accel, prio, "cpu")
    got = population_makespan(pop.accel, pop.prio, torch.as_tensor(latf),
                              torch.as_tensor(bwf), bw_sys, A).numpy()
    ref = np.asarray(ref_sim(jnp.asarray(accel), jnp.asarray(prio),
                             jnp.asarray(latf), jnp.asarray(bwf), bw_sys, A))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    # the reference's Pallas kernel, interpret mode, on the port's tables
    qlat, qbw, count = _tables(lat, bw, accel, prio, A)
    pallas = np.asarray(makespan_pallas(
        jnp.asarray(qlat.numpy()), jnp.asarray(qbw.numpy()),
        jnp.asarray(count.numpy()), bw_sys, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)

    for p in range(accel.shape[0]):
        want = simulate_numpy(decode_to_lists(accel[p], prio[p], A),
                              lat, bw, bw_sys)
        assert got[p] == pytest.approx(want, rel=2e-3), (p, got[p], want)
    return got


@pytest.mark.parametrize("G,A,P,bw_sys", [
    (37, 5, 7, 3.0),      # nothing aligned to a warp, a tile or a block
    (130, 3, 8, 10.0),
    (12, 9, 5, 1.0),
    (100, 16, 4, 2.0),    # the widest Table III setting
])
def test_plain_matches_reference_nonaligned(G, A, P, bw_sys):
    _check(*_problem(G * 1000 + A, P, G, A), bw_sys, A)


def test_single_job_group():
    _check(*_problem(0, 2, 1, 3), 2.0, 3)


def test_empty_queues_serial_sum():
    G, A = 19, 4
    lat, bw, accel, prio = _problem(1, 3, G, A, one_accel=True)
    _check(lat, bw, accel, prio, 5.0, A)
    pop = population_from_numpy(accel, prio, "cpu")
    ms = population_makespan(pop.accel, pop.prio,
                             torch.as_tensor(lat).float(),
                             torch.as_tensor(bw).float(), 1e9, A).numpy()
    np.testing.assert_allclose(ms, lat[:, 0].sum(), rtol=1e-4)


def test_bandwidth_saturated():
    _check(*_problem(2, 4, 23, 6), 0.05, 6)


def test_ref_module_and_tensor_bw_sys_agree():
    lat, bw, accel, prio = _problem(5, 6, 21, 4)
    pop = population_from_numpy(accel, prio, "cpu")
    latt, bwt = torch.as_tensor(lat).float(), torch.as_tensor(bw).float()
    a = population_makespan(pop.accel, pop.prio, latt, bwt, 2.0, 4)
    b = population_makespan(pop.accel, pop.prio, latt, bwt,
                            torch.tensor(2.0), 4)
    c = population_makespan_ref(pop.accel, pop.prio, lat, bw, 2.0, 4)
    assert torch.equal(a, b) and torch.equal(a, c)


def test_cpu_calls_never_launch_the_kernel():
    mk.reset_launches()
    lat, bw, accel, prio = _problem(3, 5, 17, 4)
    pop = population_from_numpy(accel, prio, "cpu")
    population_makespan(pop.accel, pop.prio, torch.as_tensor(lat).float(),
                        torch.as_tensor(bw).float(), 2.0, 4)
    assert mk.LAUNCHES["makespan"] == 0


def test_wrapper_rejects_malformed_tables():
    qlat, qbw, count = _tables(*_problem(4, 3, 9, 4), 4)
    with pytest.raises(TypeError):
        mk.makespan(qlat.double(), qbw, count, 1.0)
    with pytest.raises(TypeError):
        mk.makespan(qlat, qbw, count.long(), 1.0)
    with pytest.raises(ValueError):
        mk.makespan(qlat, qbw[:, :2], count, 1.0)
    with pytest.raises(ValueError):
        mk.makespan_cuda(qlat, qbw, count, 1.0)   # CPU tensors


@pytest.mark.parametrize("R,P,A", [(1, 7, 4), (3, 7, 8), (4, 100, 8)])
def test_plain_per_row_bw_sys_equals_one_row_calls(R, P, A):
    """R rows, each with its own tables and bw_sys, in one call: bitwise
    the R one-row calls, and the reference's simulator per row."""
    G = 23
    rng = np.random.default_rng(R * P + A)
    lat = rng.uniform(0.05, 5.0, (R, G, A)).astype(np.float32)
    bw = rng.uniform(0.01, 10.0, (R, G, A)).astype(np.float32)
    accel = rng.integers(0, A, (R, P, G)).astype(np.int32)
    prio = rng.random((R, P, G)).astype(np.float32)
    bw_sys = rng.uniform(0.05, 20.0, R).astype(np.float32)
    got = population_makespan(torch.as_tensor(accel), torch.as_tensor(prio),
                              torch.as_tensor(lat), torch.as_tensor(bw),
                              torch.as_tensor(bw_sys), A)
    assert got.shape == (R, P)
    for r in range(R):
        one = population_makespan(torch.as_tensor(accel[r]),
                                  torch.as_tensor(prio[r]),
                                  torch.as_tensor(lat[r]),
                                  torch.as_tensor(bw[r]),
                                  torch.as_tensor(bw_sys[r:r + 1]), A)
        assert torch.equal(got[r], one), r
        ref = np.asarray(ref_sim(jnp.asarray(accel[r]), jnp.asarray(prio[r]),
                                 jnp.asarray(lat[r]), jnp.asarray(bw[r]),
                                 float(bw_sys[r]), A))
        np.testing.assert_allclose(got[r].numpy(), ref, rtol=1e-4, atol=1e-5)
    sched = decode(torch.as_tensor(accel).reshape(-1, G),
                   torch.as_tensor(prio).reshape(-1, G), A)
    qlat, qbw = queue_tables(sched, torch.as_tensor(lat), torch.as_tensor(bw))
    flat = mk.makespan(qlat.contiguous(), qbw.contiguous(), sched.count,
                       torch.as_tensor(bw_sys))
    assert torch.equal(flat, got.reshape(-1))
    if R > 1:
        with pytest.raises(ValueError, match="dividing"):
            mk.makespan(qlat[:-1].contiguous(), qbw[:-1].contiguous(),
                        sched.count[:-1].contiguous(),
                        torch.as_tensor(bw_sys))

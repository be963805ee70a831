"""Port parity: genome decode.  ``repro_torch.core.encoding.decode`` on a
(P, G) population gives bitwise the queues and counts of the vmapped
``repro.core.encoding.decode``, including priority ties (which break by
job id) and accelerators with empty queues."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core.encoding import decode as ref_decode  # noqa: E402
from repro.core.encoding import decode_to_lists as ref_lists  # noqa: E402
from repro_torch.convert import population_from_numpy  # noqa: E402
from repro_torch.core.encoding import (decode, decode_to_lists,  # noqa: E402
                                       random_population)


def _genomes(seed, P, G, A, quantum=None, accels=None):
    rng = np.random.default_rng(seed)
    accel = rng.integers(0, accels or A, (P, G)).astype(np.int32)
    prio = rng.random((P, G)).astype(np.float32)
    if quantum is not None:
        prio = (np.floor(prio / quantum) * quantum).astype(np.float32)
    return accel, prio


@pytest.mark.parametrize("P,G,A,quantum,accels", [
    (7, 37, 5, 0.1, None),     # heavy prio ties, A not a power of two
    (16, 100, 8, 0.1, None),   # the paper's group size
    (5, 12, 16, None, None),   # more accelerators than most queues fill
    (3, 1, 3, None, None),     # a single job
    (4, 19, 6, 0.1, 2),        # four of six queues empty
])
def test_decode_bitwise_matches_reference(P, G, A, quantum, accels):
    accel, prio = _genomes(P * 100 + G, P, G, A, quantum, accels)
    ref = jax.vmap(lambda a, p: ref_decode(a, p, A))(jnp.asarray(accel),
                                                      jnp.asarray(prio))
    pop = population_from_numpy(accel, prio, "cpu")
    got = decode(pop.accel, pop.prio, A)
    assert got.queue.dtype == torch.int32 and got.count.dtype == torch.int32
    np.testing.assert_array_equal(got.queue.numpy(), np.asarray(ref.queue))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    for p in range(P):
        assert decode_to_lists(accel[p], prio[p], A) == \
            ref_lists(accel[p], prio[p], A)


def test_random_population_shapes_ranges_dtypes():
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    pop = random_population(gen, 9, 13, 5, "cpu")
    assert pop.accel.shape == (9, 13) and pop.accel.dtype == torch.int32
    assert pop.prio.shape == (9, 13) and pop.prio.dtype == torch.float32
    assert int(pop.accel.min()) >= 0 and int(pop.accel.max()) < 5
    assert float(pop.prio.min()) >= 0.0 and float(pop.prio.max()) < 1.0
    assert pop.size == 9

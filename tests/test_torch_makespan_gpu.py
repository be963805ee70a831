"""The CUDA makespan kernel on the card, against its plain PyTorch version.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Tolerance rtol 1e-4 / atol 1e-5, as between the reference's f32
simulators: the kernel's A-way sums run in another order than torch's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread is enough, and leaves the other
# test workers their cores
torch.set_num_threads(1)

from repro_torch.core.bw_allocator import (queue_tables,  # noqa: E402
                                           simulate_tables)
from repro_torch.core.encoding import decode  # noqa: E402
from repro_torch.kernels import makespan as mk  # noqa: E402
from repro_torch.kernels.ops import population_makespan  # noqa: E402


def _problem(seed, P, G, A, one_accel=False):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(0.05, 5.0, (G, A))
    bw = rng.uniform(0.01, 10.0, (G, A))
    accel = (np.zeros((P, G), np.int32) if one_accel
             else rng.integers(0, A, (P, G)).astype(np.int32))
    prio = rng.random((P, G)).astype(np.float32)
    return lat, bw, accel, prio


def _tables(lat, bw, accel, prio, A, device):
    sched = decode(torch.as_tensor(accel, device=device),
                   torch.as_tensor(prio, device=device), A)
    qlat, qbw = queue_tables(sched, torch.as_tensor(lat, device=device).float(),
                             torch.as_tensor(bw, device=device).float())
    return qlat.contiguous(), qbw.contiguous(), sched.count


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# A from 1 to 32 (groups of 1 to 32 lanes), P not a multiple of the
# individuals of a block, G = 1000 (the paper's largest group; staged in
# shared memory) and G = 7000 (past the staged slots: queues read from
# device memory), and empty queues (every job on one sub-accelerator)
@pytest.mark.gpu
@pytest.mark.parametrize("G,A,P,bw_sys,one_accel", [
    (37, 5, 7, 3.0, False), (100, 8, 100, 2.0, False),
    (100, 16, 100, 0.05, False), (1, 3, 2, 2.0, False),
    (60, 1, 13, 2.0, False), (100, 8, 13, 2.0, False),
    (80, 9, 11, 1.0, False), (50, 32, 5, 4.0, False),
    (1000, 8, 9, 3.0, False), (1000, 1, 3, 2.0, False),
    (7000, 2, 3, 2.0, False), (19, 4, 3, 5.0, True),
    (1000, 8, 5, 0.5, True)])
def test_kernel_matches_plain_on_card(cuda, G, A, P, bw_sys, one_accel):
    lat, bw, accel, prio = _problem(G + A + P, P, G, A, one_accel)
    qlat, qbw, count = _tables(lat, bw, accel, prio, A, cuda)
    before = mk.LAUNCHES["makespan"]
    got = mk.makespan(qlat, qbw, count, bw_sys)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["makespan"] == before + 1
    want = simulate_tables(qlat, qbw, count, bw_sys)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernel_population_invariance_bitwise(cuda):
    G, A, P = 100, 8, 4096
    lat, bw, accel, prio = _problem(11, P, G, A)
    qlat, qbw, count = _tables(lat, bw, accel, prio, A, cuda)
    full = mk.makespan(qlat, qbw, count, 2.0)
    head = mk.makespan(qlat[:100].contiguous(), qbw[:100].contiguous(),
                       count[:100].contiguous(), 2.0)
    tail = mk.makespan(qlat[7:19].contiguous(), qbw[7:19].contiguous(),
                       count[7:19].contiguous(), 2.0)
    assert torch.equal(full[:100], head)
    assert torch.equal(full[7:19], tail)


@pytest.mark.gpu
def test_kernel_rejects_more_than_32_accels(cuda):
    qlat = torch.ones((2, 33, 4), device=cuda)
    count = torch.ones((2, 33), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sub-accelerators"):
        mk.makespan(qlat, qlat.clone(), count, 1.0)


@pytest.mark.gpu
def test_cuda_call_never_reaches_plain_version(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("plain version reached from a CUDA tensor")

    monkeypatch.setattr(mk, "simulate_tables", forbidden)
    lat, bw, accel, prio = _problem(12, 10, 30, 4)
    ms = population_makespan(torch.as_tensor(accel, device=cuda),
                             torch.as_tensor(prio, device=cuda),
                             torch.as_tensor(lat, device=cuda).float(),
                             torch.as_tensor(bw, device=cuda).float(), 2.0, 4)
    torch.cuda.synchronize()
    assert ms.device.type == "cuda" and bool(torch.isfinite(ms).all())

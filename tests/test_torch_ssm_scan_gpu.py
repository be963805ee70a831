"""The CUDA selective-scan kernel on the card, against its plain PyTorch
version.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Tolerances are the reference's (``tests/test_kernels.py:112-127``): 1e-4
with float32 inputs, 5e-2 with bfloat16 x/B/C.  The kernel sums a
channel's N states in another order than ``torch.sum`` and contracts
products into FMAs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402


def _inputs(seed, Bt, L, D, N, low, device, low_bc=None, offset=0):
    """x, dt, A, B, C as the reference's kernel tests draw them, on
    ``device``: x in ``low``, B and C in ``low_bc`` (default ``low``);
    ``offset`` > 0 places x, B and C that many elements into their
    storage, so that their rows are not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, L, D)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bt, L, D)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal((D, N)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((Bt, L, N)).astype(np.float32)
    C = rng.standard_normal((Bt, L, N)).astype(np.float32)

    def dev(a, dtype=torch.float32, shift=0):
        t = torch.as_tensor(a, device=device).to(dtype)
        if shift:
            flat = torch.empty(t.numel() + shift, dtype=dtype, device=device)
            t = flat[shift:].view(t.shape).copy_(t)
        return t

    low_bc = low if low_bc is None else low_bc
    return (dev(x, low, offset), dev(dt), dev(A), dev(B, low_bc, offset),
            dev(C, low_bc, offset))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("Bt,L,D,N,low,tol", [
    (2, 40, 64, 4, torch.float32, 1e-4),
    (1, 129, 256, 16, torch.float32, 1e-4),
    (2, 16, 128, 8, torch.float32, 1e-4),
    (1, 64, 384, 64, torch.float32, 1e-4),
    (1, 32, 128, 16, torch.bfloat16, 5e-2),
    (1, 100, 300, 100, torch.bfloat16, 5e-2),
    (3, 33, 8192, 16, torch.bfloat16, 5e-2)])
def test_kernel_matches_plain_on_card(cuda, Bt, L, D, N, low, tol):
    args = _inputs(L * D + N, Bt, L, D, N, low, cuda)
    before = ssm.LAUNCHES["ssm_scan"]
    y, h = ssm.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm.LAUNCHES["ssm_scan"] == before + 1
    yr, hr = M.selective_scan(*args)
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(h, hr, rtol=tol, atol=tol)


_MIXES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]


# L ending mid-chunk and mid-ring, N from 1 to 128 (1 to 32 lanes), D
# that is not a multiple of a block's channels (and odd: bf16 rows that
# allow no 4-byte copies), Bt = 2 rows whose B/C spans start unaligned,
# and the four x / (B, C) type mixes
@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 33, 97, 513])
@pytest.mark.parametrize("N", [1, 3, 16, 64, 128])
def test_kernel_edges_match_plain_on_card(cuda, L, N):
    D = 37 + 2 * N
    Bt = 2 if L % 2 else 1
    low, low_bc = _MIXES[(L + N) % 4]
    args = _inputs(L + N, Bt, L, D, N, low, cuda, low_bc)
    y, h = ssm.ssm_scan(*args)
    torch.cuda.synchronize()
    yr, hr = M.selective_scan(*args)
    tol = 5e-2 if torch.bfloat16 in (low, low_bc) else 1e-4
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(h, hr, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("low,low_bc", _MIXES)
def test_unaligned_rows_match_aligned_bitwise(cuda, low, low_bc):
    """Inputs one element into their storage (the scalar staging path)
    give the aligned launch's bits."""
    aligned = _inputs(7, 1, 70, 256, 16, low, cuda, low_bc)
    moved = _inputs(7, 1, 70, 256, 16, low, cuda, low_bc, offset=1)
    assert any(t.data_ptr() % 16 for t in moved)
    for got, want in zip(ssm.ssm_scan(*moved), ssm.ssm_scan(*aligned)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_batch_rows_are_bitwise_independent(cuda):
    x, dt, A, B, C = _inputs(1, 2, 96, 512, 64, torch.bfloat16, cuda)
    y2, h2 = ssm.ssm_scan(x, dt, A, B, C)
    for b in range(2):
        y1, h1 = ssm.ssm_scan(*(t[b:b + 1].contiguous()
                                for t in (x, dt)), A,
                              *(t[b:b + 1].contiguous() for t in (B, C)))
        assert torch.equal(y2[b:b + 1], y1) and torch.equal(h2[b:b + 1], h1)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, B, C = _inputs(2, 1, 8, 16, 4, torch.float32, cuda)
    with pytest.raises(TypeError, match="dt and A"):
        ssm.ssm_scan_cuda(x, dt.half(), A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ssm.ssm_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                          dt, A, B, C)
    big = torch.zeros((16, 129), device=cuda)
    bc = torch.zeros((1, 8, 129), device=cuda)
    with pytest.raises(ValueError, match="states"):
        ssm.ssm_scan_cuda(x, dt, big, bc, bc)
    # ops.ssm_scan casts and copies what the raw entry refuses
    y, _ = ops.ssm_scan(x.half(), dt.half(), A, B[..., :].transpose(
        1, 2).contiguous().transpose(1, 2), C)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())


@pytest.mark.gpu
def test_cuda_model_never_reaches_plain_scan(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("plain scan reached from a CUDA tensor")

    monkeypatch.setattr(ssm, "selective_scan", forbidden)
    monkeypatch.setattr(M, "selective_scan", forbidden)
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        cfg = get_smoke_config(arch).replace(use_flash=True)
        model = get_model(cfg, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
        before = ssm.LAUNCHES["ssm_scan"]
        toks = torch.randint(0, cfg.vocab, (1, 24), device=cuda)
        logits, _ = model.prefill({"tokens": toks}, 32)
        torch.cuda.synchronize()
        assert ssm.LAUNCHES["ssm_scan"] - before == cfg.num_layers
        assert bool(torch.isfinite(logits).all())

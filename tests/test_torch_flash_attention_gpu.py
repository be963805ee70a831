"""The CUDA flash-attention kernel on the card, against its plain PyTorch
version.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Tolerances: on the reference's shapes, the reference's own
(``tests/test_kernels.py:78``): 2e-5 with float32 inputs, 2e-2 with
bfloat16.  The kernel takes its softmax online, tile by tile, and sums its
products in another order than the dense plain version.  The bf16
kernel's edges (rows that are not 16-byte aligned, q/k/v as views of one
packed tensor, a window that ends inside a key tile, S=1, bidirectional
D=120) are held to 2e-5 + 2^-7 |want|: the f32 limit plus one bf16
rounding step of the output, since both sides round f32 results that
agree to 2e-5.  That limit is why the bf16 kernel splits P: rounding the
softmax weights to bf16 before P.V would miss it by up to 34x, so P goes
to the tensor cores as bf16 hi + lo, which keeps ~2^-17 of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

# (B, S, Hq, Hkv, D, window, causal): the reference's sweep
# (tests/test_kernels.py:63-91), then ragged S at D=20 and D=160, and D=120
# with a window (danube's head dim)
CASES = [(2, 64, 4, 2, 32, 0, True), (1, 128, 8, 8, 64, 0, True),
         (2, 96, 4, 1, 16, 24, True), (1, 64, 6, 2, 128, 16, True),
         (1, 64, 4, 2, 32, 0, False), (2, 33, 4, 2, 20, 0, True),
         (1, 96, 4, 2, 160, 0, True), (1, 200, 4, 2, 120, 48, True),
         (1, 77, 2, 1, 160, 0, False)]


def _inputs(seed, B, S, Hq, Hkv, D, dtype, device):
    rng = np.random.default_rng(seed)

    def draw(h):
        a = rng.standard_normal((B, S, h, D)).astype(np.float32)
        return torch.as_tensor(a, device=device).to(dtype)

    return draw(Hq), draw(Hkv), draw(Hkv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", CASES)
def test_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, D, window, causal,
                                      dtype, tol):
    q, k, v = _inputs(B * S + D, B, S, Hq, Hkv, D, dtype, cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# (B, S, Hq, Hkv, D, window, causal, q/k/v as views of one packed tensor)
EDGES = [(2, 77, 4, 2, 20, 0, True, True), (1, 300, 8, 2, 120, 0, True, True),
         (1, 1000, 4, 2, 64, 300, True, False),
         (2, 1, 4, 2, 64, 0, True, False), (1, 1, 2, 1, 120, 0, False, False),
         (1, 200, 4, 2, 120, 0, False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal,packed", EDGES)
def test_bf16_edges_within_one_output_step(cuda, B, S, Hq, Hkv, D, window,
                                           causal, packed):
    if packed:
        qkv = _inputs(S + D, B, S, Hq + 2 * Hkv, 1, D, torch.bfloat16,
                      cuda)[0]
        q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
        assert not k.is_contiguous()
    else:
        q, k, v = _inputs(S + D, B, S, Hq, Hkv, D, torch.bfloat16, cuda)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-5)


@pytest.mark.gpu
def test_batch_rows_are_bitwise_independent(cuda):
    q, k, v = _inputs(1, 2, 150, 8, 2, 64, torch.bfloat16, cuda)
    out2 = fa.flash_attention(q, k, v, window=40)
    for b in range(2):
        out1 = fa.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                  window=40)
        assert torch.equal(out2[b:b + 1], out1)


@pytest.mark.gpu
def test_strided_inputs_need_no_copy(cuda):
    """q, k, v split off one fused projection, as strided views."""
    B, S, D = 2, 70, 64
    qkv = _inputs(3, B, S, 8, 8, D, torch.float32, cuda)[0]
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:8]
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(2, 1, 8, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fa.flash_attention_cuda(q, k.half(), v)
    k3 = k[:, :, :1].expand(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_cuda(q, k3, k3)
    big = torch.zeros((1, 4, 2, 192), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_cuda(big, big, big)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3),
                            k, v)


@pytest.mark.gpu
def test_grad_enabled_call_raises(cuda):
    q, k, v = _inputs(4, 1, 16, 4, 2, 16, torch.float32, cuda)
    q.requires_grad_(True)
    before = fa.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before + 1


@pytest.mark.gpu
def test_cuda_model_never_reaches_plain_attention(cuda, monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("plain attention reached from a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_ref", forbidden)
    for arch in ("granite-3-2b", "h2o-danube-3-4b"):
        cfg = get_smoke_config(arch).replace(use_flash=True)
        model = get_model(cfg, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
        before = fa.LAUNCHES["flash_attention"]
        with torch.no_grad():
            loss, _ = model.loss({"tokens": toks, "labels": toks})
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] - before == cfg.num_layers
        assert bool(torch.isfinite(loss))

"""The MoE layer, the transformer's serving methods and the serving
launcher on the card, against the port on the CPU in float32.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

The expert products, the attention and the MLPs are plain PyTorch
products in both places (no kernel of the port runs here), so the card
and the CPU differ only in summation order: float32 within 1e-4
absolute and relative, TF32 off.  The routing (top-k, capacity slots,
drops) is exact on both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(arch, cuda, seed=0, **overrides):
    """The same smoke model in float32 on the CPU and on the card."""
    cfg = get_smoke_config(arch).replace(dtype="float32", **overrides)
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    card = get_model(cfg, device="meta").to_empty(device=cuda)
    card.load_state_dict(cpu.state_dict())
    card.device = cuda
    return cfg, cpu, card


def _close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
@pytest.mark.parametrize("group_tokens", [False, True])
def test_moe_on_card_matches_cpu(cuda, arch, capacity_factor, group_tokens):
    cfg, cpu, card = _pair(arch, cuda, seed=1)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32))
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=capacity_factor, group_tokens=group_tokens)
    with torch.no_grad():
        y, aux = L.moe(cpu.layers[0].moe, x, **kw)
        yc, auxc = L.moe(card.layers[0].moe, x.to(cuda), **kw)
    _close(yc, y)
    _close(auxc, aux)


@pytest.mark.gpu
def test_gate_product_keeps_float32_on_card(cuda):
    """The bf16 gate product's float32 output (cuBLAS ``out_dtype``)
    against the float64 product of the same bf16 values."""
    rng = np.random.default_rng(3)
    buf = torch.as_tensor(rng.standard_normal((2, 4, 3, 256)),
                          dtype=torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((4, 256, 96)) * 256 ** -0.5,
                        dtype=torch.bfloat16)
    h = L.expert_matmul_f32(buf.to(cuda), w.to(cuda))
    want = torch.einsum("gecd,edf->gecf", buf.double(), w.double())
    assert h.dtype == torch.float32
    _close(h, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,overrides", [
    ("granite-3-2b", {}), ("h2o-danube-3-4b", {"sliding_window": 8}),
    ("qwen2-moe-a2.7b", {})])
def test_prefill_and_decode_on_card_match_cpu(cuda, arch, overrides):
    cfg, cpu, card = _pair(arch, cuda, seed=3, **overrides)
    S, steps = 13, 9
    rng = np.random.default_rng(4)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S)))
    feed = torch.as_tensor(rng.integers(0, cfg.vocab, (2, steps)))
    lg, cache = cpu.prefill({"tokens": prompt}, S + steps)
    lgc, cachec = card.prefill({"tokens": prompt.to(cuda)}, S + steps)
    _close(lgc, lg)
    for t in range(steps):
        lg, cache = cpu.decode_step(cache, feed[:, t:t + 1], S + t)
        lgc, cachec = card.decode_step(cachec, feed[:, t:t + 1].to(cuda),
                                       S + t)
        _close(lgc, lg)
    for got, want in zip(cachec, cache):
        _close(got, want)


@pytest.mark.gpu
def test_launcher_serves_every_window_on_card(cuda):
    out = serve.main(["--requests", "3", "--budget", "200", "--execute"],
                     log_fn=lambda *_: None)
    ref = serve.main(["--requests", "3", "--budget", "200", "--device",
                      "cpu"], log_fn=lambda *_: None)
    assert out["requests"] == ref["requests"]
    assert out["engine"].device.type == "cuda"
    decodes = {j.uid: j for j in out["jobs"] if j.phase == "decode"}
    assert sorted(out["outputs"]) == sorted(decodes)
    for uid, toks in out["outputs"].items():
        job = decodes[uid]
        vocab = out["engine"].tenants[job.tenant].cfg.vocab
        assert toks.shape == (1, job.tokens)
        assert ((toks >= 0) & (toks < vocab)).all()
    for (m, got), (_, want) in zip(out["schedules"][1:],
                                   ref["schedules"][1:]):
        assert got["queues"] == want["queues"], m

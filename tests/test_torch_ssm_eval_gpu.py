"""The SSM and hybrid evaluation path on the card: the scan kernel at the
two evaluation shapes, the flash kernel at zamba2's shared block, and a
4-layer float32 loss through the kernels against the plain route.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(the card is looked for inside the ``cuda`` fixture).  The module imports
no JAX, so on the card's host these run with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py

Tolerances are the reference's kernel limits (``tests/test_kernels.py``):
the scan 1e-4 in float32 and 5e-2 with bf16 x/B/C (``:112-127``); flash
2e-5 in float32 (``:78``) and, in bf16 outside the reference's sweep,
2e-5 plus one bf16 rounding step of the output (2^-7 relative), as
``chip_smoke.py`` holds it.  The 4-layer losses agree within 1e-4, the
limit ``chip_smoke.py`` holds the flash route to (``EVAL_F32_ATOL``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     ssm_inputs, ssm_scan_ref)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402

# (Bt, L, D, N): falcon-mamba-7b at B=1, S=2048; zamba2-1.2b at B=4, S=2048
EVAL_SCANS = [(1, 2048, 8192, 16), (4, 2048, 4096, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EVAL_SCANS, ids=["falcon", "zamba2"])
@pytest.mark.parametrize("low,tol", [(torch.float32, 1e-4),
                                     (torch.bfloat16, 5e-2)])
def test_scan_at_evaluation_shapes(cuda, shape, low, tol):
    args = ssm_inputs(cuda, sum(shape), *shape, low)
    before = ssm.LAUNCHES["ssm_scan"]
    y, h = ssm.ssm_scan(*args)
    torch.cuda.synchronize()
    assert ssm.LAUNCHES["ssm_scan"] == before + 1
    yr, hr = ssm_scan_ref(*args)
    torch.testing.assert_close(y, yr, rtol=tol, atol=tol)
    torch.testing.assert_close(h, hr, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_scan_rows_are_independent_at_zamba2_shape(cuda):
    """Each of the 4 rows of the zamba2 launch equals its own Bt=1 launch,
    bitwise."""
    x, dt, A, B, C = ssm_inputs(cuda, 7, *EVAL_SCANS[1])
    y4, h4 = ssm.ssm_scan(x, dt, A, B, C)
    for b in range(4):
        y1, h1 = ssm.ssm_scan(x[b:b + 1].contiguous(),
                              dt[b:b + 1].contiguous(), A,
                              B[b:b + 1].contiguous(),
                              C[b:b + 1].contiguous())
        assert torch.equal(y4[b:b + 1], y1) and torch.equal(h4[b:b + 1], h1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_zamba2_shared_block(cuda, dtype):
    """(4, 2048, 32/32 heads, D=64), causal: Hq = Hkv, a kv group of one."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((4, 2048, 32, 64), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True).float()
    rtol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want).abs()
    assert bool((err <= 2e-5 + rtol * want.abs()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_kernel_route_loss_equals_plain_route(cuda, arch):
    """At full width with 4 layers in float32 (zamba2: one application of
    the shared block), the loss through the kernels equals the plain
    route's within 1e-4, with one scan launch a layer (and one flash
    launch a shared-block application)."""
    cfg = get_config(arch).replace(num_layers=4, dtype="float32")
    model = get_model(cfg, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(3))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             TokenStream(cfg, 1, 512, seed=0).batch_at(10_000).items()}
    scans, flashes = ssm.LAUNCHES["ssm_scan"], fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        model.cfg = cfg.replace(use_flash=True)
        kernel = float(model.loss(batch)[0])
        assert ssm.LAUNCHES["ssm_scan"] == scans + 4
        assert fa.LAUNCHES["flash_attention"] == flashes + (
            1 if cfg.family == "hybrid" else 0)
        model.cfg = cfg
        plain = float(model.loss(batch)[0])
    assert ssm.LAUNCHES["ssm_scan"] == scans + 4
    assert abs(kernel - plain) <= 1e-4, (kernel, plain)

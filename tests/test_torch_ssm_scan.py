"""Port parity: the selective scan.

On the CPU the port's ``ops.ssm_scan`` runs the plain PyTorch version of
the CUDA kernel (a loop over time).  It must match the reference's Pallas
kernel ``repro.kernels.ops.ssm_scan``, run in interpret mode on the CPU,
and the reference's ``lax.scan`` oracle, on the shapes and at the
tolerances of ``tests/test_kernels.py:97-127``: 1e-4 with float32 inputs,
5e-2 with bfloat16 x/B/C (dt and A stay float32, as on the model path).
Inputs are drawn with numpy and handed to both packages.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_ssm_scan_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402

SHAPES = [(2, 40, 64, 4, 16), (1, 129, 256, 16, 32), (2, 16, 128, 8, 8),
          (1, 64, 384, 64, 16)]     # (Bt, L, D, N, Pallas chunk)


def _inputs(seed, Bt, L, D, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, L, D)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bt, L, D)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal((D, N)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((Bt, L, N)).astype(np.float32)
    C = rng.standard_normal((Bt, L, N)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrays, low=torch.float32):
    """x, B, C in ``low``; dt, A float32."""
    x, dt, A, B, C = (torch.as_tensor(a) for a in arrays)
    return x.to(low), dt, A, B.to(low), C.to(low)


def _jax(arrays, low=jnp.float32):
    x, dt, A, B, C = (jnp.asarray(a) for a in arrays)
    return x.astype(low), dt, A, B.astype(low), C.astype(low)


@pytest.mark.parametrize("Bt,L,D,N,chunk", SHAPES)
def test_ssm_scan_matches_pallas_interpret(Bt, L, D, N, chunk):
    arrays = _inputs(L * D, Bt, L, D, N)
    y, h = ops.ssm_scan(*_torch(arrays))
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (Bt, L, D) and h.shape == (Bt, D, N)
    jy, jh = jops.ssm_scan(*_jax(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("Bt,L,D,N,chunk", SHAPES)
def test_ssm_scan_ref_matches_jax_oracle(Bt, L, D, N, chunk):
    arrays = _inputs(L * D + 1, Bt, L, D, N)
    y, h = ref.ssm_scan_ref(*_torch(arrays))
    jy, jh = jref.ssm_scan_ref(*_jax(arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


def test_ssm_scan_bf16_inputs():
    arrays = _inputs(3, 1, 32, 128, 16)
    y, h = ops.ssm_scan(*_torch(arrays, torch.bfloat16))
    jy, jh = jops.ssm_scan(*_jax(arrays, jnp.bfloat16), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=5e-2,
                               rtol=5e-2)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=5e-2,
                               rtol=5e-2)
    # the port's own kernel/plain pair at the same inputs
    yr, hr = ref.ssm_scan_ref(*_torch(arrays, torch.bfloat16))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), atol=5e-2, rtol=5e-2)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ssm.LAUNCHES["ssm_scan"]
    arrays = _inputs(5, 2, 9, 24, 6)
    y, h = ops.ssm_scan(*_torch(arrays))
    yr, hr = ref.ssm_scan_ref(*_torch(arrays))
    assert torch.equal(y, yr) and torch.equal(h, hr)
    assert ssm.LAUNCHES["ssm_scan"] == before


def test_cuda_entry_rejects_cpu_tensors_and_bad_shapes():
    x, dt, A, B, C = _torch(_inputs(6, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssm.ssm_scan_cuda(x, dt, A, B, C)
    with pytest.raises(ValueError, match="dt"):
        ssm.ssm_scan(x, dt[:, :4], A, B, C)
    with pytest.raises(ValueError, match="A must be"):
        ssm.ssm_scan(x, dt, A[:8], B, C)
    with pytest.raises(ValueError, match="C must be"):
        ssm.ssm_scan(x, dt, A, B, C[:, :, :3])

"""Port parity: flash attention.

On the CPU the port's ``ops.flash_attention`` runs the plain PyTorch
version of the CUDA kernel (``kernels.ref.flash_attention_ref``).  It must
match the reference's Pallas kernel ``repro.kernels.ops.flash_attention``,
run in interpret mode on the CPU, on the shapes and at the tolerances of
``tests/test_kernels.py:63-91`` (2e-5 with float32 inputs, 2e-2 with
bfloat16), plus a head dim of 120 with a sliding window (danube's) and a
head dim of 20 with a ragged S (stablelm's smoke config).  Inputs are
drawn with numpy and handed to both packages.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_flash_attention_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# (B, S, Hq, Hkv, D, window): the reference's sweep, then D=120 with a
# window and D=20 with a ragged S
SHAPES = [(2, 64, 4, 2, 32, 0), (1, 128, 8, 8, 64, 0), (2, 96, 4, 1, 16, 24),
          (1, 64, 6, 2, 128, 16), (1, 96, 4, 2, 120, 40),
          (2, 33, 4, 2, 20, 0)]
DTYPES = [(np.float32, torch.float32, jnp.float32, 2e-5),
          (np.float32, torch.bfloat16, jnp.bfloat16, 2e-2)]


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (Hq, Hkv, Hkv))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", SHAPES)
def test_flash_attention_matches_pallas_interpret(B, S, Hq, Hkv, D, window,
                                                  dtypes):
    _, tdt, jdt, tol = dtypes
    arrays = _inputs(B * S + Hq + D, B, S, Hq, Hkv, D)
    q, k, v = (torch.as_tensor(a).to(tdt) for a in arrays)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == tdt and got.shape == (B, S, Hq, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_non_causal_matches_pallas_interpret():
    q, k, v = _inputs(0, 1, 64, 4, 2, 32)
    got = ops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                              causal=False)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, block_q=32,
                                block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0), (False, 5)])
def test_plain_version_matches_reference_oracle(causal, window):
    q, k, v = _inputs(window + 3, 2, 30, 6, 3, 20)
    got = ref.flash_attention_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                                  causal=causal, window=window)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_grad_enabled_call_raises_and_no_grad_runs():
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 1, 16, 4, 2, 16))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape and not out.requires_grad
    # inputs that ask for no gradient need no no_grad block
    out = ops.flash_attention(q.detach(), k, v)
    assert out.shape == q.shape


def test_cpu_call_launches_nothing_and_checks_shapes():
    q, k, v = (torch.as_tensor(a) for a in _inputs(2, 1, 8, 4, 2, 16))
    before = fa.LAUNCHES["flash_attention"]
    ops.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16),
                            v[:, :, :1].expand(1, 8, 3, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=-1)

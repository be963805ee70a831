"""Port parity: the SSM and hybrid language models.

Each JAX smoke model is initialised by the reference, its value tree is
carried into the port with ``repro_torch.convert.model_from_numpy``, and
both packages run the same numpy-drawn inputs.  The port's models run with
``use_flash=True`` (on the CPU its scan is the plain version of the CUDA
kernel), the reference's with its ``lax.scan`` oracle.

Tolerances, stated per dtype and measured on the CPU:
  - float32: 1e-5 absolute and relative on every block output, state and
    logit (measured max abs difference 7.8e-6 over all cache leaves and
    1.5e-6 over logits, from a different summation order in the matrix
    products and reductions); greedy tokens equal.
  - bfloat16 prefill: logits within 2e-2 (measured 8.1e-3 for zamba2,
    0 for falcon-mamba, on logits of magnitude ~0.5), cache leaves within
    rtol/atol 5e-2 + 5e-2 (measured 6.6e-2 on KV values of magnitude ~3,
    a few bf16 steps, where rounding of bf16 products differs between
    XLA and PyTorch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import registry  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]


def _pair(arch, dtype="float32", seed=0):
    """(JAX model, its numpy value tree, JAX cfg, port model)."""
    jcfg = jsmoke(arch).replace(dtype=dtype)
    jm = jregistry.get_model(jcfg)
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(seed)))
    values = jax.tree.map(np.asarray, values)
    cfg = get_smoke_config(arch).replace(dtype=dtype, use_flash=True)
    return jm, values, jcfg, model_from_numpy(cfg, values, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param, seed=ARCHS.index(request.param))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or F32))


def _cache_leaves(cache):
    kv = list(cache["kv"]) if "kv" in cache else []
    return [cache["conv"], cache["ssm"]] + kv


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def test_configs_match_reference():
    from repro.configs import ARCH_IDS as JARCH
    assert ARCH_IDS == JARCH
    for arch in ARCH_IDS:
        for ours, ref in ((get_config(arch), jget_config(arch)),
                          (get_smoke_config(arch), jsmoke(arch))):
            assert ours.__dict__ == ref.__dict__


@pytest.mark.parametrize("arch", ARCHS + ["granite-3-2b", "h2o-danube-3-4b",
                                  "llava-next-mistral-7b"])
def test_count_params_match_reference_full_configs(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = {"falcon-mamba-7b": 7_006_326_784, "zamba2-1.2b": 1_105_066_752,
            "granite-3-2b": 2_533_787_648, "h2o-danube-3-4b": 3_838_959_360,
            "llava-next-mistral-7b": 7_110_660_096}
    assert registry.count_params(cfg) == jregistry.count_params(jcfg) \
        == want[arch]
    assert registry.count_active_params(cfg) == \
        jregistry.count_active_params(jcfg)


def test_unported_families_raise():
    """No family is left to port: encdec and MoE build, on ``meta``, with
    the reference's total and active parameter counts."""
    for arch in ("seamless-m4t-medium", "qwen2-moe-a2.7b",
                 "moonshot-v1-16b-a3b"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        model = registry.get_model(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == \
            jregistry.count_params(jcfg)
        assert registry.count_active_params(cfg) == \
            jregistry.count_active_params(jcfg)


@pytest.mark.parametrize("seed,S", [(0, 1), (1, 9), (2, 33)])
def test_conv_and_scan_helpers(seed, S):
    rng = np.random.default_rng(seed)
    Bt, Di, N, W = 2, 24, 4, 4
    x = rng.standard_normal((Bt, S, Di)).astype(np.float32)
    w = rng.standard_normal((Di, W)).astype(np.float32)
    b = rng.standard_normal((Di,)).astype(np.float32)
    _close(M.causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                           torch.as_tensor(b)),
           JM.causal_conv1d(x, w, b))
    st = rng.standard_normal((Bt, W - 1, Di)).astype(np.float32)
    got = M.conv1d_step(torch.as_tensor(st), torch.as_tensor(x[:, 0]),
                        torch.as_tensor(w), torch.as_tensor(b))
    want = JM.conv1d_step(st, x[:, 0], w, b)
    for g, r in zip(got, want):
        _close(g, r)
    h = rng.standard_normal((Bt, Di, N)).astype(np.float32)
    dt = rng.random((Bt, Di)).astype(np.float32) * 0.1
    A = -rng.random((Di, N)).astype(np.float32)
    Bv, Cv = (rng.standard_normal((Bt, N)).astype(np.float32)
              for _ in range(2))
    got = M.selective_step(*(torch.as_tensor(a) for a in
                             (h, x[:, 0], dt, A, Bv, Cv)))
    for g, r in zip(got, JM.selective_step(h, x[:, 0], dt, A, Bv, Cv)):
        _close(g, r)


def _block_case(pair, seed):
    jm, values, jcfg, model = pair
    family = model.cfg.family
    jblock = JM.mamba1_block if family == "ssm" else JM.mamba2_block
    block = M.mamba1_block if family == "ssm" else M.mamba2_block
    x = np.random.default_rng(seed).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    return (jax.tree.map(lambda a: a[1], values["layers"]), jblock,
            model.layers[1], block, x, jcfg, model.cfg)


def test_block_prefill_and_decode_match(pair):
    jlp, jblock, lp, block, x, jcfg, cfg = _block_case(pair, 3)
    jy, (jconv, jh) = jblock(jlp, jnp.asarray(x), jcfg)
    y, (conv, h) = block(lp, torch.as_tensor(x), cfg)
    _close(y, jy)
    _close(conv, jconv)
    _close(h, jh)
    # three decode steps from the prefill state
    jst, st = (jconv, jh), (conv, h)
    for t in range(3):
        xt = np.random.default_rng(10 + t).standard_normal(
            (2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jblock(jlp, jnp.asarray(xt), jcfg, state=jst)
        y, st = block(lp, torch.as_tensor(xt), cfg, state=st)
        _close(y, jy)
        for g, r in zip(st, jst):
            _close(g, r)


def test_block_kernel_path_equals_plain_path(pair):
    _, _, lp, block, x, _, cfg = _block_case(pair, 4)
    xt = torch.as_tensor(x)
    y1, (c1, h1) = block(lp, xt, cfg)
    y0, (c0, h0) = block(lp, xt, cfg.replace(use_flash=False))
    assert torch.equal(y1, y0) and torch.equal(c1, c0) and \
        torch.equal(h1, h0)


ATTN_CASES = [  # (S, capacity, window, q_chunk)
    (12, 16, 0, 0), (20, 16, 0, 0), (12, 16, 5, 0), (16, 24, 0, 4),
    (16, 16, 3, 4)]


@pytest.mark.parametrize("S,C,window,q_chunk", ATTN_CASES)
def test_prefill_and_decode_attention_match(S, C, window, q_chunk):
    _, values, jcfg, model = _pair("zamba2-1.2b", seed=1)
    jp = jax.tree.map(lambda a: a[0], values["shared"]["attn"])
    p = model.shared.attn
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads, head_dim=jcfg.hd,
              rope_theta=jcfg.rope_theta, window=window)
    x = np.random.default_rng(S + C).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    jout, jkv = JL.prefill_attention(jp, jnp.asarray(x), C,
                                     q_chunk=q_chunk, **kw)
    out, kv = L.prefill_attention(p, torch.as_tensor(x), C,
                                  q_chunk=q_chunk, **kw)
    _close(out, jout)
    for g, r in zip(kv, jkv):
        _close(g, r)
    for t in range(3):
        xt = np.random.default_rng(t).standard_normal(
            (2, 1, jcfg.d_model)).astype(np.float32)
        jout, jkv = JL.decode_attention(jp, jnp.asarray(xt), jkv,
                                        jnp.int32(S + t), **kw)
        out, kv = L.decode_attention(p, torch.as_tensor(xt), kv, S + t,
                                     **kw)
        _close(out, jout)
        for g, r in zip(kv, jkv):
            _close(g, r)


def test_model_prefill_and_greedy_decode_match(pair):
    jm, values, _, model = pair
    S, steps = 20, 6
    toks = _tokens(7, 2, S)
    jl, jc = jm.prefill(values, {"tokens": jnp.asarray(toks)}, S + steps)
    lg, cache = model.prefill({"tokens": torch.as_tensor(toks).long()},
                              S + steps)
    assert lg.shape == (2, 1, model.vocab_padded)
    _close(lg, jl)
    jleaves = [jc["conv"], jc["ssm"]] + (list(jc["kv"]) if "kv" in jc
                                         else [])
    assert len(_cache_leaves(cache)) == len(jleaves)
    for g, r in zip(_cache_leaves(cache), jleaves):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r)
    jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    cur = torch.argmax(lg[:, -1], -1)[:, None]
    for s in range(steps):
        jl, jc = jm.decode_step(values, jc, jcur, jnp.int32(S + s))
        lg, cache = model.decode_step(cache, cur, S + s)
        _close(lg, jl)
        jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        cur = torch.argmax(lg[:, -1], -1)[:, None]
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_matches(arch):
    jm, values, _, model = _pair(arch, dtype="bfloat16", seed=5)
    toks = _tokens(8, 2, 20)
    jl, jc = jm.prefill(values, {"tokens": jnp.asarray(toks)}, 26)
    lg, cache = model.prefill({"tokens": torch.as_tensor(toks).long()}, 26)
    _close(lg, jl, atol=2e-2, rtol=0)
    jleaves = [jc["conv"], jc["ssm"]] + (list(jc["kv"]) if "kv" in jc
                                         else [])
    for g, r in zip(_cache_leaves(cache), jleaves):
        assert g.dtype == (torch.int32 if r.dtype == np.int32 else
                           torch.float32 if r.dtype == np.float32 else
                           torch.bfloat16)
        _close(g, r, atol=5e-2, rtol=5e-2)


def test_meta_model_allocates_nothing():
    model = registry.get_model(get_config("falcon-mamba-7b"), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    assert all(not p.requires_grad for p in model.parameters())


def test_init_cache_matches_reference(pair):
    jm, _, _, model = pair
    jc = jm.init_cache(2, 24)
    cache = model.init_cache(2, 24)
    jleaves = [jc["conv"], jc["ssm"]] + (list(jc["kv"]) if "kv" in jc
                                         else [])
    assert len(_cache_leaves(cache)) == len(jleaves)
    for g, r in zip(_cache_leaves(cache), jleaves):
        assert tuple(g.shape) == tuple(r.shape)
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_array_equal(_np(g), _np(r))

"""Port parity: the encoder-decoder (``EncDecLM``, seamless-m4t) and its
layers (``full_attention(causal=False)``, ``cross_attention``,
``encode_cross_kv``).

The JAX smoke seamless (2 encoder and 2 decoder layers, d_model 64, 4/4
heads) is initialised by the reference, its value tree is carried into
the port with ``repro_torch.convert.model_from_numpy``, and both packages
run the same numpy-drawn frames and tokens in float32.  The encoder-
decoder runs the plain attention route in both packages (the reference
passes ``use_flash=False`` to its encoder and leaves its decoder at the
default), so it launches no kernel.

Tolerances, stated with their reasons: encoder outputs, attention
outputs, loss, decode logits and cache leaves within 1e-5 absolute and
relative (the packages sum matrix products and reductions in other
orders); gradients within 1e-5 x max|g| against ``jax.grad``; a 5-step
loss trajectory through each package's train step within rtol 1e-4;
``causal=False`` through the flash wrapper (its plain version here, the
reference's Pallas kernel in interpret mode) within flash's 2e-5
(``tests/test_kernels.py:78``).
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
from repro.models import module as jmodule  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.transformer import EncDecLM  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import (TrainConfig, init_state,  # noqa: E402
                                    make_train_step)

ARCH = "seamless-m4t-medium"
F32 = dict(atol=1e-5, rtol=1e-5)


def _pair(seed=0, **overrides):
    """(JAX model, its numpy value tree, JAX cfg, port model), float32."""
    jcfg = jsmoke(ARCH).replace(dtype="float32", **overrides)
    jm = jregistry.get_model(jcfg)
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(seed)))
    values = jax.tree.map(np.asarray, values)
    cfg = get_smoke_config(ARCH).replace(dtype="float32", **overrides)
    return jm, values, jcfg, model_from_numpy(cfg, values, "cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=0)


def _batch(cfg, seed, B=2, S=20):
    """frames (B, S, d), tokens and labels (B, S) from the token stream."""
    return TokenStream(cfg, B, S, seed=seed).batch_at(2)


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **(tol or F32))


def jax_leaf(tree, name, shape):
    """The numpy leaf of the reference's value tree that the port's
    parameter ``name`` holds (``enc_layers.1.attn.wq`` is layer 1 of
    ``tree["enc_layers"]["attn"].wq``)."""
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = node[part] if isinstance(node, dict) else \
                getattr(node, part)
    leaf = np.asarray(node)
    leaf = leaf if index is None else leaf[index]
    assert leaf.shape == tuple(shape), name
    return leaf


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route,S,q_chunk", [
    ("dense", 12, 0), ("chunked", 16, 4), ("flash", 12, 0)])
def test_bidirectional_full_attention_matches(pair, route, S, q_chunk):
    """``full_attention(causal=False)`` on the dense route (a zero mask),
    the query-chunked route and the flash wrapper, against the
    reference's; and it differs from the causal result."""
    _, values, jcfg, model = pair
    jp = jax.tree.map(lambda a: a[0], values["enc_layers"]["attn"])
    kw = dict(n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads, head_dim=jcfg.hd,
              rope_theta=jcfg.rope_theta, q_chunk=q_chunk,
              use_flash=route == "flash")
    x = np.random.default_rng(S).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    want = JL.full_attention(jp, None, jnp.asarray(x), causal=False, **kw)
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        got = L.full_attention(model.enc_layers[0].attn, torch.as_tensor(x),
                               causal=False, **kw)
        causal = L.full_attention(model.enc_layers[0].attn,
                                  torch.as_tensor(x), **kw)
    assert fa.LAUNCHES["flash_attention"] == before     # CPU: plain version
    tol = dict(atol=2e-5, rtol=2e-5) if route == "flash" else F32
    _close(got, want, **tol)
    assert float((got - causal).abs().max()) > 1e-3


def test_cross_attention_and_cross_kv_match(pair):
    _, values, jcfg, model = pair
    jp = jax.tree.map(lambda a: a[1], values["dec_layers"]["cross"])
    p = model.dec_layers[1].cross
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jkv = JL.encode_cross_kv(jp, jnp.asarray(enc), n_kv=jcfg.n_kv_heads,
                             head_dim=jcfg.hd)
    with torch.no_grad():
        kv = L.encode_cross_kv(p, torch.as_tensor(enc), n_kv=jcfg.n_kv_heads,
                               head_dim=jcfg.hd)
        out = L.cross_attention(p, torch.as_tensor(x), kv,
                                n_heads=jcfg.n_heads, n_kv=jcfg.n_kv_heads,
                                head_dim=jcfg.hd)
    for g, r in zip(kv, jkv):
        assert tuple(g.shape) == (2, 9, jcfg.n_kv_heads, jcfg.hd)
        _close(g, r)
    want = JL.cross_attention(jp, jnp.asarray(x), jkv, n_heads=jcfg.n_heads,
                              n_kv=jcfg.n_kv_heads, head_dim=jcfg.hd)
    _close(out, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_encode_matches(pair):
    """The encoder casts the frames to the model's dtype and attends over
    every frame."""
    jm, values, jcfg, model = pair
    frames = _batch(jcfg, seed=4)["frames"]
    want = jm.encode(values, jnp.asarray(frames))
    with torch.no_grad():
        got = model.encode(torch.as_tensor(frames).double())
    assert got.dtype == torch.float32
    _close(got, want)


def test_loss_matches(pair):
    jm, values, jcfg, model = pair
    b = _batch(jcfg, seed=5)
    jloss, jmet = jm.loss(values, _jax_batch(b))
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        loss, met = model.loss(_torch_batch(b))
    assert fa.LAUNCHES["flash_attention"] == before
    assert float(met["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **F32)


def test_chunked_routes_match():
    """The encoder's and decoder's query-chunked attention (S > 2 *
    attn_q_chunk) and the chunked cross entropy, against the
    reference's."""
    jm, values, jcfg, model = _pair(seed=6, attn_q_chunk=4, ce_seq_chunk=8)
    b = _batch(jcfg, seed=7, S=24)
    jloss, _ = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)


def test_gradients_match_reference(pair):
    jm, values, jcfg, model = pair
    b = _batch(jcfg, seed=8)
    jgrads = jax.grad(lambda v: jm.loss(v, _jax_batch(b))[0])(
        jax.tree.map(jnp.asarray, values))
    params = init_state(model).params
    loss, _ = model.loss(_torch_batch(b))
    grads = torch.autograd.grad(loss, list(params.values()))
    want = {k: jax_leaf(jgrads, k, p.shape) for k, p in params.items()}
    assert sum(g.size for g in want.values()) == \
        sum(g.size for g in jax.tree.leaves(jgrads))
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
    for p in params.values():
        p.requires_grad_(False)


def test_init_cache_and_decode_match(pair):
    """``init_cache(frames, seq_len)`` (the self ring and every layer's
    cross K/V) and a few ``decode_step``s: logits and caches within 1e-5;
    the padded vocabulary is not masked, as in the reference."""
    jm, values, jcfg, model = pair
    B, Se, steps, seq_len = 2, 7, 5, 8
    rng = np.random.default_rng(9)
    frames = (rng.standard_normal((B, Se, jcfg.d_model)) * 0.02).astype(
        np.float32)
    feed = rng.integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    jcache = jm.init_cache(values, jnp.asarray(frames), seq_len)
    cache = model.init_cache(torch.as_tensor(frames), seq_len)

    def leaves(c):
        return list(c["self"]) + list(c["cross"])

    def check_cache():
        for g, r in zip(leaves(cache), leaves(jcache)):
            assert tuple(g.shape) == tuple(np.asarray(r).shape)
            _close(g, r)

    assert len(leaves(cache)) == len(leaves(jcache)) == 5
    assert cache["cross"][0].shape == (jcfg.num_layers, B, Se,
                                       jcfg.n_kv_heads, jcfg.hd)
    check_cache()
    for t in range(steps):
        tok = feed[:, t:t + 1]
        jlog, jcache = jm.decode_step(values, jcache, jnp.asarray(tok),
                                      jnp.int32(t))
        logits, cache = model.decode_step(cache, torch.as_tensor(tok), t)
        assert logits.shape == (B, 1, model.vocab_padded)
        _close(logits, jlog)
    check_cache()


def test_five_step_loss_trajectory_matches_reference():
    jm, values, jcfg, model = _pair(seed=10)
    tc_args = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstate = jloop.init_state(jm, jax.random.PRNGKey(10))   # _pair's values
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**tc_args)))
    step = make_train_step(model, TrainConfig(**tc_args))
    stream = TokenStream(model.cfg, 4, 16, seed=11)
    state = init_state(model)
    for s in range(5):
        b = stream.batch_at(s)
        jstate, jmet = jstep(jstate, _jax_batch(b))
        state, met = step(state, b)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 5


def test_full_config_builds_on_meta_with_reference_count():
    cfg = get_config(ARCH)
    model = registry.get_model(cfg, device="meta")
    assert isinstance(model, EncDecLM)
    assert all(p.device.type == "meta" for p in model.parameters())
    n = registry.count_params(cfg)
    assert n == sum(p.numel() for p in model.parameters()) == \
        jregistry.count_params(jget_config(ARCH)) == 715_454_464
    assert registry.count_active_params(cfg) == \
        jregistry.count_active_params(jget_config(ARCH))
    assert (len(model.enc_layers), len(model.dec_layers)) == (12, 12)

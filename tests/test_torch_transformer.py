"""Port parity: the dense, MoE and VLM transformer (``TransformerLM``).

Each JAX smoke model is initialised by the reference, its value tree is
carried into the port with ``repro_torch.convert.model_from_numpy``, and
both packages run the same numpy-drawn inputs.  Both attention routes are
held against the reference's: ``use_flash=True`` (on the CPU the port's
flash wrapper runs the kernel's plain version, the reference its Pallas
kernel in interpret mode) and ``use_flash=False`` (dense products).

Serving: ``prefill`` (last logits and the KV cache) and ``decode_step``
(logits over 8+ steps, the cache written in place) against the
reference's, for granite (GQA), danube (a sliding window shorter than
the prompt, so the ring wraps) and qwen2-moe (routed and shared
experts); and the reference's own criterion that an incremental decode
equals the teacher-forced forward (relative 5e-3,
``tests/test_models.py::test_decode_matches_full_forward``).

Tolerances, stated per dtype: float32 hidden states, aux, loss, logits
and cache leaves within 1e-5 (absolute and relative; the packages sum
matrix products and reductions in other orders); bf16 loss within 2e-2
(bf16 products round at other places in XLA and PyTorch).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train.data import TokenStream as JTokenStream  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import registry  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
# granite (GQA), danube (sliding window, 16 in the smoke config), stablelm
# (head dim 20), phi3 (5/5 heads), llava (VLM prefix)
ARCHS = ["granite-3-2b", "h2o-danube-3-4b", "stablelm-12b",
         "phi3-medium-14b", "llava-next-mistral-7b"]


def _pair(arch, dtype="float32", seed=0, **overrides):
    """(JAX model, its numpy value tree, JAX cfg, port model)."""
    jcfg = jsmoke(arch).replace(dtype=dtype, **overrides)
    jm = jregistry.get_model(jcfg)
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(seed)))
    values = jax.tree.map(np.asarray, values)
    cfg = get_smoke_config(arch).replace(dtype=dtype, **overrides)
    return jm, values, jcfg, model_from_numpy(cfg, values, "cpu")


def _batch(cfg, seed, B=2, S=40):
    """A numpy batch from the reference's stream (tokens, labels and, for
    the VLM, prefix embeds)."""
    return JTokenStream(cfg, B, S, seed=seed).batch_at(3)


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param, seed=ARCHS.index(request.param))


@pytest.mark.parametrize("use_flash", [True, False])
def test_hidden_states_and_loss_match(pair, use_flash):
    jm, values, jcfg, model = pair
    jm.cfg = jcfg.replace(use_flash=use_flash)
    model.cfg = model.cfg.replace(use_flash=use_flash)
    b = _batch(jcfg, seed=11)
    jx = jm.embed_inputs(values, _jax_batch(b))
    jh, _ = jm.hidden_states(values, jx)
    jloss, jmet = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        x = model.embed_inputs(_torch_batch(b))
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), **F32)
        before = fa.LAUNCHES["flash_attention"]
        h, aux = model.hidden_states(x)
        loss, met = model.loss(_torch_batch(b))
    assert fa.LAUNCHES["flash_attention"] == before   # CPU: plain version
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **F32)
    assert float(aux) == 0.0


def test_flash_and_plain_routes_agree(pair):
    _, _, jcfg, model = pair
    b = _torch_batch(_batch(jcfg, seed=12))
    with torch.no_grad():
        model.cfg = model.cfg.replace(use_flash=True)
        lf, _ = model.loss(b)
        model.cfg = model.cfg.replace(use_flash=False)
        lp, _ = model.loss(b)
    np.testing.assert_allclose(float(lf), float(lp), **F32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-3-4b"])
def test_bf16_loss_matches(arch):
    jm, values, jcfg, model = _pair(arch, dtype="bfloat16", seed=5)
    b = _batch(jcfg, seed=13)
    jloss, _ = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-2,
                               rtol=2e-2)


def test_chunked_routes_match_reference():
    """q-chunked attention (S > 2 * attn_q_chunk) and the chunked
    cross-entropy (ce_seq_chunk) against the reference's."""
    jm, values, jcfg, model = _pair("h2o-danube-3-4b", seed=7,
                                    attn_q_chunk=8, ce_seq_chunk=16)
    b = _batch(jcfg, seed=14, S=48)
    jloss, _ = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)


def test_ignored_labels_and_padded_vocab():
    jm, values, jcfg, model = _pair("granite-3-2b", seed=8, vocab=250)
    b = _batch(jcfg, seed=15)
    b["labels"][:, :7] = -1
    jloss, _ = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
        logits = model._logits(model.hidden_states(
            model.embed_inputs(_torch_batch(b)))[0])
    assert model.vocab_padded > jcfg.vocab
    assert bool((logits[..., jcfg.vocab:] == -1e30).all())
    np.testing.assert_allclose(float(loss), float(jloss), **F32)


@pytest.mark.parametrize("arch,want,active", [
    ("granite-3-2b", 2_533_787_648, None),
    ("h2o-danube-3-4b", 3_838_959_360, None),
    ("stablelm-12b", None, None), ("phi3-medium-14b", None, None),
    ("llava-next-mistral-7b", None, None),
    ("qwen2-moe-a2.7b", 14_835_091_456, 2_433_373_388),
    ("moonshot-v1-16b-a3b", None, None)])
def test_count_params_of_full_configs(arch, want, active):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = registry.count_params(cfg)
    assert n == jregistry.count_params(jcfg)
    assert want is None or n == want
    n_active = registry.count_active_params(cfg)
    assert n_active == jregistry.count_active_params(jcfg)
    assert n_active == (n if cfg.n_experts == 0 else active or n_active)
    assert cfg.n_experts == 0 or n_active < n


def test_unported_parts_raise():
    """Nothing of the module is left to port: EncDecLM builds on ``meta``
    with the reference's parameter count (its smoke config too), and so
    does qwen2-moe, with a float32 router in a bf16 model."""
    for c, jc in ((get_config("seamless-m4t-medium"),
                   jget_config("seamless-m4t-medium")),
                  (get_smoke_config("seamless-m4t-medium"),
                   jsmoke("seamless-m4t-medium"))):
        model = registry.get_model(c, device="meta")
        assert type(model).__name__ == "EncDecLM"
        assert sum(p.numel() for p in model.parameters()) == \
            jregistry.count_params(jc)
    cfg = get_config("qwen2-moe-a2.7b")
    model = registry.get_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        jregistry.count_params(jget_config("qwen2-moe-a2.7b"))
    assert model.layers[0].moe.w_router.dtype == torch.float32
    assert model.layers[0].moe.w_gate.shape == (64, 2048, 1408)
    assert model.cache_capacity(8) == 8


# ---------------------------------------------------------------------------
# MoE forward, and serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_moe_hidden_states_aux_and_loss_match(arch):
    jm, values, jcfg, model = _pair(arch, seed=3)
    b = _batch(jcfg, seed=16)
    jh, jaux = jm.hidden_states(values, jm.embed_inputs(values,
                                                         _jax_batch(b)))
    jloss, jmet = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        h, aux = model.hidden_states(model.embed_inputs(_torch_batch(b)))
        loss, met = model.loss(_torch_batch(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), **F32)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), **F32)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **F32)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)


# (arch, config overrides, prompt length, decode steps, moe_group)
SERVING = [("granite-3-2b", {}, 12, 8, None),
           ("h2o-danube-3-4b", {"sliding_window": 8}, 13, 9, None),
           ("qwen2-moe-a2.7b", {}, 12, 8, None),
           ("qwen2-moe-a2.7b", {}, 7, 8, True)]


def _np_cache(cache):
    return [np.asarray(leaf) for leaf in cache]


@pytest.mark.parametrize("arch,overrides,S,steps,moe_group", SERVING,
                         ids=[f"{a}-{S}" + ("-group" if g else "")
                              for a, _, S, _, g in SERVING])
def test_prefill_and_decode_match_reference(arch, overrides, S, steps,
                                            moe_group):
    jm, values, jcfg, model = _pair(arch, seed=4, **overrides)
    B, total = 2, S + steps
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab, (B, steps)).astype(np.int32)
    assert model.cache_capacity(total) == jm.cache_capacity(total)
    jlog, jcache = jm.prefill(values, {"tokens": jnp.asarray(prompt)}, total)
    logits, cache = model.prefill({"tokens": torch.as_tensor(prompt)}, total)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **F32)
    for got, want in zip(cache, _np_cache(jcache)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, **F32)
    for t in range(steps):
        tok = feed[:, t:t + 1]
        jlog, jcache = jm.decode_step(values, jcache, jnp.asarray(tok),
                                      jnp.int32(S + t), moe_group=moe_group)
        logits, cache = model.decode_step(cache, torch.as_tensor(tok),
                                          S + t, moe_group=moe_group)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **F32)
    for got, want in zip(cache, _np_cache(jcache)):
        np.testing.assert_allclose(got.float().numpy(), want, **F32)


def test_init_cache_matches_reference():
    jm, _, _, model = _pair("h2o-danube-3-4b", sliding_window=8)
    for seq in (6, 20):
        for got, want in zip(model.init_cache(2, seq),
                             _np_cache(jm.init_cache(2, seq))):
            assert got.dtype == getattr(torch, str(want.dtype))
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-3-4b",
                                  "qwen2-moe-a2.7b"])
def test_decode_matches_teacher_forced_forward(arch):
    """The reference's criterion: decoding S tokens one by one from an
    empty cache gives the full forward's logits to relative 5e-3 (MoE at
    a drop-free capacity factor)."""
    cfg = get_smoke_config(arch).replace(dtype="float32", remat=False,
                                         capacity_factor=8.0)
    model = registry.get_model(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    B, S = 2, 24
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)))
    with torch.no_grad():
        ref = model._logits(model.hidden_states(
            model.embed_inputs({"tokens": tokens}))[0])
        cache = model.init_cache(B, S)
        outs = []
        for t in range(S):
            lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
            outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    scale = float(ref.abs().max()) + 1e-9
    assert float((dec - ref).abs().max()) / scale < 5e-3

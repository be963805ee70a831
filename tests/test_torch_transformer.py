"""Port parity: the dense and VLM transformer (``TransformerLM``).

Each JAX smoke model is initialised by the reference, its value tree is
carried into the port with ``repro_torch.convert.model_from_numpy``, and
both packages run the same numpy-drawn inputs.  Both attention routes are
held against the reference's: ``use_flash=True`` (on the CPU the port's
flash wrapper runs the kernel's plain version, the reference its Pallas
kernel in interpret mode) and ``use_flash=False`` (dense products).

Tolerances, stated per dtype: float32 hidden states and loss within 1e-5
(absolute and relative; the packages sum matrix products and reductions
in other orders); bf16 loss within 2e-2 (bf16 products round at other
places in XLA and PyTorch).
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
from repro_torch.models.transformer import TransformerLM  # noqa: E402

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


@pytest.mark.parametrize("arch,want", [
    ("granite-3-2b", 2_533_787_648), ("h2o-danube-3-4b", 3_838_959_360),
    ("stablelm-12b", None), ("phi3-medium-14b", None),
    ("llava-next-mistral-7b", None)])
def test_count_params_of_full_configs(arch, want):
    n = registry.count_params(get_config(arch))
    assert n == jregistry.count_params(jget_config(arch))
    assert want is None or n == want
    assert registry.count_active_params(get_config(arch)) == n


def test_unported_parts_raise():
    model = registry.get_model(get_smoke_config("granite-3-2b"),
                               device="meta")
    for call in (lambda: model.init_cache(1, 8),
                 lambda: model.prefill({}, 8),
                 lambda: model.decode_step(None, None, 0),
                 lambda: model.cache_capacity(8)):
        with pytest.raises(NotImplementedError, match="serving"):
            call()
    with pytest.raises(NotImplementedError, match="MoE"):
        TransformerLM(get_smoke_config("qwen2-moe-a2.7b"), device="meta")

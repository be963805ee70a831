"""Port parity: training the MoE family (qwen2-moe's smoke config) against
the reference.

The JAX smoke qwen2-moe (float32: 2 layers, 8 routed experts, top-2, 2
shared experts) is initialised by the reference and its value tree is
carried into the port with ``repro_torch.convert.model_from_numpy``, so
both packages train the same weights on the same batches.  The routed
path is exercised whole: top-k renormalisation, the Switch aux loss
(weighted 0.01 into the loss) and capacity drops, at the config's
capacity factor and at a factor low enough that most experts overflow.

Tolerances, stated with their reasons:
  - loss, nll and aux: rtol 1e-5 (the packages sum products and
    reductions in other orders);
  - gradients: within 1e-5 x max|g| of ``jax.grad`` of the reference loss
    (summation order), as for granite in ``test_torch_train.py``;
  - a 5-step loss and grad-norm trajectory through each package's own
    train step: rtol 1e-4, as for granite.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.models.layers import moe_routing  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import (TrainConfig, init_state,  # noqa: E402
                                    make_train_step)

ARCH = "qwen2-moe-a2.7b"
# the config's own factor, and one under which most experts drop tokens
CAPACITY = [1.25, 0.5]


def _pair(seed, capacity_factor):
    """(JAX model, its TrainState, port model holding the same weights)."""
    over = dict(dtype="float32", capacity_factor=capacity_factor)
    jm = jregistry.get_model(jsmoke(ARCH).replace(**over))
    state = jloop.init_state(jm, jax.random.PRNGKey(seed))
    values = jax.tree.map(np.asarray, state.params)
    cfg = get_smoke_config(ARCH).replace(**over)
    return jm, state, model_from_numpy(cfg, values, "cpu")


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _jax_leaf(tree, name):
    """The numpy leaf of a JAX TransformerLM tree that the port's
    parameter ``name`` holds (a layer index takes that layer of the
    stacked leaf)."""
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = _field(node, part)
    leaf = np.asarray(node)
    return leaf if index is None else leaf[index]


def _dropped_share(model, b) -> float:
    """The share of the first layer's (token, choice) pairs that overflow
    their expert's capacity on batch ``b``."""
    lp = model.layers[0]
    with torch.no_grad():
        x = model.embed[torch.as_tensor(b["tokens"])]
        h = rms_norm(lp.mlp_norm, x)
        r = moe_routing(lp.moe, h, n_experts=model.cfg.n_experts,
                        top_k=model.cfg.top_k,
                        capacity_factor=model.cfg.capacity_factor)
    return float((~r.keep).float().mean())


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_gradients_match_reference(capacity_factor):
    jm, jstate, model = _pair(0, capacity_factor)
    b = TokenStream(model.cfg, 4, 24, seed=2).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda v: jm.loss(v, jb), has_aux=True)(jstate.params)
    state = init_state(model)
    loss, metrics = model.loss({k: torch.as_tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, list(state.params.values()))

    assert _dropped_share(model, b) > (0.2 if capacity_factor < 1 else 0.0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]),
                                   rtol=1e-5, err_msg=k)
    want = {k: _jax_leaf(jgrads, k) for k in state.params}
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(state.params, grads):
        assert g.shape == want[name].shape, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
    # every routed expert weight of every layer receives a gradient
    for name, g in zip(state.params, grads):
        if ".moe.w_" in name and name.endswith(("gate", "up", "down")):
            assert float(g.abs().amax()) > 0, name


@pytest.mark.parametrize("capacity_factor", CAPACITY)
def test_moe_five_step_trajectory_matches_reference(capacity_factor):
    jm, jstate, model = _pair(2, capacity_factor)
    tc_args = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**tc_args)))
    step = make_train_step(model, TrainConfig(**tc_args))
    stream = TokenStream(model.cfg, 4, 24, seed=6)
    state = init_state(model)
    for s in range(5):
        b = stream.batch_at(s)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4,
                                       err_msg=f"step {s} {k}")
        np.testing.assert_allclose(m["lr"], float(jm_["lr"]), rtol=1e-6)
    assert state.step == int(jstate.step) == 5

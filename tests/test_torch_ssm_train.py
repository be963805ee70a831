"""Port parity: training and evaluation of the SSM and hybrid language
models (``MambaLM`` / ``HybridLM`` ``hidden_states`` and ``loss``), and
the selective scan in chunks of time steps.

Each JAX smoke model (falcon-mamba: 2 Mamba-1 layers; zamba2: 5 Mamba-2
layers with ``shared_attn_every=2``, so 3 applications of the tied
block) is initialised by the reference, its value tree is carried into
the port with ``repro_torch.convert.model_from_numpy``, and both packages
run the same numpy-drawn inputs in float32.  The kernel routes
(``use_flash=True``) run as the reference's own tests run them on the
CPU: the reference's Pallas kernels in interpret mode, the port's
wrappers through their plain versions.

Tolerances, stated with their reasons:
  - hidden states, states and loss: 1e-5 absolute and relative (the
    packages sum matrix products and reductions in other orders);
  - gradients: 1e-5 x max|g| against ``jax.grad`` of the reference loss;
  - a 5-step loss trajectory through each package's own train step:
    rtol 1e-4;
  - ``selective_scan`` at any chunk size: bitwise against a step-by-step
    loop, 1e-5 against the reference's chunked scan;
  - ``use_flash=True`` losses against the reference: the scan's 1e-4 in
    float32 (``tests/test_kernels.py:112-127``), the looser of it and
    flash's 2e-5 (``:78``), which the hybrid's loss also goes through;
    against the port's own plain route 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as ssm  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import (TrainConfig, init_state,  # noqa: E402
                                    make_train_step)

F32 = dict(atol=1e-5, rtol=1e-5)
SCAN_F32 = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]


def _pair(arch, seed=0, **overrides):
    """(JAX model, its numpy value tree, JAX cfg, port model), float32."""
    jcfg = jsmoke(arch).replace(dtype="float32", **overrides)
    jm = jregistry.get_model(jcfg)
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(seed)))
    values = jax.tree.map(np.asarray, values)
    cfg = get_smoke_config(arch).replace(dtype="float32", **overrides)
    return jm, values, jcfg, model_from_numpy(cfg, values, "cpu")


def _batch(cfg, seed, B=2, S=24):
    return TokenStream(cfg, B, S, seed=seed).batch_at(1)


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def jax_leaf(tree, name, shape):
    """The numpy leaf of a JAX value tree that the port's parameter
    ``name`` holds: a per-layer module's index takes that layer of the
    stacked leaf, and a block stacked ``(1, ...)`` (the hybrid's shared
    attention and MLP) gives its one entry."""
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = _field(node, part)
    leaf = np.asarray(node)
    if index is not None:
        leaf = leaf[index]
    elif leaf.shape != tuple(shape) and leaf.shape[1:] == tuple(shape):
        leaf = leaf[0]
    assert leaf.shape == tuple(shape), name
    return leaf


def grads_match(jm, values, model, b):
    """Gradients of the port's loss against ``jax.grad`` of the
    reference's, every parameter within 1e-5 x max|g|."""
    jgrads = jax.grad(lambda v: jm.loss(v, _jax_batch(b))[0])(
        jax.tree.map(jnp.asarray, values))
    params = init_state(model).params
    loss, _ = model.loss(_torch_batch(b))
    grads = torch.autograd.grad(loss, list(params.values()))
    want = {k: jax_leaf(jgrads, k, p.shape) for k, p in params.items()}
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
    return params, grads


# ---------------------------------------------------------------------------
# selective_scan in chunks
# ---------------------------------------------------------------------------
def _scan_inputs(seed, Bt, S, Di, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, Di)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bt, S, Di)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal((Di, N)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((Bt, S, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, N)).astype(np.float32)
    return x, dt, A, B, C


def _step_scan(x, dt, A, B, C):
    """The reference's scan one time step at a time, in torch."""
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]))
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t, :, None] * A[None])
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.sum(h * C[:, t, None, :], dim=-1))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("Bt,S,Di,N,chunk", [
    (2, 32, 24, 4, 8), (1, 48, 33, 5, 16), (3, 20, 16, 8, 4),
    (2, 30, 24, 4, 8), (1, 16, 7, 3, 16), (2, 37, 9, 4, 0)])
def test_selective_scan_chunked(Bt, S, Di, N, chunk):
    """``selective_scan`` in chunks of ``chunk`` steps (dividing S or not;
    0 takes ``SCAN_CHUNK``) is bitwise a step-by-step loop, and within
    1e-5 of the reference's chunked scan."""
    args = _scan_inputs(S * Di + chunk, Bt, S, Di, N)
    targs = [torch.as_tensor(a) for a in args]
    y, h = M.selective_scan(*targs, chunk=chunk)
    y0, h0 = _step_scan(*targs)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    jy, jh = JM.selective_scan_chunked(*args, chunk=chunk or M.SCAN_CHUNK)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_time_chunk_route_matches(arch):
    """``cfg.ssm_time_chunk`` sets the scan's chunk: the loss equals the
    default chunk's bitwise and the reference's chunked route's within
    1e-5."""
    jm, values, jcfg, model = _pair(arch, seed=3, ssm_time_chunk=8)
    b = _batch(jcfg, seed=4)
    jloss, _ = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
        model.cfg = model.cfg.replace(ssm_time_chunk=0)
        plain, _ = model.loss(_torch_batch(b))
    assert torch.equal(loss, plain)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)


# ---------------------------------------------------------------------------
# hidden states, loss and gradients
# ---------------------------------------------------------------------------
def test_mamba_hidden_states_and_states_match():
    """``MambaLM.hidden_states(with_state=True)``: states and per-layer
    final (conv, ssm) states against the reference's, and the same states
    as ``prefill``'s cache."""
    jm, values, jcfg, model = _pair("falcon-mamba-7b", seed=0)
    toks = _batch(jcfg, seed=5)["tokens"]
    jx = jnp.asarray(values["embed"])[jnp.asarray(toks)]
    jh, (jconv, jssm) = jm.hidden_states(values, jx, with_state=True)
    with torch.no_grad():
        x = model.embed[torch.as_tensor(toks).long()]
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), **F32)
        h, (conv, ssm_state) = model.hidden_states(x, with_state=True)
        h_only, none = model.hidden_states(x)
        _, cache = model.prefill({"tokens": torch.as_tensor(toks)},
                                 toks.shape[1])
    assert none is None and torch.equal(h_only, h)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **F32)
    np.testing.assert_allclose(ssm_state.numpy(), np.asarray(jssm), **F32)
    assert torch.equal(cache["conv"], conv)
    assert torch.equal(cache["ssm"], ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches(arch):
    jm, values, jcfg, model = _pair(arch, seed=ARCHS.index(arch))
    b = _batch(jcfg, seed=6)
    jloss, jmet = jm.loss(values, _jax_batch(b))
    with torch.no_grad():
        loss, met = model.loss(_torch_batch(b))
    assert loss.dtype == torch.float32 and float(met["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    np.testing.assert_allclose(float(met["nll"]), float(jmet["nll"]), **F32)


def test_hybrid_hidden_states_match():
    jm, values, jcfg, model = _pair("zamba2-1.2b", seed=1)
    assert model.group_sizes == [2, 2, 1]
    toks = _batch(jcfg, seed=7)["tokens"]
    jh = jm.hidden_states(values, jnp.asarray(values["embed"])[toks])
    with torch.no_grad():
        h = model.hidden_states(model.embed[torch.as_tensor(toks).long()])
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    jm, values, jcfg, model = _pair(arch, seed=2)
    params, grads = grads_match(jm, values, model, _batch(jcfg, seed=8))
    if arch == "zamba2-1.2b":
        # the tied block's gradient sums over its 3 applications: each
        # of its leaves gets one
        shared = [g for k, g in zip(params, grads) if k.startswith("shared.")]
        assert len(shared) == 9 and all(float(g.abs().max()) > 0
                                        for g in shared)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_gradients(arch):
    """Recomputing the Mamba layers changes nothing: the gradients with
    ``remat`` equal those without, bitwise."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    b = _torch_batch(_batch(cfg, seed=9))
    out = []
    for remat in (True, False):
        model = get_model(cfg.replace(remat=remat), device="cpu",
                          generator=torch.Generator().manual_seed(0))
        params = init_state(model).params
        out.append(torch.autograd.grad(model.loss(b)[0],
                                       list(params.values())))
    assert all(torch.equal(g, r) for g, r in zip(*out))


# ---------------------------------------------------------------------------
# the kernel route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_loss_matches(arch):
    """``use_flash=True`` under ``no_grad``: the port's wrappers (their
    plain versions here, counted 0 launches) against the reference's
    Pallas kernels in interpret mode, and against the port's plain
    route."""
    jm, values, jcfg, model = _pair(arch, seed=4, use_flash=True)
    b = _batch(jcfg, seed=10)
    jloss, _ = jm.loss(values, _jax_batch(b))
    before = ssm.LAUNCHES["ssm_scan"]
    with torch.no_grad():
        loss, _ = model.loss(_torch_batch(b))
        model.cfg = model.cfg.replace(use_flash=False)
        plain, _ = model.loss(_torch_batch(b))
    assert ssm.LAUNCHES["ssm_scan"] == before
    np.testing.assert_allclose(float(loss), float(jloss), **SCAN_F32)
    np.testing.assert_allclose(float(loss), float(plain), **F32)


def test_backward_through_scan_route_raises():
    """The scan kernel has no gradient: a grad-enabled loss with
    ``use_flash=True`` raises, on every device, instead of returning
    gradients that skip the scan; under ``no_grad`` it evaluates."""
    cfg = get_smoke_config("falcon-mamba-7b").replace(dtype="float32",
                                                      use_flash=True)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    init_state(model)
    b = _torch_batch(TokenStream(cfg, 2, 16).batch_at(0))
    with pytest.raises(RuntimeError, match="forward-only"):
        model.loss(b)[0].backward()
    with torch.no_grad():
        assert bool(torch.isfinite(model.loss(b)[0]))
    x = torch.zeros((1, 4, 8), requires_grad=True)
    args = (torch.full((1, 4, 8), 0.1), -torch.ones(8, 2),
            torch.ones(1, 4, 2), torch.ones(1, 4, 2))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssm_scan(x, *args)
    with torch.no_grad():
        y, _ = ops.ssm_scan(x, *args)
    assert y.shape == (1, 4, 8)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_five_step_loss_trajectory_matches_reference(arch):
    jm, values, jcfg, model = _pair(arch, seed=5)
    tc_args = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstate = jloop.init_state(jm, jax.random.PRNGKey(5))   # _pair's values
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**tc_args)))
    step = make_train_step(model, TrainConfig(**tc_args))
    stream = TokenStream(model.cfg, 4, 16, seed=6)
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

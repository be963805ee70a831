"""Port parity: the training substrate (``repro_torch.train``) and the
launcher (``repro_torch.launch.train``).

The JAX smoke granite (float32) is initialised by the reference and its
value tree is carried into the port, so both packages train the same
weights on the same batches.  Tolerances, stated with their reasons:

- ``TokenStream`` batches: bitwise (the same Philox counters and draws).
- gradients: within 1e-5 x max|g| (summation order of the products).
- the optimizer alone, fed the reference's own gradients: rtol 1e-6 (a
  few float32 ulps from fused multiply-adds).  Parameters are not compared
  after a step of the full train step: Adam's first step is close to
  lr * sign(g), so 1e-9 differences in near-zero gradients flip whole
  updates.
- a 5-step loss trajectory: rtol 1e-4.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_from_numpy  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import (TrainConfig, init_state,  # noqa: E402
                                    make_train_step, train)

ARCH = "granite-3-2b"


def _cfgs(dtype="float32"):
    return (jsmoke(ARCH).replace(dtype=dtype),
            get_smoke_config(ARCH).replace(dtype=dtype))


def _jax_state(seed=0):
    """(JAX model, its TrainState, port model holding the same weights)."""
    jcfg, cfg = _cfgs()
    jm = jregistry.get_model(jcfg)
    state = jloop.init_state(jm, jax.random.PRNGKey(seed))
    values = jax.tree.map(np.asarray, state.params)
    return jm, state, model_from_numpy(cfg, values, "cpu")


def _fresh(seed=0, cfg=None):
    cfg = cfg or _cfgs()[1]
    return get_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


def _flat_jax(tree):
    """{port parameter name: numpy leaf} of a JAX TransformerLM tree."""
    out = {"embed": np.asarray(tree["embed"]),
           "final_norm": np.asarray(tree["final_norm"])}
    lyr = tree["layers"]
    L = lyr["attn_norm"].shape[0]
    for i in range(L):
        out[f"layers.{i}.attn_norm"] = np.asarray(lyr["attn_norm"][i])
        out[f"layers.{i}.mlp_norm"] = np.asarray(lyr["mlp_norm"][i])
        for sub in ("attn", "mlp"):
            for f in lyr[sub]._fields:
                out[f"layers.{i}.{sub}.{f}"] = np.asarray(
                    getattr(lyr[sub], f)[i])
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-mistral-7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("host_index,host_count", [(0, 1), (1, 2)])
def test_token_stream_is_bitwise_the_reference(arch, host_index, host_count):
    ours = TokenStream(get_smoke_config(arch), 8, 24, seed=3,
                       host_index=host_index, host_count=host_count)
    ref = jdata.TokenStream(jsmoke(arch), 8, 24, seed=3,
                            host_index=host_index, host_count=host_count)
    for step in (0, 7, 10_000):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "b": rng.standard_normal((5,)).astype(dtype),
            "z": np.zeros((3,), dtype)}


def test_clip_and_global_norm_match_reference():
    g = _tree(0)
    for max_norm in (1.0, 100.0):
        ours, norm = opt.clip_by_global_norm(
            {k: torch.as_tensor(v) for k, v in g.items()}, max_norm)
        want, jnorm = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in g:
            assert ours[k].dtype == torch.float32
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_cosine_schedule_matches_reference():
    ours = opt.cosine_schedule(3e-4, 10, 100)
    ref = jopt.cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(ours(s), float(ref(s)), rtol=1e-6,
                                   atol=1e-12)
    assert ours(0) == 0.0


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_reference_over_steps(wd):
    params = _tree(1)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ours, ref = opt.AdamW(weight_decay=wd), jopt.AdamW(weight_decay=wd)
    st, jst = ours.init(tp), ref.init(jp)
    for step in range(4):
        g = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        up, st = ours.update({k: torch.as_tensor(v) for k, v in g.items()},
                             st, tp, lr=lr)
        tp = opt.apply_updates(tp, up)
        jup, jst = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp, lr=jnp.float32(lr))
        jp = jopt.apply_updates(jp, jup)
        assert st.step == int(jst.step)
        for k in params:
            for a, b in ((st.mu[k], jst.mu[k]), (st.nu[k], jst.nu[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-9)
            # from step 3 XLA's float32 b2 ** t and numpy's differ by an
            # ulp, which 1 - b2 ** t (~3e-3) turns into ~2e-5 of the update
            np.testing.assert_allclose(up[k].numpy(), np.asarray(jup[k]),
                                       rtol=1e-4, atol=1e-9)
            # the params carry those differences: 1e-4 of the summed lrs
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-5)


def test_adamw_bf16_params_keep_their_dtype():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    g = {"w": torch.full((4, 4), 2.0, dtype=torch.bfloat16)}
    adam = opt.AdamW(lr=0.1, weight_decay=0.1)
    st = adam.init(p)
    assert st.mu["w"].dtype == torch.float32
    up, st = adam.update(g, st, p)
    assert up["w"].dtype == torch.bfloat16
    opt.apply_updates(p, up)
    assert p["w"].dtype == torch.bfloat16 and float(p["w"][0, 0]) < 1.0


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------
def test_gradients_match_reference():
    jm, jstate, model = _jax_state()
    b = jdata.TokenStream(jm.cfg, 4, 24, seed=2).batch_at(0)
    jgrads = jax.grad(lambda v: jm.loss(v, {k: jnp.asarray(x) for k, x in
                                            b.items()})[0])(jstate.params)
    jflat = _flat_jax(jgrads)
    state = init_state(model)
    loss, _ = model.loss({k: torch.as_tensor(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, list(state.params.values()))
    assert sorted(jflat) == sorted(state.params)
    gmax = max(float(np.abs(g).max()) for g in jflat.values())
    for name, g in zip(state.params, grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)


def test_optimizer_on_reference_gradients_matches():
    """One AdamW step of the port on the reference's own clipped grads."""
    jm, jstate, model = _jax_state(seed=1)
    b = jdata.TokenStream(jm.cfg, 4, 24, seed=4).batch_at(0)
    jgrads = jax.grad(lambda v: jm.loss(v, {k: jnp.asarray(x) for k, x in
                                            b.items()})[0])(jstate.params)
    jclipped, _ = jopt.clip_by_global_norm(jgrads, 1.0)
    ref = jopt.AdamW(weight_decay=0.1)
    jup, jopt_state = ref.update(jclipped, jstate.opt, jstate.params,
                                 lr=jnp.float32(1e-3))
    jnew = _flat_jax(jopt.apply_updates(jstate.params, jup))
    state = init_state(model)
    grads = {k: torch.as_tensor(v.copy())
             for k, v in _flat_jax(jclipped).items()}
    up, new_opt = opt.AdamW(weight_decay=0.1).update(grads, state.opt,
                                                      state.params, lr=1e-3)
    opt.apply_updates(state.params, up)
    jmu = _flat_jax(jopt_state.mu)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jnew[k], rtol=1e-6,
                                   atol=1e-9, err_msg=k)
        np.testing.assert_allclose(new_opt.mu[k].numpy(), jmu[k], rtol=1e-6,
                                   atol=1e-12, err_msg=k)


def test_five_step_loss_trajectory_matches_reference():
    jm, jstate, model = _jax_state(seed=2)
    tc_args = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**tc_args)))
    step = make_train_step(model, TrainConfig(**tc_args))
    stream = TokenStream(model.cfg, 4, 24, seed=6)
    state = init_state(model)
    for s in range(5):
        b = stream.batch_at(s)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(m["lr"], float(jm_["lr"]), rtol=1e-6)
    assert state.step == int(jstate.step) == 5


def test_microbatch_accumulation_matches_full_batch():
    stream = TokenStream(_cfgs()[1], batch=8, seq=16, seed=1)
    batch = stream.batch_at(0)
    out = {}
    for n in (1, 4):
        model = _fresh(seed=0)
        tc = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                         microbatches=n)
        state, m = make_train_step(model, tc)(init_state(model), batch)
        out[n] = (float(m["loss"]), {k: p.detach().clone()
                                     for k, p in state.params.items()})
    assert out[1][0] == pytest.approx(out[4][0], rel=1e-4)
    for k in out[1][1]:
        np.testing.assert_allclose(out[1][1][k].numpy(), out[4][1][k].numpy(),
                                   atol=5e-4, rtol=1e-2)


def test_loss_falls_below_iid_entropy():
    """The Markov token stream is learnable: within 60 steps the loss falls
    below ln(V) and well below the untrained model's."""
    model = _fresh(seed=0)
    stream = TokenStream(model.cfg, batch=8, seq=32, seed=0)
    eval_b = {k: torch.as_tensor(v) for k, v in stream.batch_at(999).items()}
    with torch.no_grad():
        init_loss = float(model.loss(eval_b)[0])
    train(model, TrainConfig(lr=3e-3, warmup_steps=2, total_steps=60),
          stream, steps=60, log_every=0, log_fn=lambda *_: None)
    with torch.no_grad():
        final_loss = float(model.loss(eval_b)[0])
    assert final_loss < math.log(model.cfg.vocab)
    assert final_loss < init_loss - 0.5, (init_loss, final_loss)


def test_backward_through_flash_route_raises():
    model = _fresh(seed=0)
    model.cfg = model.cfg.replace(use_flash=True)
    init_state(model)
    b = {k: torch.as_tensor(v) for k, v in
         TokenStream(model.cfg, 2, 16).batch_at(0).items()}
    with pytest.raises(RuntimeError, match="forward-only"):
        model.loss(b)[0].backward()
    with torch.no_grad():
        assert bool(torch.isfinite(model.loss(b)[0]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_and_atomicity(tmp_path, dtype):
    cfg = _cfgs(dtype)[1]
    model = _fresh(seed=0, cfg=cfg)
    state = init_state(model)
    stream = TokenStream(cfg, 2, 16, seed=0)
    state, _ = make_train_step(model, TrainConfig(warmup_steps=0))(
        state, stream.batch_at(0))
    d = str(tmp_path / "ck")
    path = ckpt.save(d, state, step=5)
    assert os.path.basename(path) == "step_00000005"
    assert not any(p.endswith(".tmp") for p in os.listdir(d))
    other = init_state(_fresh(seed=1, cfg=cfg))
    restored = ckpt.restore(path, like=other)
    assert restored.step == 1 and restored.opt.step == 1
    for tree_a, tree_b in ((state.params, restored.params),
                           (state.opt.mu, restored.opt.mu),
                           (state.opt.nu, restored.opt.nu)):
        for k in tree_a:
            assert tree_b[k].dtype == tree_a[k].dtype
            assert torch.equal(tree_a[k], tree_b[k]), k
    for s in (6, 7, 8, 9):
        ckpt.save(d, state, step=s, keep=3)
    os.makedirs(os.path.join(d, "step_00000010.tmp"))   # a crashed write
    names = sorted(os.listdir(d))
    assert names == ["step_00000007", "step_00000008", "step_00000009",
                     "step_00000010.tmp"]
    assert ckpt.find_latest(d).endswith("step_00000009")


def test_checkpoint_restart_resumes_bitwise(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
    cfg = _cfgs()[1]
    stream = TokenStream(cfg, batch=4, seq=16, seed=5)
    tc = TrainConfig(lr=1e-3, warmup_steps=0, total_steps=6)
    quiet = dict(log_every=0, log_fn=lambda *_: None)
    sA = train(_fresh(seed=3), tc, stream, steps=6, **quiet)
    d = str(tmp_path / "ck")
    train(_fresh(seed=3), tc, stream, steps=3, checkpoint_dir=d, **quiet)
    sB = train(_fresh(seed=3), tc, stream, steps=6, checkpoint_dir=d,
               **quiet)                       # restores step 3, continues
    assert sB.step == 6 and sB.opt.step == 6
    for k in sA.params:
        assert torch.equal(sA.params[k], sB.params[k]), k
        assert torch.equal(sA.opt.nu[k], sB.opt.nu[k]), k


# ---------------------------------------------------------------------------
# the whole slice: the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [ARCH, "falcon-mamba-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_launcher_trains_and_resumes_on_cpu(tmp_path, arch):
    """The launcher trains every family; 4 steps, a checkpoint and 2 more
    from it equal 6 steps straight, bitwise."""
    d = str(tmp_path / "ck")
    lines = []
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-every", "2"]
    quiet = dict(log_fn=lambda *_: None)
    _, straight, _ = launch_train.main(args + ["--steps", "6"], **quiet)
    model, state, hist = launch_train.main(
        args + ["--ckpt-dir", d, "--steps", "4"], log_fn=lines.append)
    assert state.step == 4 and [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in hist)
    assert hist[0]["lr"] == 0.0            # warmup: the first step's lr is 0
    assert model.cfg.dtype == "float32" and ckpt.find_latest(d).endswith(
        "step_00000004")
    assert not model.cfg.use_flash
    model2, state2, hist2 = launch_train.main(
        args + ["--ckpt-dir", d, "--steps", "6"], log_fn=lines.append)
    assert state2.step == 6 and [h["step"] for h in hist2] == [5, 6]
    assert any("restored step 4" in line for line in lines)
    for k, p in straight.params.items():
        assert torch.equal(state2.params[k], p), k
    _, moe_state, moe_hist = launch_train.main(
        ["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
         "--steps", "1", "--batch", "2", "--seq", "16"], **quiet)
    assert moe_state.step == 1 and np.isfinite(moe_hist[0]["loss"])

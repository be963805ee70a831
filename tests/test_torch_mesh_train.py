"""Port parity: training on a device mesh (``repro_torch.dist``,
``repro_torch.launch.{mesh,shardings,train}``, the mesh-aware train step
and checkpoint), on gloo CPU ranks, for every family: dense (granite),
MoE, VLM, SSM (falcon-mamba), hybrid (zamba2) and encoder-decoder
(seamless).

The ranks are started with ``torch.multiprocessing`` spawn on a
``file://`` store under the test's temporary directory (no ports, so
parallel test workers never clash) and run ``_torch_mesh_worker``, which
imports only ``repro_torch``.  One 4-rank group runs the (2, 2) mesh
jobs, the launcher and the 4-rank compression; one 2-rank group runs the
elastic restart and the 2-rank compression.  Every join has a deadline,
so a hung rank fails the tests instead of hanging them.

The reference's own multi-device tests do not run on this tree, so the
sharded runs are held against single-device runs: the port's meshless
run on the same weights and batches, and the reference's
``make_train_step`` on the weights it drew (carried over with
``repro_torch.convert``).  Tolerances, with their reasons:

- losses, 5 steps on (2, 2) against either single-device run: rtol 1e-4
  (the sharded sums add in another order; the port's meshless parity
  with the reference is rtol 1e-4 too).
- one step's gradients: within 1e-5 x max|g| (summation order), against
  the meshless port and, for the SSM, hybrid and encoder-decoder smoke
  models on the reference's weights, against ``jax.grad`` of the
  reference's loss.
- the elastic restart against the uninterrupted run: rtol 1e-5.  A mesh
  checkpoint restored without a mesh, and a meshless one restored onto
  the mesh: bitwise.
- compression: each rank's residual bitwise the reference's
  ``quantize_int8`` / ``dequantize_int8`` of its gradient; the
  all-reduced mean within 1e-6 of numpy's mean of the ranks' values
  (the ring adds in its own order).
"""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_mesh_worker as W  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import TrainConfig, init_state, train  # noqa: E402

DEADLINE_S = {4: 180.0, 2: 80.0}


def _spawn(world, d, jobs):
    """Run ``jobs`` on ``world`` gloo ranks; {name: [result of each rank]}.
    Kills every rank when the deadline passes."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(W.run, args=(world, os.path.join(d, f"store{world}"), d,
                                jobs), nprocs=world, join=False)
    deadline = time.monotonic() + DEADLINE_S[world]
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world}-rank group still running after "
                                   f"{DEADLINE_S[world]} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {}
    for name, _, _ in jobs:
        out[name] = [torch.load(os.path.join(d, f"{name}_{r}.pt"),
                                weights_only=False) for r in range(world)]
    return out


def _granite_weights(path):
    """The reference's granite weights (seed 0), carried into the port and
    saved as a state dict."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import registry as jregistry
    from repro.train import loop as jloop
    from repro_torch.convert import model_from_numpy

    jcfg = jsmoke("granite-3-2b").replace(**W.GRANITE)
    jm = jregistry.get_model(jcfg)
    state = jloop.init_state(jm, jax.random.PRNGKey(0))
    values = jax.tree.map(np.asarray, state.params)
    model = model_from_numpy(W.granite_cfg(), values, "cpu")
    torch.save(model.state_dict(), path)
    return jm, state


# the families held against the reference's single-device step too: job
# name -> arch
FAMILIES = {"falcon": "falcon-mamba-7b", "zamba2": "zamba2-1.2b",
            "seamless": "seamless-m4t-medium"}
CKPT_ARCH = "falcon-mamba-7b"
DECODE_ARCHS = ("granite-3-2b", "zamba2-1.2b")


def _reference_weights(arch, path):
    """The reference's float32 smoke weights of ``arch`` (seed 0), carried
    into the port and saved as a state dict; (JAX model, value tree)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import module as jmodule
    from repro.models import registry as jregistry
    from repro_torch.convert import model_from_numpy

    jm = jregistry.get_model(jsmoke(arch).replace(dtype="float32"))
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(0)))
    values = jax.tree.map(np.asarray, values)
    torch.save(model_from_numpy(W.smoke_cfg(arch), values, "cpu")
               .state_dict(), path)
    return jm, values


def _meshless_checkpoint(d):
    """2 meshless steps of ``CKPT_ARCH`` checkpointed under ``d``; the
    state at that step."""
    cfg = W.smoke_cfg(CKPT_ARCH)
    state = train(W._model(cfg), TrainConfig(**W.TRAIN),
                  TokenStream(cfg, W.BATCH, W.SEQ, seed=0), 2,
                  checkpoint_dir=d, **W._quiet())
    return {k: v.detach().clone() for k, v in state.params.items()}, \
        {k: v.clone() for k, v in state.opt.mu.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    weights = os.path.join(d, "granite.pt")
    jm, jstate = _granite_weights(weights)
    ck, lk, sk, mk = (os.path.join(d, n) for n in ("ck", "lk", "sk", "mk"))
    for path in (ck, lk, sk, mk):
        os.makedirs(path)
    family = {job: (os.path.join(d, f"{job}.pt"),) for job in FAMILIES}
    for job, arch in FAMILIES.items():
        family[job] += _reference_weights(arch, family[job][0])
    meshless = _meshless_checkpoint(mk)
    res = _spawn(4, d, [
        ("placements", "placements", {}),
        ("granite", "granite", dict(weights=weights, ckpt_dir=ck)),
        ("moe", "grads", dict(arch="qwen2-moe-a2.7b")),
        ("moe_layer", "moe_layer", {}),
        ("llava", "grads", dict(arch="llava-next-mistral-7b")),
        *((job, "grads", dict(arch=arch, weights=family[job][0]))
          for job, arch in FAMILIES.items()),
        ("ssm_ckpt", "ckpt_roundtrip", dict(arch=CKPT_ARCH, meshless_dir=mk,
                                            ckpt_dir=sk)),
        *((f"decode_{arch}", "decode", dict(arch=arch))
          for arch in DECODE_ARCHS),
        ("launcher", "launcher", dict(ckpt_dir=lk)),
        ("compress4", "compress", dict(world=4))])
    res.update(_spawn(2, d, [
        ("elastic", "elastic", dict(weights=None, ckpt_dir=ck)),
        ("compress2", "compress", dict(world=2))]))
    return {"dir": d, "weights": weights, "ckpt": ck, "jax": (jm, jstate),
            "family": family, "meshless": meshless, "ssm_ckpt": sk,
            "res": res}


def _ok(runs, name):
    """The per-rank results of job ``name``, failing on a rank's error."""
    ranks = runs["res"][name]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"{name} rank {r}:\n{res['error']}"
    return ranks


def _meshless_granite(weights, steps):
    model = W._model(W.granite_cfg(), weights)
    hist = []
    train(model, TrainConfig(**W.TRAIN),
          TokenStream(W.granite_cfg(), W.BATCH, W.SEQ, seed=0), steps,
          history=hist, **W._quiet())
    return [h["loss"] for h in hist]


def test_placements_shard_in_mesh_order_and_reassemble(runs):
    """A dim over ("pod", "data") splits pod-major, as the reference's
    PartitionSpec entry does; every spec's ``full_tensor`` is the tensor."""
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for res in _ok(runs, "placements"):
        p, d = res["coords"]
        assert all(v["whole"] for k, v in res.items()
                   if isinstance(k, tuple))
        block = p * 2 + d
        assert torch.equal(res[(("pod", "data"), None)]["local"],
                           x[2 * block:2 * block + 2])
        assert torch.equal(res[(None, "data")]["local"],
                           x[:, 3 * d:3 * d + 3])
        assert torch.equal(res[("data", "pod")]["local"],
                           x[4 * d:4 * d + 4, 3 * p:3 * p + 3])
        assert torch.equal(res[(("pod",), ("data",))]["local"],
                           x[4 * p:4 * p + 4, 3 * d:3 * d + 3])


def test_mesh_param_shards_follow_shardings_for_axes(runs):
    from repro_torch.dist.sharding import Shard
    sizes = (2, 2)
    for res in _ok(runs, "granite"):
        model = W._model(W.granite_cfg())
        full = dict(model.named_parameters())
        for name, (local, placements, want) in res["shapes"].items():
            assert placements == want, name
            shape = list(full[name].shape)
            for mesh_dim, p in enumerate(placements):
                if isinstance(p, Shard):
                    shape[p.dim] //= sizes[mesh_dim]
            assert local == tuple(shape), (name, res["coords"])
        # FSDP and TP both shard something: the layout is not replicated
        assert any(isinstance(p, Shard) for _, pl, _ in
                   res["shapes"].values() for p in pl)


def test_mesh_granite_matches_meshless_and_reference(runs):
    jax = pytest.importorskip("jax")
    from repro.train import data as jdata
    from repro.train import loop as jloop

    losses = _ok(runs, "granite")[0]["losses"][:5]
    np.testing.assert_allclose(losses, _meshless_granite(runs["weights"], 5),
                               rtol=1e-4)
    jm, state = runs["jax"]
    jstream = jdata.TokenStream(jm.cfg, W.BATCH, W.SEQ, seed=0)
    step = jax.jit(jloop.make_train_step(jm, jloop.TrainConfig(**W.TRAIN)))
    ref = []
    for s in range(5):
        state, m = step(state, jstream.batch_at(s))
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


def test_mesh_granite_25_steps_lower_the_loss(runs):
    ranks = _ok(runs, "granite")
    losses = ranks[0]["losses"]
    assert len(losses) == W.STEPS and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0] - 0.05, losses
    for other in ranks[1:]:
        assert other["losses"] == losses          # every rank sees one loss


def _family_weights(runs, job):
    return runs["family"][job][0] if job in FAMILIES else None


@pytest.mark.parametrize("job,arch", [("moe", "qwen2-moe-a2.7b"),
                                      ("llava", "llava-next-mistral-7b"),
                                      *FAMILIES.items()])
def test_mesh_loss_and_grads_match_meshless(runs, job, arch):
    res = _ok(runs, job)[0]
    cfg = W.smoke_cfg(arch)
    weights = _family_weights(runs, job)
    model = W._model(cfg, weights)
    stream = TokenStream(cfg, W.BATCH, W.SEQ, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(res["loss"], float(loss.detach()), rtol=1e-4)
    for (name, g) in zip(params, grads):
        got = res["grads"][name]
        scale = float(g.abs().max()) or 1.0
        assert float((got - g).abs().max()) <= 1e-5 * scale, name
    hist = []
    train(W._model(cfg, weights), TrainConfig(**W.TRAIN), stream, 3,
          history=hist, **W._quiet())
    np.testing.assert_allclose(res["losses"], [h["loss"] for h in hist],
                               rtol=1e-4)


def _reference_leaf(tree, name, shape):
    """The numpy leaf of the reference's value tree that the port's
    parameter ``name`` holds: a per-layer module's index takes that layer
    of the stacked leaf, and a block stacked ``(1, ...)`` (the hybrid's
    shared block) gives its one entry."""
    node, index = tree, None
    for part in name.split("."):
        if part.isdigit():
            index = int(part)
        else:
            node = node[part] if isinstance(node, dict) else \
                getattr(node, part)
    leaf = np.asarray(node)
    if index is not None:
        leaf = leaf[index]
    elif leaf.shape != tuple(shape) and leaf.shape[1:] == tuple(shape):
        leaf = leaf[0]
    assert leaf.shape == tuple(shape), name
    return leaf


@pytest.mark.parametrize("job", list(FAMILIES))
def test_mesh_families_match_reference_step(runs, job):
    """The (2, 2) mesh's loss and gradients of the SSM, hybrid and
    encoder-decoder smoke models against ``jax.grad`` of the reference's
    loss on the same weights and batch; the per-channel parameters of the
    Mamba blocks are split over 'model' (the per-rank regions ran on
    halves)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    res = _ok(runs, job)[0]
    _, jm, values = runs["family"][job]
    batch = TokenStream(W.smoke_cfg(FAMILIES[job]), W.BATCH, W.SEQ,
                        seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda v: jm.loss(v, jb)[0])(
        jax.tree.map(jnp.asarray, values))
    np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-4)
    want = {k: _reference_leaf(jgrads, k, g.shape)
            for k, g in res["grads"].items()}
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in res["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)
    if job != "seamless":
        from repro_torch.dist.sharding import Shard
        split = [k for k, pl in res["placements"].items()
                 if k.endswith(".D") and pl[1] == Shard(0)]
        assert split, res["placements"]


def test_mesh_ssm_checkpoint_moves_both_ways_bitwise(runs):
    """A meshless ``CKPT_ARCH`` checkpoint restored onto the (2, 2) mesh,
    and the mesh's checkpoint restored without one: bitwise."""
    res = _ok(runs, "ssm_ckpt")[0]
    params, mu = runs["meshless"]
    for k, v in params.items():
        assert torch.equal(res["restored"][k], v), k
        assert torch.equal(res["restored_mu"][k], mu[k]), k
    assert res["step"] == 2
    state = ckpt.restore(ckpt.find_latest(runs["ssm_ckpt"]),
                         init_state(W._model(W.smoke_cfg(CKPT_ARCH), seed=3)))
    assert state.step == 2
    for k, v in state.params.items():
        assert torch.equal(v.detach(), res["written"][k]), k


@pytest.mark.parametrize("group_tokens", [False, True])
def test_mesh_moe_layer_matches_meshless(runs, group_tokens):
    """One MoE layer on (2, 2): the routing groups split as the batch is,
    or one group of every token; y and aux within rtol 1e-5, the
    gradients of x and of every weight within 1e-5 x max|g|."""
    res = _ok(runs, "moe_layer")[0]
    assert res["placements"]["w_gate"] != res["placements"]["w_router"]
    cfg = W.smoke_cfg("qwen2-moe-a2.7b")
    p = W._model(cfg).layers[0].moe
    x, r = W.moe_layer_inputs(cfg.d_model)
    want = W.moe_layer_grads(p, x.requires_grad_(True), r, cfg, group_tokens)
    got = res[group_tokens]
    np.testing.assert_allclose(got["y"].numpy(), want["y"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               rtol=1e-5)
    for name, g in want["grads"].items():
        scale = float(g.abs().max()) or 1.0
        assert float((got["grads"][name] - g).abs().max()) <= 1e-5 * scale, \
            name


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_grads_match_reference_quantization(runs, world):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.dist.compression import dequantize_int8, quantize_int8

    ranks = _ok(runs, f"compress{world}")
    for i, step in enumerate(ranks[0]["steps"]):
        deqs, losses = {}, []
        for r, res in enumerate(ranks):
            st = res["steps"][i]
            losses.append(st["local_loss"].numpy())
            for k, g in st["local_grads"].items():
                c = g.numpy() + st["prev_errors"][k][r].numpy()
                q, s = quantize_int8(jnp.asarray(c))
                deq = np.asarray(dequantize_int8(q, s))
                np.testing.assert_array_equal(st["errors"][k][r].numpy(),
                                              c - deq)
                deqs.setdefault(k, []).append(deq)
        for res in ranks:
            st = res["steps"][i]
            np.testing.assert_allclose(float(st["loss"]), np.mean(losses),
                                       rtol=1e-6)
            for k, parts in deqs.items():
                np.testing.assert_allclose(st["grads"][k].numpy(),
                                           np.mean(parts, axis=0),
                                           rtol=1e-6, atol=1e-7)
    assert "leading dim" in ranks[0]["bad"] and \
        f"n_shards={world}" in ranks[0]["bad"]


def test_elastic_restart_continues_as_the_uninterrupted_run(runs):
    elastic = _ok(runs, "elastic")
    full = _ok(runs, "granite")[0]
    for res in elastic:
        assert res["plan"] == ((1, 2), ("data", "model"), 2)
        assert res["start"] == W.ELASTIC_CKPT_STEP
        assert res["placed"]
        np.testing.assert_allclose(
            res["losses"], full["losses"][W.ELASTIC_CKPT_STEP:W.ELASTIC_STEPS],
            rtol=1e-5)
    # the mesh checkpoint restored without a mesh: the gathered tensors
    path = os.path.join(runs["ckpt"], f"step_{W.ELASTIC_CKPT_STEP:08d}")
    state = ckpt.restore(path, init_state(W._model(W.granite_cfg(), seed=3)))
    assert state.step == W.ELASTIC_CKPT_STEP
    for k, v in state.params.items():
        assert torch.equal(v.detach(), full["at_ckpt"][k]), k


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_matches_meshless(runs, arch):
    """Two decode steps on (2, 2) from a prefilled cache placed by
    ``cache_shardings`` (its ring split over 'model'): each rank writes
    the new slot into its own shard.  Logits, and the cache after the
    steps, within 1e-5 (absolute and relative) of the meshless steps:
    the sharded products sum in another order."""
    from torch.utils._pytree import tree_flatten

    res = _ok(runs, f"decode_{arch}")[0]
    cfg = W.smoke_cfg(arch)
    model = W._model(cfg)
    cache, nxt = W.decode_inputs(cfg, model)
    with torch.no_grad():
        for i, pos in enumerate((W.SEQ // 2, W.SEQ // 2 + 1)):
            lg, cache = model.decode_step(cache, nxt, pos)
            np.testing.assert_allclose(res["logits"][i].numpy(), lg.numpy(),
                                       rtol=1e-5, atol=1e-5)
    got, want = tree_flatten(res["cache"])[0], tree_flatten(cache)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_launcher_main_trains_on_a_4_rank_mesh(runs):
    from repro_torch.launch import train as launch_train

    ranks = _ok(runs, "launcher")
    for arch in W.LAUNCHED:
        _, state, hist = launch_train.main(
            ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4",
             "--seq", "16", "--device", "cpu"], log_fn=lambda *_: None)
        for res in ranks:
            got = res[arch]
            assert got["step"] == 3 and got["mesh"] == (1, 4)
            assert got["ckpt"] == ["step_00000003"]
            np.testing.assert_allclose(got["losses"],
                                       [h["loss"] for h in hist], rtol=1e-4)

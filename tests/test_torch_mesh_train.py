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
- attention at the reference's layout, where the old one gathered
  (``layers.attend``): granite and h2o-danube (window, dense and
  query-chunked) on (1, 4), whose 4 ranks do not divide the 2 kv heads,
  and phi3 on (2, 2), whose head dim is split: loss within rtol 1e-6
  and every gradient (``wk`` and ``wv`` included) within 1e-5 x max|g|
  of the meshless port; against ``jax.grad`` of the reference's loss,
  rtol 1e-4 and 1e-5 x max|g|.  Greedy decode of granite and zamba2 on
  (2, 2), the rows over 'data' and the cache's ring over 'model'
  (split-K): logits within 1e-5 of the meshless port's and of the
  reference's, the tokens equal, for 8 steps.  Each call's layout and
  each rank's local shapes at the products are the reference layout's.
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
# attention jobs: name -> (arch, mesh shape, sequence, config overrides);
# 4 'model' ranks do not divide 2 kv heads, phi3's 5 heads take the
# head_dim rule on 2
SPLITS = {"split_granite": ("granite-3-2b", (1, 4), W.SEQ, {}),
          "split_danube": ("h2o-danube-3-4b", (1, 4), 2 * W.SEQ, {}),
          "split_danube_chunked": ("h2o-danube-3-4b", (1, 4), 2 * W.SEQ,
                                   {"attn_q_chunk": 8}),
          "split_phi3": ("phi3-medium-14b", (2, 2), W.SEQ, {})}


def _reference_weights(arch, path, **overrides):
    """The reference's float32 smoke weights of ``arch`` (seed 0, config
    ``overrides``), carried into the port and saved as a state dict;
    (JAX model, value tree)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import module as jmodule
    from repro.models import registry as jregistry
    from repro_torch.convert import model_from_numpy

    jm = jregistry.get_model(jsmoke(arch).replace(dtype="float32",
                                                  **overrides))
    values, _ = jmodule.split(jm.init(jax.random.PRNGKey(0)))
    values = jax.tree.map(np.asarray, values)
    torch.save(model_from_numpy(W.smoke_cfg(arch, **overrides), values,
                                "cpu").state_dict(), path)
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
    for job, (arch, _, _, over) in SPLITS.items():
        family[job] = (os.path.join(d, f"{job}.pt"),)
        family[job] += _reference_weights(arch, family[job][0], **over)
    family["greedy_granite-3-2b"] = (os.path.join(d, "granite_smoke.pt"),)
    family["greedy_granite-3-2b"] += _reference_weights(
        "granite-3-2b", family["greedy_granite-3-2b"][0])
    family["greedy_zamba2-1.2b"] = family["zamba2"]
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
        *((job, "grads", dict(arch=arch, weights=family[job][0],
                              mesh_shape=ms, seq=seq, overrides=over))
          for job, (arch, ms, seq, over) in SPLITS.items()),
        *((f"greedy_{arch}", "greedy",
           dict(arch=arch, weights=family[f"greedy_{arch}"][0]))
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


def _meshless_step(cfg, weights, seq):
    """The meshless port's loss and {name: gradient} on batch 0."""
    model = W._model(cfg, weights)
    stream = TokenStream(cfg, W.BATCH, seq, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _grads_within(got, want, rel=1e-5):
    """Every gradient of ``want`` matched within ``rel`` x its max|g|."""
    for name, g in want.items():
        scale = float(g.abs().max()) or 1.0
        assert float((got[name] - g).abs().max()) <= rel * scale, name


@pytest.mark.parametrize("job,arch", [("moe", "qwen2-moe-a2.7b"),
                                      ("llava", "llava-next-mistral-7b"),
                                      *FAMILIES.items()])
def test_mesh_loss_and_grads_match_meshless(runs, job, arch):
    res = _ok(runs, job)[0]
    cfg = W.smoke_cfg(arch)
    weights = _family_weights(runs, job)
    stream = TokenStream(cfg, W.BATCH, W.SEQ, seed=0)
    loss, grads = _meshless_step(cfg, weights, W.SEQ)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-4)
    _grads_within(res["grads"], grads)
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


def _reference_step(jm, values, cfg, seq):
    """The reference's loss and gradients (``jax.grad``) on batch 0."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    batch = TokenStream(cfg, W.BATCH, seq, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.value_and_grad(lambda v: jm.loss(v, jb)[0])(
        jax.tree.map(jnp.asarray, values))


@pytest.mark.parametrize("job", list(SPLITS))
def test_mesh_attention_split_matches_meshless_and_reference(runs, job):
    """Attention split where the old layout gathered: q's heads over ranks
    that do not divide the kv heads (granite, danube with its window,
    dense and query-chunked; ``wk`` and ``wv`` gradients partial sums on
    the ranks), or the head dim (phi3).  Meshless: loss rtol 1e-6, every
    gradient 1e-5 x max|g|; the reference's ``jax.grad``: rtol 1e-4,
    1e-5 x the largest |g|."""
    arch, _, seq, over = SPLITS[job]
    res = _ok(runs, job)[0]
    cfg = W.smoke_cfg(arch, **over)
    loss, grads = _meshless_step(cfg, runs["family"][job][0], seq)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)
    assert {"wk", "wv"} <= {k.rsplit(".", 1)[-1] for k in res["grads"]}
    _grads_within(res["grads"], grads)
    _, jm, values = runs["family"][job]
    jloss, jgrads = _reference_step(jm, values, cfg, seq)
    np.testing.assert_allclose(res["loss"], float(jloss), rtol=1e-4)
    want = {k: _reference_leaf(jgrads, k, g.shape)
            for k, g in res["grads"].items()}
    gmax = max(float(np.abs(g).max()) for g in want.values())
    for name, g in res["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=0,
                                   atol=1e-5 * gmax, err_msg=name)


@pytest.mark.parametrize("job", list(SPLITS) + [f"greedy_{a}" for a in
                                                 DECODE_ARCHS])
def test_mesh_attention_local_shapes_follow_reference_layout(runs, job):
    """Each rank's q and k at attention's products: granite and danube on
    (1, 4) hold H/4 = 1 q head and its one kv head, phi3 on (2, 2) its
    hd/2 slice of every head; decode on (2, 2) holds B/2 rows of q and
    C/2 ring slots of k."""
    B, C = W.BATCH, W.SEQ
    for res in _ok(runs, job):
        seen = res["attend"]
        assert seen["modes"] and seen["shapes"]
        if job.startswith("greedy"):
            arch = job.split("_", 1)[1]
            cfg = W.smoke_cfg(arch)
            assert set(seen["modes"]) == {("batch", "kv_seq")}
            for (q, k) in seen["shapes"]:
                assert q == (B // 2, 1, cfg.n_heads, cfg.hd)
                assert k == (B // 2, C // 2, cfg.n_kv_heads, cfg.hd)
            continue
        arch, (_, m), seq, over = SPLITS[job]
        cfg = W.smoke_cfg(arch, **over)
        for (q, k) in seen["shapes"]:
            if job == "split_phi3":
                assert q[2:] == (cfg.n_heads, cfg.hd // m), q
                assert k[2:] == (cfg.n_kv_heads, cfg.hd // m), k
            else:
                assert q[0] == B and q[2:] == (cfg.n_heads // m, cfg.hd), q
                assert k[2:] == (1, cfg.hd), k
        want = ("whole", "head_dim" if job == "split_phi3" else "heads")
        assert set(seen["modes"]) == {want}
    if job == "split_danube_chunked":
        assert {q[1] for q, _ in seen["shapes"]} == {8}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_greedy_decode_matches_meshless_and_reference(runs, arch):
    """8 greedy decode steps on (2, 2), split-K over the ring's halves:
    each step's logits within 1e-5 (absolute and relative) of the
    meshless port's and of the reference's, the tokens equal."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    res = _ok(runs, f"greedy_{arch}")[0]
    path, jm, values = runs["family"][f"greedy_{arch}"]
    cfg = W.smoke_cfg(arch)
    model = W._model(cfg, path)
    cache, prompt, cur = W.greedy_inputs(cfg, model)
    jl, jc = jm.prefill(values, {"tokens": jnp.asarray(prompt.numpy())},
                        W.SEQ)
    jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
    assert len(res["logits"]) == W.SEQ // 2
    with torch.no_grad():
        for s, (lg_mesh, tok_mesh) in enumerate(zip(res["logits"],
                                                    res["tokens"])):
            pos = W.SEQ // 2 + s
            lg, cache = model.decode_step(cache, cur, pos)
            jl, jc = jm.decode_step(values, jc, jcur, jnp.int32(pos))
            np.testing.assert_allclose(lg_mesh.numpy(), lg.numpy(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(lg_mesh.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            cur = torch.argmax(lg[:, -1], -1)[:, None]
            jcur = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
            assert torch.equal(tok_mesh, cur), s
            np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))


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

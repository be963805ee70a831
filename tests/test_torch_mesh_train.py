"""Port parity: training on a device mesh (``repro_torch.dist``,
``repro_torch.launch.{mesh,shardings,train}``, the mesh-aware train step
and checkpoint), on gloo CPU ranks, for every family: dense (granite),
MoE, VLM, SSM (falcon-mamba), hybrid (zamba2) and encoder-decoder
(seamless).  Attention's mesh layouts, decode and the vocabulary-split
loss are in ``tests/test_torch_mesh_attention.py``.

The module fixture runs one 4-rank group (the (2, 2) mesh jobs, the
launcher and the 4-rank compression) and one 2-rank group (the elastic
restart and the 2-rank compression) through ``_torch_mesh_group.spawn``:
each group has a deadline of ``MARGIN`` times its wall on an idle 8-CPU
host, and its ranks a collective timeout of ``MARGIN`` times the longest
job's (at least 60 s).

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

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_mesh_worker as W  # noqa: E402
from _torch_mesh_group import (collective_timeout,  # noqa: E402
                               grads_within, meshless_step, ok,
                               reference_step, reference_weights,
                               spawn, within_reference)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import TokenStream  # noqa: E402
from repro_torch.train.loop import TrainConfig, init_state, train  # noqa: E402

# each group's wall on an idle 8-CPU host (spawn to the last rank's
# exit; the larger of two runs).  Under the suite's `pytest -n 6 --dist
# loadfile` the groups took 1.3-2.1x as long (116.3 s and 13.9 s); one
# group of this module's and the attention module's jobs (59.4 s of jobs
# idle) overran a deadline of 180 s, 3.0x, on a busier host.  The margin
# is twice that.  A collective waits at most for the other ranks to end
# the job before: the longest job's idle wall (granite's 25 steps, the
# elastic restart) sets its timeout.
IDLE_S = {4: 54.5, 2: 11.0}
JOB_IDLE_S = {4: 14.4, 2: 6.9}
MARGIN = 6
DEADLINE_S = {world: MARGIN * wall for world, wall in IDLE_S.items()}
COLLECTIVE_S = {world: collective_timeout(MARGIN, wall)
                for world, wall in JOB_IDLE_S.items()}


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
        family[job] += reference_weights(arch, family[job][0])
    meshless = _meshless_checkpoint(mk)
    res = spawn(4, d, [
        ("placements", "placements", {}),
        ("granite", "granite", dict(weights=weights, ckpt_dir=ck)),
        ("moe", "grads", dict(arch="qwen2-moe-a2.7b")),
        ("moe_layer", "moe_layer", {}),
        ("llava", "grads", dict(arch="llava-next-mistral-7b")),
        *((job, "grads", dict(arch=arch, weights=family[job][0]))
          for job, arch in FAMILIES.items()),
        ("ssm_ckpt", "ckpt_roundtrip", dict(arch=CKPT_ARCH, meshless_dir=mk,
                                            ckpt_dir=sk)),
        ("launcher", "launcher", dict(ckpt_dir=lk)),
        ("compress4", "compress", dict(world=4))], DEADLINE_S[4],
        COLLECTIVE_S[4])
    res.update(spawn(2, d, [
        ("elastic", "elastic", dict(weights=None, ckpt_dir=ck)),
        ("compress2", "compress", dict(world=2))], DEADLINE_S[2],
        COLLECTIVE_S[2]))
    return {"dir": d, "weights": weights, "ckpt": ck, "jax": (jm, jstate),
            "family": family, "meshless": meshless, "ssm_ckpt": sk,
            "res": res}


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
    for res in ok(runs, "placements"):
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
    for res in ok(runs, "granite"):
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

    losses = ok(runs, "granite")[0]["losses"][:5]
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
    ranks = ok(runs, "granite")
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
    res = ok(runs, job)[0]
    cfg = W.smoke_cfg(arch)
    weights = _family_weights(runs, job)
    stream = TokenStream(cfg, W.BATCH, W.SEQ, seed=0)
    loss, grads = meshless_step(cfg, weights, W.SEQ)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-4)
    grads_within(res["grads"], grads)
    hist = []
    train(W._model(cfg, weights), TrainConfig(**W.TRAIN), stream, 3,
          history=hist, **W._quiet())
    np.testing.assert_allclose(res["losses"], [h["loss"] for h in hist],
                               rtol=1e-4)


@pytest.mark.parametrize("job", list(FAMILIES))
def test_mesh_families_match_reference_step(runs, job):
    """The (2, 2) mesh's loss and gradients of the SSM, hybrid and
    encoder-decoder smoke models against ``jax.grad`` of the reference's
    loss on the same weights and batch; the per-channel parameters of the
    Mamba blocks are split over 'model' (the per-rank regions ran on
    halves)."""
    res = ok(runs, job)[0]
    _, jm, values = runs["family"][job]
    within_reference(res["loss"], res["grads"], *reference_step(
        jm, values, W.smoke_cfg(FAMILIES[job]), W.SEQ))
    if job != "seamless":
        from repro_torch.dist.sharding import Shard
        split = [k for k, pl in res["placements"].items()
                 if k.endswith(".D") and pl[1] == Shard(0)]
        assert split, res["placements"]


def test_mesh_ssm_checkpoint_moves_both_ways_bitwise(runs):
    """A meshless ``CKPT_ARCH`` checkpoint restored onto the (2, 2) mesh,
    and the mesh's checkpoint restored without one: bitwise."""
    res = ok(runs, "ssm_ckpt")[0]
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
    res = ok(runs, "moe_layer")[0]
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

    ranks = ok(runs, f"compress{world}")
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
    elastic = ok(runs, "elastic")
    full = ok(runs, "granite")[0]
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


def test_launcher_main_trains_on_a_4_rank_mesh(runs):
    from repro_torch.launch import train as launch_train

    ranks = ok(runs, "launcher")
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

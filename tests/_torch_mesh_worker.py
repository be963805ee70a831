"""Rank processes of the port's mesh tests (``tests/test_torch_mesh_*.py``,
started by ``tests/_torch_mesh_group.py``): a gloo group of CPU ranks
started with ``torch.multiprocessing`` spawn, each running the port's
mesh training, decode or loss on its shard and writing what the test
compares to ``<out>/<job>_<rank>.pt``.

This module imports only ``torch``, numpy and ``repro_torch``: the rank
processes never load JAX.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

GRANITE = dict(dtype="float32", d_model=64, d_ff=128)
BATCH, SEQ = 4, 16
TRAIN = dict(lr=3e-3, warmup_steps=2, total_steps=40)
STEPS = 25
LAUNCHED = ("granite-3-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b")
ELASTIC_CKPT_STEP, ELASTIC_STEPS = 2, 5


def granite_cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("granite-3-2b").replace(**GRANITE)


def smoke_cfg(arch, **overrides):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(dtype="float32", **overrides)


def _model(cfg, weights=None, seed=0):
    from repro_torch.models.registry import get_model
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    if weights is not None:
        model.load_state_dict(torch.load(weights))
    return model


def _quiet():
    return dict(log_every=0, log_fn=lambda *_: None)


def job_granite(rank, out, weights, ckpt_dir):
    """The (2, 2) mesh: local shard shapes, then STEPS steps with a
    checkpoint after ELASTIC_CKPT_STEP and the whole state at that step."""
    from repro_torch.dist.sharding import make_mesh, use_mesh
    from repro_torch.launch.train import shard_model
    from repro_torch.launch.shardings import param_shardings
    from repro_torch.models.registry import sharding_rules
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import TrainConfig, train

    cfg = granite_cfg()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding_rules(cfg, 2)
    model = shard_model(_model(cfg, weights), mesh, rules)
    _, sh = param_shardings(model, mesh, rules)
    shapes = {k: (tuple(p.to_local().shape), tuple(p.placements),
                  tuple(sh[k].placements)) for k, p in
              model.named_parameters()}
    tc = TrainConfig(**TRAIN)
    stream = TokenStream(cfg, BATCH, SEQ, seed=0)
    hist = []
    with use_mesh(mesh, rules):
        state = train(model, tc, stream, ELASTIC_CKPT_STEP,
                      checkpoint_dir=ckpt_dir, history=hist, **_quiet())
        at_ckpt = {k: v.full_tensor().clone() for k, v in
                   state.params.items()}
        state = train(model, tc, stream, STEPS, state=state, history=hist,
                      **_quiet())
    return {"shapes": shapes, "coords": mesh.get_coordinate(),
            "losses": [h["loss"] for h in hist],
            "at_ckpt": at_ckpt if rank == 0 else None}


def job_elastic(rank, out, weights, ckpt_dir):
    """Restart on the 2-rank mesh an ElasticController plans after losing
    a host of the (2, 2) run: place the model on the new mesh, restore
    the step-2 checkpoint into it (every leaf in the placements that
    ``train_state_shardings`` gives) and continue to ELASTIC_STEPS."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh_from_plan
    from repro_torch.launch.shardings import train_state_shardings
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import TokenStream
    from repro_torch.train.fault import ElasticController
    from repro_torch.train.loop import TrainConfig, init_state, train

    ec = ElasticController(n_hosts=4, chips_per_host=1, model_axis=2)
    assert ec.step({h: 1.0 for h in range(4)}) is None
    plan = ec.step({h: 1.0 for h in range(3)})          # host 3 is lost
    mesh = make_mesh_from_plan(plan, "cpu")
    cfg = granite_cfg()
    rules = sharding_rules(cfg, mesh.size(1))
    model = shard_model(_model(cfg, seed=7), mesh, rules)   # other weights
    _, state_sh = train_state_shardings(model, mesh, rules)
    path = os.path.join(ckpt_dir, f"step_{ELASTIC_CKPT_STEP:08d}")
    state = ckpt.restore(path, init_state(model))
    want = {"params": state_sh.params, "mu": state_sh.opt.mu,
            "nu": state_sh.opt.nu}
    got = {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}
    placed = all(tuple(v.placements) == tuple(want[f][k].placements)
                 for f in got for k, v in got[f].items())
    hist = []
    with use_mesh(mesh, rules):
        train(model, TrainConfig(**TRAIN), TokenStream(cfg, BATCH, SEQ, 0),
              ELASTIC_STEPS, state=state, history=hist, **_quiet())
    return {"plan": (plan.shape, plan.axis_names, plan.n_chips),
            "start": state.step, "placed": placed,
            "losses": [h["loss"] for h in hist]}


@contextlib.contextmanager
def attend_probe():
    """Record every attention call's layout (``layers._attend_layout``:
    the split of each mesh dim) and the local shapes of q and k at its
    products (``layers._logits``, after a rank's kv heads are picked)."""
    from repro_torch.models import layers as L

    seen = {"modes": [], "shapes": []}
    layout, logits = L._attend_layout, L._logits

    def rec_layout(*args):
        lay = layout(*args)
        seen["modes"].append(lay.modes)
        return lay

    def rec_logits(q, k, hd):
        seen["shapes"].append((tuple(q.shape), tuple(k.shape)))
        return logits(q, k, hd)

    L._attend_layout, L._logits = rec_layout, rec_logits
    try:
        yield seen
    finally:
        L._attend_layout, L._logits = layout, logits


def job_grads(rank, out, arch, weights=None, mesh_shape=(2, 2), seq=SEQ,
              overrides=None):
    """One step's loss and gathered gradients of ``arch``'s smoke config
    (with ``overrides``) on a ("data", "model") mesh of ``mesh_shape``
    (its seed-0 weights, or the state dict at ``weights``), with the
    attention calls' layouts and local shapes; then a 3-step loss
    trajectory."""
    from repro_torch.dist.sharding import (gathered, make_mesh, shard_batch,
                                          use_mesh)
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import TrainConfig, train

    cfg = smoke_cfg(arch, **(overrides or {}))
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = sharding_rules(cfg, mesh_shape[1])
    model = shard_model(_model(cfg, weights), mesh, rules)
    stream = TokenStream(cfg, BATCH, seq, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in stream.batch_at(0).items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with use_mesh(mesh, rules):
        with attend_probe() as seen:
            loss = gathered(model.loss(shard_batch(batch, mesh))[0])
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: gathered(g).detach() for k, g in zip(params, grads)}
        hist = []
        train(model, TrainConfig(**TRAIN), stream, 3, history=hist,
              **_quiet())
    return {"loss": float(loss.detach()), "grads": grads if rank == 0 else None,
            "losses": [h["loss"] for h in hist], "attend": seen,
            "placements": {k: tuple(p.placements) for k, p in params.items()}}


def job_ckpt_roundtrip(rank, out, arch, meshless_dir, ckpt_dir):
    """A checkpoint of ``arch`` both ways: the meshless run's step-2
    checkpoint (``meshless_dir``) restored into a model sharded on the
    (2, 2) mesh (other weights), gathered; then 2 steps on the mesh
    written to ``ckpt_dir``, with the gathered state at that step."""
    from repro_torch.dist.sharding import make_mesh, use_mesh
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import TokenStream
    from repro_torch.train.loop import TrainConfig, init_state, train

    cfg = smoke_cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding_rules(cfg, 2)
    model = shard_model(_model(cfg, seed=5), mesh, rules)
    state = ckpt.restore(ckpt.find_latest(meshless_dir), init_state(model))
    restored = {k: v.full_tensor().clone() for k, v in state.params.items()}
    restored_mu = {k: v.full_tensor().clone() for k, v in
                   state.opt.mu.items()}
    model = shard_model(_model(cfg), mesh, rules)
    with use_mesh(mesh, rules):
        state = train(model, TrainConfig(**TRAIN),
                      TokenStream(cfg, BATCH, SEQ, seed=0), 2,
                      checkpoint_dir=ckpt_dir, **_quiet())
    written = {k: v.full_tensor().clone() for k, v in state.params.items()}
    return {"step": state.step, "restored": restored,
            "restored_mu": restored_mu, "written": written} \
        if rank == 0 else {}


def moe_layer_inputs(d_model):
    """The input and the output weights of ``job_moe_layer``, seeded."""
    rng = np.random.default_rng(5)
    return (torch.as_tensor(rng.standard_normal((BATCH, SEQ, d_model)),
                            dtype=torch.float32),
            torch.as_tensor(rng.standard_normal((BATCH, SEQ, d_model)),
                            dtype=torch.float32))


def moe_layer_grads(p, x, r, cfg, group_tokens, gather=lambda t: t):
    """y, aux, and the gradients of ``sum(y * r) + aux`` with respect to
    ``x`` and every parameter of the MoE layer ``p``."""
    from repro_torch.models import layers as L

    for v in p.parameters():
        v.requires_grad_(True)
    y, aux = L.moe(p, x, n_experts=cfg.n_experts, top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor,
                   group_tokens=group_tokens)
    y, aux = gather(y), gather(aux)
    names = [k for k, _ in p.named_parameters()]
    grads = torch.autograd.grad((y * r).sum() + aux,
                                [x] + [v for _, v in p.named_parameters()])
    return {"y": y.detach(), "aux": aux.detach(),
            "grads": dict(zip(["x"] + names,
                              (gather(g).detach() for g in grads)))}


def job_moe_layer(rank, out):
    """One MoE layer of qwen2-moe's smoke config on the (2, 2) mesh, its
    routing groups the batch rows (split as the batch is) and the grouped
    layout (one group of every token)."""
    from repro_torch.dist.sharding import (gathered, make_mesh, shard_batch,
                                          use_mesh)
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules

    cfg = smoke_cfg("qwen2-moe-a2.7b")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding_rules(cfg, 2)
    p = shard_model(_model(cfg), mesh, rules).layers[0].moe
    x, r = moe_layer_inputs(cfg.d_model)
    res = {}
    with use_mesh(mesh, rules):
        for group_tokens in (False, True):
            xd = shard_batch({"x": x}, mesh)["x"].requires_grad_(True)
            res[group_tokens] = moe_layer_grads(p, xd, r, cfg, group_tokens,
                                                gathered)
    res["placements"] = {k: tuple(v.placements)
                         for k, v in p.named_parameters()}
    return res if rank == 0 else {}


def decode_inputs(cfg, model):
    """A prefilled cache of ``model`` (seeded prompt of SEQ // 2 tokens,
    capacity SEQ) and the next tokens."""
    rng = np.random.default_rng(9)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, SEQ // 2)),
                             dtype=torch.int32)
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, 1)),
                          dtype=torch.int32)
    _, cache = model.prefill({"tokens": prompt}, SEQ)
    return cache, nxt


def job_decode(rank, out, arch):
    """Two decode steps of ``arch``'s smoke model on the (2, 2) mesh from
    a meshless prefill's cache placed by ``cache_shardings``: the logits
    and the gathered cache after them."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._pytree import tree_map

    from repro_torch.dist.sharding import gathered, make_mesh, shard_batch, \
        use_mesh
    from repro_torch.launch.shardings import cache_shardings
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules

    cfg = smoke_cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding_rules(cfg, 2)
    model = _model(cfg)
    cache, nxt = decode_inputs(cfg, model)
    model = shard_model(model, mesh, rules)
    cache = tree_map(lambda t, sh: distribute_tensor(
        t, sh.mesh, sh.placements, src_data_rank=None), cache,
        cache_shardings(cache, mesh))
    logits = []
    with torch.no_grad(), use_mesh(mesh, rules):
        for pos in (SEQ // 2, SEQ // 2 + 1):
            lg, cache = model.decode_step(
                cache, shard_batch({"t": nxt}, mesh)["t"], pos)
            logits.append(gathered(lg).clone())
        cache = tree_map(lambda t: gathered(t).clone(), cache)
    return {"logits": logits, "cache": cache} if rank == 0 else {}


def greedy_inputs(cfg, model):
    """A prefilled cache of ``model`` (seeded prompt of SEQ // 2 tokens,
    capacity SEQ), the prompt and the greedy next tokens."""
    rng = np.random.default_rng(11)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, SEQ // 2)),
                             dtype=torch.int32)
    with torch.no_grad():
        lg, cache = model.prefill({"tokens": prompt}, SEQ)
    return cache, prompt, torch.argmax(lg[:, -1], -1)[:, None]


def job_greedy(rank, out, arch, weights=None, steps=SEQ // 2):
    """``steps`` greedy decode steps of ``arch``'s smoke model (weights at
    ``weights``) on the (2, 2) mesh, from a meshless prefill's cache
    placed by ``cache_shardings`` (the ring split over 'model', the rows
    over 'data'): each step's logits and token, and the attention calls'
    layouts and local shapes."""
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._pytree import tree_map

    from repro_torch.dist.sharding import gathered, make_mesh, shard_batch, \
        use_mesh
    from repro_torch.launch.shardings import cache_shardings
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules

    cfg = smoke_cfg(arch)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding_rules(cfg, 2)
    model = _model(cfg, weights)
    cache, _, cur = greedy_inputs(cfg, model)
    model = shard_model(model, mesh, rules)
    cache = tree_map(lambda t, sh: distribute_tensor(
        t, sh.mesh, sh.placements, src_data_rank=None), cache,
        cache_shardings(cache, mesh))
    logits, tokens = [], []
    with torch.no_grad(), use_mesh(mesh, rules), attend_probe() as seen:
        for s in range(steps):
            lg, cache = model.decode_step(
                cache, shard_batch({"t": cur}, mesh)["t"], SEQ // 2 + s)
            lg = gathered(lg)
            cur = torch.argmax(lg[:, -1], -1)[:, None]
            logits.append(lg.clone())
            tokens.append(cur.clone())
    return {"logits": logits, "tokens": tokens, "attend": seen}


def job_launcher(rank, out, ckpt_dir):
    """The launcher's ``main`` in the 4-rank group: granite, qwen2-moe and
    falcon-mamba train 3 steps."""
    from repro_torch.launch import train as launch_train

    res = {}
    for arch in LAUNCHED:
        d = os.path.join(ckpt_dir, arch)
        model, state, hist = launch_train.main(
            ["--arch", arch, "--smoke", "--steps", "3", "--batch", "4",
             "--seq", "16", "--device", "cpu", "--ckpt-dir", d],
            log_fn=lambda *_: None)
        res[arch] = {"losses": [h["loss"] for h in hist], "step": state.step,
                     "mesh": tuple(next(model.parameters()).device_mesh
                                   .mesh.shape),
                     "ckpt": sorted(os.listdir(d))}
    return res


def job_compress(rank, out, world):
    """Three compressed-gradient steps of a linear least-squares model."""
    from repro_torch.dist.compression import (init_error_buffers,
                                              make_compressed_grad_fn)
    from repro_torch.dist.sharding import flat_mesh

    mesh = flat_mesh(world, "data", "cpu")
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((64, 16)).astype(np.float32))
    y = X @ torch.arange(16, dtype=torch.float32) * 0.1

    def loss_fn(params, batch):
        Xb, yb = batch
        return torch.mean((Xb @ params["w"] + params["b"] - yb) ** 2)

    params = {"w": torch.zeros(16), "b": torch.zeros(())}
    fn = make_compressed_grad_fn(loss_fn, mesh, "data")
    errors = init_error_buffers(params, n_shards=world)
    n = X.shape[0] // world
    local = (X[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n])
    steps = []
    for _ in range(3):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        local_loss = loss_fn(leaves, local)
        local_grads = dict(zip(leaves, torch.autograd.grad(
            local_loss, list(leaves.values()))))
        prev = {k: v.clone() for k, v in errors.items()}
        loss, grads, errors = fn(params, (X, y), errors)
        steps.append({"local_loss": local_loss.detach(),
                      "local_grads": local_grads, "prev_errors": prev,
                      "loss": loss, "grads": grads,
                      "errors": {k: v.clone() for k, v in errors.items()}})
        params = {k: params[k] - 0.05 * grads[k] for k in params}
    try:
        fn(params, (X, y), init_error_buffers(params, n_shards=world + 1))
        bad = "no error"
    except ValueError as e:
        bad = str(e)
    return {"steps": steps, "bad": bad}


def job_placements(rank, out):
    """``to_placements`` on a ("pod", "data") mesh: each rank's shard and
    the ``full_tensor`` reassembly of several specs."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import make_mesh, to_placements

    mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    res = {"coords": tuple(mesh.get_coordinate())}
    for spec in ((("pod", "data"), None), (None, "data"), ("data", "pod"),
                 (("pod",), ("data",))):
        d = distribute_tensor(x, mesh, to_placements(spec, mesh, 2))
        res[spec] = {"local": d.to_local().clone(),
                     "whole": torch.equal(d.full_tensor(), x)}
    return res


def loss_batch(cfg, seq=SEQ):
    """Batch 0 of ``cfg``'s seeded stream with some labels ignored (< 0):
    the head of row 0 and the tail of row 2."""
    from repro_torch.train.data import TokenStream
    batch = {k: np.array(v) for k, v in
             TokenStream(cfg, BATCH, seq, seed=0).batch_at(0).items()}
    batch["labels"][0, :5] = -1
    batch["labels"][2, seq // 2 + 1:] = -1
    return batch


@contextlib.contextmanager
def loss_probe():
    """Record the global and the rank's shapes of the logits each
    vocabulary-split NLL call reduces (``layers._label_logprob_by_shards``)
    and count the calls of the whole-row gather (``layers._take_last``)."""
    from repro_torch.models import layers as L

    seen = {"split": [], "take_last": 0}
    split, take = L._label_logprob_by_shards, L._take_last

    def rec_split(logits, idx, vocab):
        seen["split"].append((tuple(logits.shape),
                              tuple(logits.to_local().shape)))
        return split(logits, idx, vocab)

    def rec_take(x, idx):
        seen["take_last"] += 1
        return take(x, idx)

    L._label_logprob_by_shards, L._take_last = rec_split, rec_take
    try:
        yield seen
    finally:
        L._label_logprob_by_shards, L._take_last = split, take


def job_vocab_loss(rank, out, weights, overrides, mesh_shape=(1, 4)):
    """The loss and gathered gradients of granite's smoke config (with
    ``overrides``, weights at ``weights``) on ``loss_batch`` on a ("data",
    "model") mesh whose 'model' ranks split the vocabulary, with what
    ``loss_probe`` saw."""
    from repro_torch.dist.sharding import (gathered, make_mesh, shard_batch,
                                          use_mesh)
    from repro_torch.launch.train import shard_model
    from repro_torch.models.registry import sharding_rules

    cfg = smoke_cfg("granite-3-2b", **overrides)
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = sharding_rules(cfg, mesh_shape[1])
    model = shard_model(_model(cfg, weights), mesh, rules)
    batch = {k: torch.as_tensor(v) for k, v in loss_batch(cfg).items()}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with use_mesh(mesh, rules), loss_probe() as seen:
        loss = gathered(model.loss(shard_batch(batch, mesh))[0])
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: gathered(g).detach() for k, g in zip(params, grads)}
    return {"loss": float(loss.detach()), "seen": seen,
            "grads": grads if rank == 0 else None}


def embed_inputs(halves=False):
    """A float32 table of granite's smoke widths, tokens drawn with
    repeats from 12 rows spread over the vocabulary (``halves``: the
    first half of the batch from 6 of them, the second from the other 6),
    and the weights of the lookup's output in ``sum(table[tokens] *
    weights)``; seeded."""
    rng = np.random.default_rng(13)
    V, d = 256, GRANITE["d_model"]
    table = torch.as_tensor(rng.standard_normal((V, d)), dtype=torch.float32)
    rows = rng.choice(V, 12, replace=False)
    if halves:
        draw = np.concatenate([rng.choice(rows[:6], (BATCH // 2, SEQ)),
                               rng.choice(rows[6:], (BATCH // 2, SEQ))])
    else:
        draw = rng.choice(rows, (BATCH, SEQ))
    tokens = torch.as_tensor(draw, dtype=torch.int32)
    weights = torch.as_tensor(rng.standard_normal((BATCH, SEQ, d)),
                              dtype=torch.float32)
    return table, tokens, weights


def job_embed_grad(rank, out, mesh_shape, axes=("data", "model"),
                   fsdp=True):
    """``layers.embed`` on a mesh of ``mesh_shape`` over ``axes``, the
    table placed as granite's ("vocab", "embed") under its rules (with
    ``fsdp`` off the table is whole on 'data') and the tokens as a batch,
    for both inputs of ``embed_inputs``: the gathered rows, the table's
    placements and its gradient's, and the rank's shard of the table's
    gradient of ``sum(rows * weights)`` with the (start, length) of its
    rows and of its columns."""
    from repro_torch.dist.sharding import (gathered, make_mesh, on_mesh,
                                          shard_batch, use_mesh)
    from repro_torch.models import layers as L
    from repro_torch.models.registry import sharding_rules

    mesh = make_mesh(mesh_shape, axes, "cpu")
    rules = sharding_rules(granite_cfg().replace(fsdp=fsdp),
                           mesh_shape[axes.index("model")])
    res = {}
    for halves in (False, True):
        table, tokens, weights = embed_inputs(halves)
        with use_mesh(mesh, rules):
            t = on_mesh(table, mesh, "vocab", "embed").requires_grad_(True)
            rows = gathered(L.embed(t, shard_batch({"t": tokens},
                                                   mesh)["t"]))
            (rows * weights).sum().backward()
        res["halves" if halves else "shared"] = {
            "rows": rows.detach(), "grad": t.grad.to_local().clone(),
            "placements": (tuple(t.placements), tuple(t.grad.placements)),
            "range": (L._shard_range(t, 0), L._shard_range(t, 1))}
    return res


JOBS = {"placements": job_placements, "granite": job_granite,
        "elastic": job_elastic, "grads": job_grads,
        "moe_layer": job_moe_layer, "launcher": job_launcher,
        "ckpt_roundtrip": job_ckpt_roundtrip, "decode": job_decode,
        "greedy": job_greedy, "compress": job_compress,
        "vocab_loss": job_vocab_loss, "embed_grad": job_embed_grad}


def progress_path(store, rank):
    """The file where rank ``rank`` of the group on ``store`` says what it
    is doing."""
    return f"{store}.rank{rank}.json"


def _say(path, doing, done):
    """Write ``{"doing", "since", "done": [[job, wall_s], ...]}`` to
    ``path`` (whole, or not at all)."""
    with open(path + ".tmp", "w") as f:
        json.dump({"doing": doing, "since": time.time(), "done": done}, f)
    os.replace(path + ".tmp", path)


def run(rank, world, store, out, jobs, timeout_s):
    """Rank ``rank`` of ``world``: start the gloo group on the file store
    (each collective waits at most ``timeout_s``), run each (name, job,
    kwargs) of ``jobs`` and save its result (or the traceback, headed by
    the rank and the job) as ``<out>/<name>_<rank>.pt``.  What the rank is
    doing, and each finished job's wall, is kept in
    ``progress_path(store, rank)``."""
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    path, done = progress_path(store, rank), []
    _say(path, "joining the group", done)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        for name, job, kwargs in jobs:
            _say(path, name, done)
            t0 = time.perf_counter()
            try:
                res = JOBS[job](rank, out, **kwargs)
            except Exception:
                res = {"error": f"rank {rank}, job {name}:\n"
                                f"{traceback.format_exc()}"}
            res["wall_s"] = time.perf_counter() - t0
            torch.save(res, os.path.join(out, f"{name}_{rank}.pt"))
            done.append([name, res["wall_s"]])
            _say(path, f"the barrier after {name}", done)
            dist.barrier()
        _say(path, None, done)
    finally:
        dist.destroy_process_group()

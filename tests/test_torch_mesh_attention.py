"""Port parity: attention, decode and the loss on a device mesh at the
reference's layout (``repro_torch.models.layers``: ``attend``, split-K
decode, the vocabulary-split NLL), on gloo CPU ranks.  Training on a
mesh is in ``tests/test_torch_mesh_train.py``.

The module fixture runs one 4-rank group through
``_torch_mesh_group.spawn``; it has a deadline of ``MARGIN`` times its
wall on an idle 8-CPU host, and its ranks a collective timeout of
``MARGIN`` times the longest job's (at least 60 s).  The runs are held against the port's
meshless run on the same weights and inputs and against the reference
on the weights it drew (carried over with ``repro_torch.convert``):

- attention at the reference's layout, where an older layout gathered
  (``layers.attend``): granite and h2o-danube (window, dense and
  query-chunked) on (1, 4), whose 4 ranks do not divide the 2 kv heads,
  and phi3 on (2, 2), whose head dim is split: loss within rtol 1e-6
  and every gradient (``wk`` and ``wv`` included) within 1e-5 x max|g|
  of the meshless port; against ``jax.grad`` of the reference's loss,
  rtol 1e-4 and 1e-5 x max|g|.  Each call's layout and each rank's local
  shapes at the products are the reference layout's.
- decode on (2, 2) from a cache placed by ``cache_shardings`` (the rows
  over 'data', the ring over 'model', split-K): two steps' logits and
  the cache within 1e-5 of the meshless port's; granite's and zamba2's
  greedy decode, logits within 1e-5 of the meshless port's and of the
  reference's, the tokens equal, for 8 steps.
- the loss with the vocabulary split over the 4 'model' ranks of (1, 4)
  (granite's smoke widths, a vocabulary of 250 padded to 256, the
  sequence in chunks of 8, some labels ignored): each rank reduces its
  64 entries of every row, nothing gathers the vocabulary; loss within
  rtol 1e-6 and every gradient within 1e-5 x max|g| of the meshless
  port, and against ``jax.grad`` of the reference's loss rtol 1e-4 and
  1e-5 x max|g|.
- the embedding lookup on the table's shards on (2, 2) and (1, 4): the
  rows equal, and each rank's shard of the table's gradient bitwise the
  meshless backward's (the same sum in the same order); where the table
  is whole on a mesh dim that splits the batch ('pod' of a (2, 1, 2)
  ("pod", "data", "model") mesh, or 'data' of (2, 2) without FSDP), the
  gradient is reduced over that dim: in the table's placements, bitwise
  the meshless one where each row's tokens lie in one half of the batch,
  and within 1e-5 x max|g| where they lie in both (two partial sums).
"""
import collections
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

# the group's wall on an idle 8-CPU host (spawn to the last rank's exit;
# the larger of two runs).  Under the suite's `pytest -n 6 --dist
# loadfile` it took 1.7x as long (54.8 s); the margin is
# ``test_torch_mesh_train.py``'s, and so is the collective timeout's
# rule (the longest job: phi3's head-dim split).
IDLE_S = 31.9
JOB_IDLE_S = 6.9
MARGIN = 6
DEADLINE_S = MARGIN * IDLE_S
COLLECTIVE_S = collective_timeout(MARGIN, JOB_IDLE_S)

DECODE_ARCHS = ("granite-3-2b", "zamba2-1.2b")
# attention jobs: name -> (arch, mesh shape, sequence, config overrides);
# 4 'model' ranks do not divide 2 kv heads, phi3's 5 heads take the
# head_dim rule on 2
SPLITS = {"split_granite": ("granite-3-2b", (1, 4), W.SEQ, {}),
          "split_danube": ("h2o-danube-3-4b", (1, 4), 2 * W.SEQ, {}),
          "split_danube_chunked": ("h2o-danube-3-4b", (1, 4), 2 * W.SEQ,
                                   {"attn_q_chunk": 8}),
          "split_phi3": ("phi3-medium-14b", (2, 2), W.SEQ, {})}
# the vocabulary-split loss: a padded vocabulary, the sequence in chunks
LOSS = {"vocab": 250, "ce_seq_chunk": 8}
# the lookup on the table's shards: vocabulary over 'model', columns over
# 'data' ((2, 2)), or the vocabulary over 4 ranks ((1, 4))
EMBED_MESHES = ((2, 2), (1, 4))
# ... and tables whole on a mesh dim that splits the batch: name ->
# (mesh shape, mesh axes, FSDP)
EMBED_WHOLE = {"pod": ((2, 1, 2), ("pod", "data", "model"), True),
               "no_fsdp": ((2, 2), ("data", "model"), False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    family = {}
    for job, (arch, _, _, over) in SPLITS.items():
        family[job] = (os.path.join(d, f"{job}.pt"),)
        family[job] += reference_weights(arch, family[job][0], **over)
    for arch in DECODE_ARCHS:
        path = os.path.join(d, f"greedy_{arch}.pt")
        family[f"greedy_{arch}"] = (path,) + reference_weights(arch, path)
    family["vocab_loss"] = (os.path.join(d, "vocab_loss.pt"),)
    family["vocab_loss"] += reference_weights("granite-3-2b",
                                              family["vocab_loss"][0],
                                              **LOSS)
    res = spawn(4, d, [
        *((f"decode_{arch}", "decode", dict(arch=arch))
          for arch in DECODE_ARCHS),
        *((job, "grads", dict(arch=arch, weights=family[job][0],
                              mesh_shape=ms, seq=seq, overrides=over))
          for job, (arch, ms, seq, over) in SPLITS.items()),
        *((f"greedy_{arch}", "greedy",
           dict(arch=arch, weights=family[f"greedy_{arch}"][0]))
          for arch in DECODE_ARCHS),
        ("vocab_loss", "vocab_loss",
         dict(weights=family["vocab_loss"][0], overrides=LOSS)),
        *((f"embed_grad_{a}x{b}", "embed_grad", dict(mesh_shape=(a, b)))
          for a, b in EMBED_MESHES),
        *((f"embed_grad_{name}", "embed_grad",
           dict(mesh_shape=ms, axes=axes, fsdp=fsdp))
          for name, (ms, axes, fsdp) in EMBED_WHOLE.items())],
        DEADLINE_S, COLLECTIVE_S)
    return {"dir": d, "family": family, "res": res}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_mesh_decode_matches_meshless(runs, arch):
    """Two decode steps on (2, 2) from a prefilled cache placed by
    ``cache_shardings`` (its ring split over 'model'): each rank writes
    the new slot into its own shard.  Logits, and the cache after the
    steps, within 1e-5 (absolute and relative) of the meshless steps:
    the sharded products sum in another order."""
    from torch.utils._pytree import tree_flatten

    res = ok(runs, f"decode_{arch}")[0]
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


@pytest.mark.parametrize("job", list(SPLITS))
def test_mesh_attention_split_matches_meshless_and_reference(runs, job):
    """Attention split where the old layout gathered: q's heads over ranks
    that do not divide the kv heads (granite, danube with its window,
    dense and query-chunked; ``wk`` and ``wv`` gradients partial sums on
    the ranks), or the head dim (phi3).  Meshless: loss rtol 1e-6, every
    gradient 1e-5 x max|g|; the reference's ``jax.grad``: rtol 1e-4,
    1e-5 x the largest |g|."""
    arch, _, seq, over = SPLITS[job]
    res = ok(runs, job)[0]
    cfg = W.smoke_cfg(arch, **over)
    loss, grads = meshless_step(cfg, runs["family"][job][0], seq)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)
    assert {"wk", "wv"} <= {k.rsplit(".", 1)[-1] for k in res["grads"]}
    grads_within(res["grads"], grads)
    _, jm, values = runs["family"][job]
    within_reference(res["loss"], res["grads"],
                     *reference_step(jm, values, cfg, seq))


@pytest.mark.parametrize("job", list(SPLITS) + [f"greedy_{a}" for a in
                                                 DECODE_ARCHS])
def test_mesh_attention_local_shapes_follow_reference_layout(runs, job):
    """Each rank's q and k at attention's products: granite and danube on
    (1, 4) hold H/4 = 1 q head and its one kv head, phi3 on (2, 2) its
    hd/2 slice of every head; decode on (2, 2) holds B/2 rows of q and
    C/2 ring slots of k."""
    B, C = W.BATCH, W.SEQ
    for res in ok(runs, job):
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

    res = ok(runs, f"greedy_{arch}")[0]
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


def test_mesh_loss_reduces_over_vocab_shards(runs):
    """The loss on (1, 4) with the vocabulary split over 'model': every
    chunk's logits reduced on each rank's 64 of the 256 padded entries
    (the forward pass and the backward pass's recompute), no whole-row
    gather; loss and gradients against the meshless port and the
    reference's ``jax.grad`` on the same batch, labels < 0 ignored."""
    cfg = W.smoke_cfg("granite-3-2b", **LOSS)
    batch = W.loss_batch(cfg)
    assert (batch["labels"] < 0).any() and (batch["labels"] >= 0).any()
    for res in ok(runs, "vocab_loss"):
        seen = res["seen"]
        assert seen["take_last"] == 0
        assert len(seen["split"]) == 2 * (W.SEQ // LOSS["ce_seq_chunk"])
        for glob, local in seen["split"]:
            assert glob == (W.BATCH, LOSS["ce_seq_chunk"], 256), glob
            assert local == (W.BATCH, LOSS["ce_seq_chunk"], 64), local
    res = ok(runs, "vocab_loss")[0]
    path, jm, values = runs["family"]["vocab_loss"]
    loss, grads = meshless_step(cfg, path, W.SEQ, batch)
    np.testing.assert_allclose(res["loss"], loss, rtol=1e-6)
    grads_within(res["grads"], grads)
    within_reference(res["loss"], res["grads"],
                     *reference_step(jm, values, cfg, W.SEQ, batch))


def _meshless_lookup(halves):
    """``table[tokens]`` and its table's gradient of ``sum(rows *
    weights)`` on ``W.embed_inputs(halves)``."""
    table, tokens, weights = W.embed_inputs(halves)
    table.requires_grad_(True)
    rows = table[tokens]
    (rows * weights).sum().backward()
    return rows.detach(), table.grad


def _rank_shards(ranks, inputs, grad, same):
    """Each rank's rows equal to ``table[tokens]``'s and its gradient
    shard held to ``grad``'s rows and columns by ``same``; every entry of
    the table lies on one rank of each set of ranks that splits it."""
    covered = collections.Counter()
    for res in ranks:
        res = res[inputs]
        (r0, nr), (c0, nc) = res["range"]
        assert nr < grad.shape[0]           # the vocabulary is split
        same(res["grad"], grad[r0:r0 + nr, c0:c0 + nc])
        covered[r0, nr, c0, nc] += 1
    assert len({n for n in covered.values()}) == 1, covered
    cells = torch.zeros(grad.shape, dtype=torch.int32)
    for r0, nr, c0, nc in covered:
        cells[r0:r0 + nr, c0:c0 + nc] += 1
    assert bool((cells == 1).all())


@pytest.mark.parametrize("mesh_shape", EMBED_MESHES)
def test_mesh_lookup_table_gradient_is_bitwise_meshless(runs, mesh_shape):
    """The embedding lookup on the table's own shards (``layers.embed``:
    vocabulary over 'model', columns over 'data'): the rows equal
    ``table[tokens]``'s, and each rank's shard of the table's gradient is
    bitwise the rows and columns it owns of the meshless backward's, on
    tokens that repeat rows (each row's sum in the same order)."""
    ranks = ok(runs, "embed_grad_%dx%d" % mesh_shape)
    for inputs in ("shared", "halves"):
        rows, grad = _meshless_lookup(inputs == "halves")
        for res in ranks:
            assert torch.equal(res[inputs]["rows"], rows)
            table, g = res[inputs]["placements"]
            assert g == table and not any(p.is_replicate() for p in table)
        _rank_shards(ranks, inputs, grad,
                     lambda got, want: torch.equal(got, want) or
                     pytest.fail("not bitwise"))


@pytest.mark.parametrize("name", EMBED_WHOLE)
def test_mesh_lookup_gradient_is_reduced_where_the_table_is_whole(runs,
                                                                   name):
    """The lookup where the table is whole on a mesh dim that splits the
    batch ('pod', or 'data' without FSDP): each rank's gradient covers
    only its tokens there, and is reduced over that dim, so the table's
    gradient is in the table's own placements and each rank's shard is
    the meshless backward's: bitwise where each row's tokens lie in one
    half of the batch (the other half adds an exact zero), and within
    1e-5 x max|g| where a row's tokens lie in both halves (two partial
    sums, added in another order than the meshless backward's)."""
    ranks = ok(runs, f"embed_grad_{name}")
    for inputs in ("shared", "halves"):
        rows, grad = _meshless_lookup(inputs == "halves")
        for res in ranks:
            assert torch.equal(res[inputs]["rows"], rows)
            table, g = res[inputs]["placements"]
            assert g == table and any(p.is_replicate() for p in table)
        if inputs == "halves":
            _rank_shards(ranks, inputs, grad,
                         lambda got, want: torch.equal(got, want) or
                         pytest.fail("not bitwise"))
        else:
            _rank_shards(ranks, inputs, grad, lambda got, want:
                         grads_within({"g": got}, {"g": want}))

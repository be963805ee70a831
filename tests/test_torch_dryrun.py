"""The dry-run and roofline counterpart (``repro_torch.launch.{dryrun,
roofline}``): cells traced on fake tensors over a fake process group, on
this host's CPU.

The reference lowers its cells on fake XLA devices and reads HLO; the
port traces the same step on ``FakeTensorMode`` over a fake process
group, so the checks are the reference's own
(``tests/test_sharding.py::test_roofline_terms_dominance``,
``tests/test_rl_and_multidevice.py::test_dryrun_cell_smoke_subprocess``)
with H100 constants:

- the roofline terms: each term from its constant, the dominant term,
  the fraction in (0, 1], the useful ratio;
- a smoke granite train cell on one rank, a (2, 2) and a (2, 2, 2)
  mesh: collective bytes > 0 on a mesh (the FSDP all-gathers exist) and
  0 on one rank; global FLOPs equal on the three within 1%; FLOPs over
  ``model_flops`` inside [1.25, 1.45].  That band is measured: 1.329 for
  this cell (forward, the remat recompute and backward of every product
  over the 6N rule, on the CPU), 1.400 for granite-3-2b's train_4k cell;
- smoke falcon-mamba-7b and zamba2-1.2b train cells return ``ok``, and
  granite and zamba2 prefill and decode cells;
- granite's smoke decode step on (2, 4) gathers the weights to the
  shapes the reference's step compiled by XLA gathers them
  (``tests/_torch_xla_layout.py``), and its embedding lookup moves only
  the int32 tokens and the rows, as the reference's does;
- a decode cell's peak holds only the rank's shards: peak minus held is
  the same at 1 and 4 layers and under one whole layer's weights;
- importing the dry-run loads no JAX.
"""
import collections
import functools
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.roofline import (HBM_BW, NIC_BW,  # noqa: E402
                                         NVLINK_BW, PEAK_FLOPS,
                                         RooflineTerms, axis_link_bw,
                                         effective_link_bw)
from repro_torch.models.config import ShapeConfig  # noqa: E402

SMALL = ShapeConfig("small", 64, 8, "train")
FLOPS_BAND = (1.25, 1.45)


def test_roofline_terms_dominance():
    t = RooflineTerms(chips=256, hlo_flops=1e15, hbm_bytes_per_chip=4e9,
                      collective_bytes_per_chip=4e9, model_flops=6e14,
                      model_bytes=1e12, link_bytes_per_s=NIC_BW).finalize()
    assert t.compute_s == pytest.approx(1e15 / (256 * PEAK_FLOPS))
    assert t.memory_s == pytest.approx(4e9 / HBM_BW)
    assert t.collective_s == pytest.approx(4e9 / NIC_BW)
    assert t.dominant == "collective"
    assert 0 < t.roofline_fraction <= 1.0
    assert t.useful_ratio == pytest.approx(0.6)
    d = t.to_dict()
    assert d["step_time_s"] == t.collective_s == t.step_time_s
    assert d["ideal_time_s"] == pytest.approx(
        max(6e14 / (256 * PEAK_FLOPS), 1e12 / (256 * HBM_BW)))


def test_link_rates_by_mesh_axis():
    """An axis whose groups stay inside an 8-card node runs on NVLink;
    on the production meshes every axis crosses nodes."""
    assert axis_link_bw((16, 16), 1) == axis_link_bw((16, 16), 0) == NIC_BW
    assert axis_link_bw((2, 16, 16), 0) == NIC_BW
    assert axis_link_bw((2, 2), 0) == axis_link_bw((2, 2, 2), 0) == NVLINK_BW
    assert axis_link_bw((4, 4), 0) == NIC_BW       # stride 4 x 4 = 16
    assert axis_link_bw((1, 3), 1) == NIC_BW       # groups straddle nodes
    assert effective_link_bw({}, (2, 2)) == NVLINK_BW
    both = effective_link_bw({0: 1e9, 1: 1e9}, (16, 16))
    assert both == pytest.approx(NIC_BW)


@pytest.fixture(scope="module")
def granite_cells():
    cfg = get_smoke_config("granite-3-2b")
    return {ms: dryrun.run_cell("granite-3-2b", "small", cfg_override=cfg,
                                shape=SMALL, mesh_shape=ms, verbose=False)
            for ms in ((1, 1), (2, 2), (2, 2, 2))}


def test_granite_cell_collectives_and_memory(granite_cells):
    one = granite_cells[(1, 1)]
    assert one["ok"] and one["collective_bytes_per_chip"] == 0
    assert one["collectives"] == {}
    for ms in ((2, 2), (2, 2, 2)):
        rec = granite_cells[ms]
        assert rec["ok"], rec.get("traceback")
        assert rec["mesh"] == "x".join(map(str, ms))
        assert rec["chips"] == math.prod(ms)
        assert rec["collective_bytes_per_chip"] > 0
        assert rec["collectives"]["all-gather"] > 0      # FSDP gathers
        assert sum(rec["collective_bytes_by_axis"].values()) == \
            pytest.approx(rec["collective_bytes_per_chip"])
        # CommDebugMode sees the same collectives
        assert sum(rec["comm_debug_counts"].values()) == \
            sum(rec["collective_counts"].values())
        # a rank holds a shard of the state: less than on one rank
        assert rec["mem_params_gib"] < one["mem_params_gib"]
        assert rec["mem_opt_gib"] == pytest.approx(4 * rec["mem_params_gib"])
        assert 0 < rec["mem_args_gib"] <= rec["mem_peak_gib"]
        assert rec["per_device_flops"] < one["per_device_flops"]
    assert one["per_device_flops"] == one["flops_global"]


def test_granite_global_flops_independent_of_the_mesh(granite_cells):
    flops = [granite_cells[ms]["flops_global"] for ms in granite_cells]
    assert min(flops) > 0
    assert max(flops) <= 1.01 * min(flops)
    for rec in granite_cells.values():
        ratio = rec["flops_global"] / rec["model_flops"]
        assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
        roof = rec["roofline"]
        assert roof["hlo_flops"] == rec["flops_global"]
        assert roof["dominant"] in ("compute", "memory", "collective")
        assert 0 < roof["roofline_fraction"] <= 1.0


@pytest.mark.parametrize("mesh,batch", [((2, 2), 4), ((1, 1), 1)])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_ssm_cells_on_a_mesh(arch, mesh, batch):
    """Smoke SSM and hybrid train cells on (2, 2), and at one row on one
    rank (the card's one-rank mesh at B=1: a batch dim of size 1 is
    never split)."""
    rec = dryrun.run_cell(arch, "small", cfg_override=get_smoke_config(arch),
                          shape=ShapeConfig("small", 32, batch, "train"),
                          mesh_shape=mesh, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert (rec["collective_bytes_per_chip"] > 0) == (mesh == (2, 2))
    assert rec["flops_global"] > 0
    assert rec["roofline"]["chips"] == math.prod(mesh)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b"])
def test_serving_cells_on_a_mesh(arch, kind):
    """The prefill and decode steps trace on (2, 2) (the decode step
    writes its cache slot into the rank's shard of the ring)."""
    rec = dryrun.run_cell(arch, "small", cfg_override=get_smoke_config(arch),
                          shape=ShapeConfig("small", 32, 4, kind),
                          mesh_shape=(2, 2), verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["kind"] == kind and rec["flops_global"] > 0
    assert rec["collective_bytes_per_chip"] > 0


def test_skipped_cell_and_no_jax():
    rec = dryrun.run_cell("granite-3-2b", "long_500k", verbose=False)
    assert rec["ok"] and rec["skipped"] and "sub-quadratic" in \
        rec["skip_reason"]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.launch.dryrun; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'repro')))"],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True,
        text=True, check=True)
    assert out.stdout.strip() == "[]"


def _attention_on_fake_mesh(mesh_shape, arch="granite-3-2b", B=2, S=16):
    """One ``layers.attend`` call, forward and backward, at the smoke
    config's widths: q, k and v laid out as ``full_attention`` lays them
    out, counted by the dry-run's ``RankCounter`` on a fake mesh of
    ``mesh_shape`` (rank 0), and the meshless count of the same call by
    the flop counter.  (per-rank FLOPs by op, meshless FLOPs by op,
    collective bytes by (kind, mesh axis name), the call's layout)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist.sharding import make_mesh, on_mesh, use_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.registry import sharding_rules

    cfg = get_smoke_config(arch)
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    axes = dryrun.mesh_axes(mesh_shape)

    def inputs():
        return (torch.randn(B, S, H, hd), torch.randn(B, S, Kh, hd),
                torch.randn(B, S, Kh, hd), L.causal_mask(S, S))

    with FakeTensorMode():
        q, k, v, mask = inputs()
        for t in (q, k, v):
            t.requires_grad_(True)
        with FlopCounterMode(display=False) as fc:
            L.attend(q, k, v, mask, torch.float32).sum().backward()
    meshless = {str(op).split(".")[-1]: n for op, n in
                fc.get_flop_counts()["Global"].items()}
    layouts = []
    with dryrun.fake_group(math.prod(mesh_shape)), \
            dryrun._global_shapes_unseen():
        mesh = make_mesh(mesh_shape, axes, "cpu")
        rules = sharding_rules(cfg, mesh.size(mesh.ndim - 1))
        groups = {mesh.get_group(i).group_name: i for i in range(mesh.ndim)}
        with FakeTensorMode(), use_mesh(mesh, rules):
            q, k, v, mask = inputs()
            q = on_mesh(q, mesh, "attn_batch", "seq", "heads", "head_dim")
            k, v = (on_mesh(t, mesh, "attn_batch", "seq", "kv_heads",
                            "head_dim") for t in (k, v))
            for t in (q, k, v):
                t.requires_grad_(True)
            layouts.append(L._attend_layout(q, k, mask).modes)
            counter = dryrun.RankCounter(groups)
            with counter:
                L.attend(q, k, v, mask, torch.float32).sum().backward()
    coll = {(kind, axes[a] if a >= 0 else "other"): b
            for (kind, a), b in counter.kind_axis_bytes.items()}
    return dict(counter.op_flops), meshless, coll, layouts[0]


def test_attention_flops_split_over_model_ranks_on_a_fake_mesh():
    """granite's smoke widths (H=4, Kh=2) on a fake (2, 4) mesh: the 4
    'model' ranks split q's heads, which they do not divide into kv heads,
    so each rank's products (forward and backward) are a quarter of the
    meshless count, and no all-gather runs on 'model' (q is never made
    whole; k and v are whole on every rank already)."""
    flops, meshless, coll, modes = _attention_on_fake_mesh((2, 4))
    assert modes == ("whole", "heads")
    assert meshless["bmm"] > 0
    assert flops["bmm"] == meshless["bmm"] / 4
    assert coll.get(("all-gather", "model"), 0) == 0, coll


def test_attention_flops_split_over_head_dim_on_a_fake_mesh():
    """phi3's smoke widths (5 heads, hd 16) on a fake (2, 2) mesh: 'model'
    splits the head dim, so each rank's products are half the meshless
    count and the logits' partial sums are all-reduced (forward and
    backward) on 'model', with no all-gather there."""
    flops, meshless, coll, modes = _attention_on_fake_mesh(
        (2, 2), arch="phi3-medium-14b")
    assert modes == ("whole", "head_dim")
    assert flops["bmm"] == meshless["bmm"] / 2
    assert coll.get(("all-gather", "model"), 0) == 0, coll
    assert coll[("all-reduce", "model")] > 0


def _granite_products_on_fake_mesh(mesh_shape, shape, cfg=None):
    """granite's smoke step at ``shape`` (``cfg``: the smoke config)
    traced by ``run_cell`` on a fake mesh of ``mesh_shape``: (the record,
    the (mesh axis name, input shape) of every all-gather rank 0 issued
    outside the embedding lookup ``layers.embed``, the (kind, mesh axis
    name, dtype, output elements) of every collective it issued inside
    the lookup, and those of its backward pass: from the lookup's output
    gradient to the table's)."""
    from repro_torch.models import layers as L
    gathers, lookup_moves, lookup_back, in_embed = [], [], [], []

    def embed(table, tokens):
        in_embed.append(True)
        try:
            out = lookup(table, tokens)
        finally:
            in_embed.pop()
        if out.requires_grad:
            out.register_hook(lambda g: in_embed.append("backward"))
            table.register_hook(lambda g: in_embed.clear())
        return out

    class Counter(dryrun.RankCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func.__name__.split(".")[0]
            if name in dryrun.COLLECTIVES and \
                    not any(issubclass(t, DTensor) for t in types):
                group = next(a for a in reversed(args) if isinstance(a, str))
                axis = dryrun.mesh_axes(mesh_shape)[self.axis_of_group[group]]
                if in_embed:
                    (lookup_back if in_embed[-1] == "backward" else
                     lookup_moves).append((dryrun.COLLECTIVES[name], axis,
                                           out.dtype, out.numel()))
                elif name == "all_gather_into_tensor":
                    gathers.append((axis, tuple(args[0].shape)))
            return out

    from torch.distributed.tensor import DTensor
    saved, dryrun.RankCounter = dryrun.RankCounter, Counter
    lookup, L.embed = L.embed, embed
    try:
        rec = dryrun.run_cell("granite-3-2b", "small",
                              cfg_override=cfg or get_smoke_config(
                                  "granite-3-2b"),
                              shape=shape, mesh_shape=mesh_shape,
                              with_flops=False, verbose=False)
    finally:
        dryrun.RankCounter, L.embed = saved, lookup
    assert rec["ok"], rec.get("traceback")
    return rec, gathers, lookup_moves, lookup_back


def test_fsdp_tp_products_split_over_both_axes_on_a_fake_mesh():
    """granite's smoke train step on a fake (2, 4) mesh: the batch splits
    over 'data' and ``mlp``, ``qkv`` and the vocabulary over 'model', so
    each rank's matrix products (``mm``, ``addmm``: forward, remat
    recompute and backward) are an eighth of the meshless count; the
    weights are gathered on 'data' only (FSDP), never on 'model'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.registry import get_model

    cfg = get_smoke_config("granite-3-2b")
    model = get_model(cfg, device="meta")
    with FakeTensorMode():
        fn, args, _ = dryrun._build(cfg, SMALL, None, {}, None)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
    meshless = {str(op).split(".")[-1]: n for op, n in
                fc.get_flop_counts()["Global"].items()}
    rec, gathers, _, _ = _granite_products_on_fake_mesh((2, 4), SMALL)
    flops = rec["per_device_flops_by_op"]
    products = [op for op in ("mm", "addmm") if op in meshless]
    assert products
    for op in products:
        assert flops[op] * 8 == meshless[op], (op, flops[op], meshless[op])
    # what an all-gather of a product's weight on 'model' would take in:
    # its 'model' shard, its FSDP dim whole or split
    shards = set()
    for name, p in model.named_parameters():
        prefix, _, field = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        axes = owner.AXES[field]
        if p.dim() != 2:
            continue
        for a in (1, 2):
            shards.add(tuple(n // (4 if ax in ("qkv", "mlp", "vocab") else
                                   a if ax == "embed" else 1)
                             for n, ax in zip(p.shape, axes)))
    on_model = [shape for axis, shape in gathers if axis == "model"]
    assert not [s for s in on_model if s in shards], on_model
    assert [shape for axis, shape in gathers if axis == "data"]


def test_vocab_split_loss_moves_no_vocabulary():
    """``layers.nll_loss`` on a fake (2, 4) mesh, the logits' vocabulary
    split over 'model': forward and backward run no all-gather on
    'model', and its 'model' collectives do not grow with the
    vocabulary: the row max and the two row sums, 3·B_l·S float32
    values; the backward pass adds only the head's input gradient (B_l,
    S, d), summed once over the ranks' slices (``layers.grad_as_input``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import (make_mesh, on_mesh, shard_batch,
                                          use_mesh)
    from repro_torch.models import layers as L

    B, S, d = 4, 16, 64
    got = {}
    for V in (256, 1024):
        with dryrun.fake_group(8), dryrun._global_shapes_unseen():
            mesh = make_mesh((2, 4), ("data", "model"), "cpu")
            groups = {mesh.get_group(i).group_name: i for i in range(2)}
            with FakeTensorMode(), use_mesh(mesh, {}):
                table = on_mesh(torch.randn(V, d), mesh, "vocab", "embed")
                h = on_mesh(torch.randn(B, S, d), mesh, "batch", "seq",
                            "embed")
                labels = shard_batch(
                    {"l": torch.zeros(B, S, dtype=torch.long)}, mesh)["l"]
                for t in (table, h):
                    t.requires_grad_(True)
                for grad in (False, True):
                    counter = dryrun.RankCounter(groups)
                    with counter, torch.set_grad_enabled(grad):
                        loss = L.nll_loss(table, h, labels, V - 6, V)
                        if grad:
                            loss.backward()
                    got[V, grad] = {
                        (k, ("data", "model")[a]): b for (k, a), b in
                        counter.kind_axis_bytes.items()}
    for (V, grad), coll in got.items():
        assert coll.get(("all-gather", "model"), 0) == 0, (V, grad, coll)
    B_l = B // 2
    assert got[256, False][("all-reduce", "model")] == 3 * B_l * S * 4
    assert got[256, True][("all-reduce", "model")] == \
        3 * B_l * S * 4 + B_l * S * d * 4
    for grad in (False, True):
        assert {k: b for k, b in got[1024, grad].items() if k[1] == "model"} \
            == {k: b for k, b in got[256, grad].items() if k[1] == "model"}


@functools.lru_cache(maxsize=None)
def _reference_layout(kind="decode"):
    """What the reference's ``kind`` step for granite's smoke config (B=8,
    a 32-token sequence or cache) moves, compiled by XLA on eight fake CPU
    devices in (2, 4) (``tests/_torch_xla_layout.py``, a process of its
    own)."""
    helper = os.path.join(os.path.dirname(__file__), "_torch_xla_layout.py")
    proc = subprocess.run([sys.executable, helper, "granite-3-2b",
                           "--kind", kind, "--batch", "8", "--seq", "32"],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_decode_gathers_the_weights_as_the_reference_compiles_it():
    """granite's smoke decode step on a (2, 4) mesh, the reference's
    compiled by XLA on eight fake CPU devices (``tests/_torch_xla_layout.py``)
    and the port's traced: XLA makes each weight's FSDP split whole on
    'data' and keeps its 'model' split (the rows stay on their rank), and
    the port gathers the same weights to the same shapes on 'data', none
    on 'model', and moves no activations on 'data' outside the embedding
    lookup (whose rows the reference moves there too)."""
    ref = _reference_layout()
    # the reference's weights: every rank-2 gather (a norm scale reads
    # (1, d)), all of them on 'data'
    weights = [g for g in ref["gathers"] if len(g["shape"]) == 2]
    assert weights and {g["axis"] for g in weights} == {"data"}
    want = {tuple(n for n in g["shape"] if n != 1) for g in weights}

    rec, gathers, lookup, _ = _granite_products_on_fake_mesh(
        (2, 4), ShapeConfig("small", 32, 8, "decode"))
    on_data = {shape for axis, shape in gathers if axis == "data"}

    def whole(shape):
        """The shapes a gather of ``shape`` over 'data' (2 ranks) makes."""
        return {shape[:i] + (n * 2,) + shape[i + 1:]
                for i, n in enumerate(shape)}

    got = set().union(*(whole(s) for s in on_data))
    assert want <= got, (want, on_data)
    assert all(whole(s) & want for s in on_data), (want, on_data)
    assert not [s for axis, s in gathers if axis == "model" and len(s) == 2]
    moved = collections.Counter(rec["collective_bytes_by_kind_axis"])
    for kind, axis, dtype, n in lookup:
        moved[f"{kind}@{axis}"] -= n * dtype.itemsize
    assert not {k for k, b in moved.items() if k.endswith("@data")
                and not k.startswith("all-gather") and b}, moved


def test_decode_lookup_moves_only_the_tokens_as_the_reference_compiles_it():
    """The embedding lookup of granite's smoke decode step (float32, B=8)
    on (2, 4): the reference's step compiled by XLA gathers its int32
    tokens on 'data' (its one integer gather) and moves the rows it read
    from its table's shards by an all-to-all on 'data'; the port's lookup
    gathers the same int32 tokens on 'data', nothing of the table on any
    axis, and moves as many bytes of rows by an all-to-all on 'data' and
    by the all-reduce of the partial rows on 'model'."""
    ref = _reference_layout()
    tokens = [g for g in ref["gathers"] if g["dtype"] == "s32"]
    assert [g["axis"] for g in tokens] == ["data"], ref["gathers"]
    rows = ref["collective_bytes"]["all-to-all@data"]
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    _, _, moves, _ = _granite_products_on_fake_mesh(
        (2, 4), ShapeConfig("small", 32, 8, "decode"), cfg)
    gathers = [m for m in moves if m[0] == "all-gather"]
    assert gathers == [("all-gather", "data", torch.int32,
                        math.prod(tokens[0]["shape"]))], moves
    moved = collections.Counter()
    for kind, axis, dtype, n in moves:
        if kind != "all-gather":
            moved[kind, axis] += n * dtype.itemsize
    assert dict(moved) == {("all-to-all", "data"): rows,
                           ("all-reduce", "model"): rows}, moves


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_lookup_moves_tokens_and_rows_as_the_reference_compiles_it(kind):
    """The embedding lookup of granite's smoke train and prefill steps
    (float32, B=8, S=32) on (2, 4), held to the reference's step compiled
    by XLA: XLA makes the int32 tokens whole on every rank (its one
    integer gather, after a permute), reads the table's shards, sums the
    rows (the whole batch, the rank's columns) over 'model' by an
    all-reduce, splits them by batch by an all-to-all on 'data', and in
    the training step's backward pass moves their gradient back by an
    all-to-all on 'data': nothing of the table, and nothing of its
    gradient, moves.  The port gathers the same int32 tokens, nothing of
    the table, and moves as many bytes by the same collectives on the
    same axes, forward and backward."""
    ref = _reference_layout(kind)["lookup"]
    ints = [c for c in ref if c["kind"] == "all-gather"]
    assert [a[0] for c in ints for a in c["arrays"]] == ["s32"], ref
    assert all(a[0] == "s32" for c in ref if c["kind"] in
               ("all-gather", "collective-permute") for a in c["arrays"])

    def moved(colls):
        """Bytes by (kind, axis) of the reference's collectives of rows:
        XLA combines the loss's (B, S) row sums into the rows' all-reduce
        in the training step, so its arrays of rank < 3 are left out."""
        out = collections.Counter()
        for c in colls:
            if c["kind"] not in ("all-gather", "collective-permute"):
                out[c["kind"], c["axis"]] += sum(
                    4 * math.prod(shape) for dt, shape in c["arrays"]
                    if len(shape) >= 3)
        return dict(out)

    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    _, _, moves, back = _granite_products_on_fake_mesh(
        (2, 4), ShapeConfig("small", 32, 8, kind), cfg)
    assert [m for m in moves if m[0] == "all-gather"] == [
        ("all-gather", "data", torch.int32,
         math.prod(ints[0]["arrays"][0][1]))], moves
    for port, want in ((moves, moved(c for c in ref if not c["backward"])),
                       (back, moved(c for c in ref if c["backward"]))):
        got = collections.Counter()
        for k, axis, dtype, n in port:
            if k != "all-gather":
                got[k, axis] += n * dtype.itemsize
        assert dict(got) == want, (port, ref)
    assert bool(back) == (kind == "train")


def test_decode_peak_holds_only_the_rank_shards_at_any_depth():
    """granite's smoke decode step on a fake (2, 4) mesh at 1 and at 4
    layers: every parameter is made from the rank's shard alone, so the
    peak over what the rank holds (its parameter and cache shards, its
    tokens) is the step's temporaries: the same at both depths within
    10%, and less than one whole layer's weights."""
    from repro_torch.models.registry import get_model

    temp = {}
    for n in (1, 4):
        cfg = get_smoke_config("granite-3-2b").replace(num_layers=n)
        rec = dryrun.run_cell("granite-3-2b", "small", cfg_override=cfg,
                              shape=ShapeConfig("small", 32, 8, "decode"),
                              mesh_shape=(2, 4), with_flops=False,
                              verbose=False)
        assert rec["ok"], rec.get("traceback")
        temp[n] = (rec["mem_peak_gib"] - rec["mem_args_gib"]) * dryrun.GIB
        assert rec["mem_temp_gib"] * dryrun.GIB == pytest.approx(temp[n])
    layer = sum(p.numel() * p.element_size() for p in
                get_model(cfg, device="meta").layers[0].parameters())
    assert 0 < temp[1] < layer and 0 < temp[4] < layer, (temp, layer)
    assert abs(temp[4] - temp[1]) <= 0.1 * temp[1], temp


def _decode_cell(seq, **overrides):
    cfg = get_smoke_config("granite-3-2b").replace(**overrides)
    rec = dryrun.run_cell("granite-3-2b", "small", cfg_override=cfg,
                          shape=ShapeConfig("small", seq, 4, "decode"),
                          mesh_shape=(2, 2), with_flops=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    return cfg, rec


@pytest.mark.parametrize("fsdp", [True, False])
def test_decode_cell_collectives_do_not_move_the_cache(fsdp):
    """A decode step on (2, 2), the cache's ring over 'model' and its rows
    over 'data': the collective bytes a rank moves do not depend on the
    cache's length (split-K merges O(B·H·hd) a layer where the cache was
    once gathered), and without FSDP's weight gathers they stay under 24
    float32 values of (B, H·hd) a layer and two of (B, vocab) (the
    logits), at most 5% of the rank's share of the cache at C=8192."""
    cfg, short = _decode_cell(256, fsdp=fsdp)
    _, long = _decode_cell(8192, fsdp=fsdp)
    assert long["collective_bytes_per_chip"] == \
        short["collective_bytes_per_chip"]
    if fsdp:
        return
    B = 4
    bound = (24 * cfg.num_layers * B * cfg.n_heads * cfg.hd +
             2 * B * cfg.vocab) * 4
    cache = (2 * cfg.num_layers * B * 8192 * cfg.n_kv_heads * cfg.hd *
             cfg.dtype_torch.itemsize) / 4
    assert 0 < long["collective_bytes_per_chip"] <= bound
    assert bound <= 0.05 * cache
    assert "all-gather@data" not in long["collective_bytes_by_kind_axis"]


def test_split_k_attention_refuses_gradients():
    """Attention over a cache split by key position (decode's ``kv_seq``
    over 'model') is forward-only: a grad-enabled call whose inputs
    require grad raises, one under ``torch.no_grad`` runs split-K."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import make_mesh, on_mesh, use_mesh
    from repro_torch.models import layers as L

    with dryrun.fake_group(4), dryrun._global_shapes_unseen():
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode(), use_mesh(mesh, {}):
            q = on_mesh(torch.randn(4, 1, 4, 16), mesh, "batch", None,
                        "heads", "head_dim")
            k, v = (on_mesh(torch.randn(4, 32, 2, 16), mesh, "batch",
                            "kv_seq", "kv_heads", "head_dim")
                    for _ in range(2))
            mask = on_mesh(torch.zeros(4, 1, 1, 32), mesh, "batch", None,
                           None, "kv_seq")
            assert L._attend_layout(q, k, mask).modes == ("batch", "kv_seq")
            with torch.no_grad():
                out = L.attend(q, k, v, mask, torch.float32)
            assert out.shape == (4, 1, 4, 16)
            q.requires_grad_(True)
            with pytest.raises(RuntimeError, match="split-K"):
                L.attend(q, k, v, mask, torch.float32)

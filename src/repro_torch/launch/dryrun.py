"""Multi-card dry-run: the counterpart of ``repro.launch.dryrun``.

For an (architecture x input shape) cell, build the production mesh
(single pod (16, 16) ``("data", "model")``, or multi pod (2, 16, 16)
``("pod", "data", "model")``) on a fake process group of 256 or 512
ranks, place the model's parameters by ``sharding_rules`` and
``param_shardings`` on fake tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated), trace the train step, prefill or decode step
the card runs, and record, for rank 0:

  - memory: the parameters, gradients and AdamW moments from the local
    shard shapes, and the step's peak from ``MemTracker`` (the
    counterpart of XLA's ``memory_analysis``);
  - collectives: the output bytes and counts, by kind and by mesh axis,
    of the ``_c10d_functional`` collectives DTensor issues (the
    counterpart of the reference's HLO parse), the counts cross-checked
    with ``CommDebugMode``;
  - HBM bytes: every operation on the rank's shards reads each input once
    and writes each output once (views move nothing).  That is what an
    unfused eager run moves; it errs high where the 50 MB L2 keeps an
    operand between operations, and low where a kernel reads an operand
    more than once (a matrix product's tiles);
  - the largest buffers: the (operation, shape, dtype) of the eight
    largest outputs of the rank's operations, ``per_device_largest_outputs``;
  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the same step
    traced without a mesh, at global shapes (remat recompute included),
    so the count does not depend on the mesh, as the reference's unrolled
    lowering's does not.  The counter counts matrix products, attention
    and convolutions; elementwise work (the SSM scan's recurrence) is not
    in it.  ``per_device_flops`` is the same count over the operations
    rank 0 issues on its shards;
  - ``model_flops`` / ``model_bytes`` from the registry, and the H100
    roofline terms (``repro_torch.launch.roofline``).

A key the reference records with no torch measure (compile time, the
donated-alias bytes) is left out.  ``shape_applicable`` skips cells as
the reference does.  The dry-run runs on the host's CPU by nature: it
starts (and ends) its own fake process group, so no other default group
may be running.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--outdir ...]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.dist.sharding import make_mesh, shard_batch, use_mesh
from repro_torch.launch.mesh import model_axis_size
from repro_torch.launch.roofline import RooflineTerms, effective_link_bw
from repro_torch.launch.shardings import cache_shardings, param_shardings
from repro_torch.launch.train import shard_model
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.registry import (decode_input_specs, get_model,
                                         model_bytes, model_flops,
                                         prefill_input_specs,
                                         shape_applicable, sharding_rules,
                                         train_input_specs)
from repro_torch.train.loop import TrainConfig, init_state, make_train_step

GIB = 2 ** 30
# the _c10d_functional collectives DTensor issues, by the reference's names
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}
LARGEST_OUTPUTS = 8          # outputs a rank's record keeps, by bytes
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "wait_tensor", "_to_copy_meta"}


def mesh_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """The production mesh's axis names for a mesh of ``len(shape)``
    dims."""
    return ("pod", "data", "model")[-len(shape):]


def production_shape(multi_pod: bool) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0):
    collectives return shapes, nothing moves."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake process group; "
                           "a default group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _alltoall_as_on_cards():
    """DTensor's shard-to-shard move on a CPU mesh falls back to an
    all-gather; the card issues one all-to-all.  Trace the card's
    operation (its fake kernel gives the shape)."""
    from torch.distributed.tensor import placement_types as pt
    if not hasattr(pt, "shard_dim_alltoall") or \
            not hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        yield
        return

    def on_cards(input, gather_dim, shard_dim, mesh, mesh_dim):
        out = torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
        # the fake kernel cuts the rank's share out of every rank's input
        # gathered; where that is a view, it would hold the whole gather
        # in the traced peak: the card's result holds only the share
        if out.untyped_storage().nbytes() > _nbytes(out):
            out = out.clone()
        return out

    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = on_cards
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


@contextlib.contextmanager
def _global_shapes_unseen():
    """DTensor infers an operation's global output shape by running it on
    fake tensors of global shapes; that is not the rank's work, so it runs
    outside every active mode (the counters and the memory tracker)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                    None)
    if saved is None:
        raise RuntimeError("this torch's DTensor has no "
                           "_propagate_tensor_meta_non_cached: its global-"
                           "shape propagation would be counted as the "
                           "rank's work")

    def unseen(self, op_schema):
        with _disable_current_modes():
            return saved(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = unseen
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = saved


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class RankCounter(TorchDispatchMode):
    """Counts what rank 0 issues on its shards: DTensor operations are
    let through (``NotImplemented``) and seen again as the local
    operations and collectives they run.  Collectives: output bytes and
    counts by kind, by mesh axis (the group's axis, -1 for a group that
    is no single axis) and by both; HBM bytes: inputs and outputs of
    every other operation, views excepted; FLOPs: the flop counter's
    formulas, in all, by operation and by operation and input shapes;
    the LARGEST_OUTPUTS largest outputs it made, by (operation, shape,
    dtype)."""

    def __init__(self, axis_of_group: Dict[str, int]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.axis_of_group = axis_of_group
        self.coll_bytes: Dict[str, float] = collections.Counter()
        self.coll_counts: Dict[str, int] = collections.Counter()
        self.axis_bytes: Dict[int, float] = collections.Counter()
        self.kind_axis_bytes: Dict[Tuple[str, int], float] = \
            collections.Counter()
        self.op_flops: Dict[str, float] = collections.Counter()
        self.shape_flops: Dict[str, float] = collections.Counter()
        self.outputs: Dict[tuple, int] = {}
        self.hbm_bytes = 0.0
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)

        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor") and \
                name in COLLECTIVES:
            kind = COLLECTIVES[name]
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            nb = sum(_nbytes(t) for t in tree_flatten(out)[0])
            self.coll_bytes[kind] += nb
            self.coll_counts[kind] += 1
            axis = self.axis_of_group.get(group, -1)
            self.axis_bytes[axis] += nb
            self.kind_axis_bytes[kind, axis] += nb
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            f = self.flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.op_flops[name] += f
            self.shape_flops[f"{name} " + " x ".join(
                str(tuple(a.shape)) for a in args
                if isinstance(a, torch.Tensor))] += f
        if not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(_nbytes(t) for t in
                                  tree_flatten((args, kwargs))[0])
            for t in tree_flatten(out)[0]:
                self.hbm_bytes += _nbytes(t)
                if isinstance(t, torch.Tensor):
                    self._output(name, t)
        return out

    def _output(self, name: str, t: torch.Tensor) -> None:
        """Keeps ``t`` among the largest outputs (the first seen of equal
        ones)."""
        nb, full = _nbytes(t), len(self.outputs) >= LARGEST_OUTPUTS
        if full and nb <= min(self.outputs.values()):
            return
        self.outputs[name, tuple(t.shape), t.dtype] = nb
        if len(self.outputs) > LARGEST_OUTPUTS:
            least = min(self.outputs.values())
            del self.outputs[next(k for k in reversed(list(self.outputs))
                                  if self.outputs[k] == least)]

    def largest_outputs(self) -> Dict[str, int]:
        """{"op (shape) dtype": bytes} of the largest outputs, largest
        first."""
        return {f"{name} {shape} {str(dtype).split('.')[-1]}": nb
                for (name, shape, dtype), nb in sorted(
                    self.outputs.items(), key=lambda kv: -kv[1])}


def _fake_like(spec: torch.Tensor) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype in the active fake mode."""
    return torch.empty(spec.shape, dtype=spec.dtype)


def _tensors(tree):
    """The tensors of a step's arguments: dicts, sequences, NamedTuples
    and dataclasses (a ``TrainState``) walked, each tensor once."""
    seen, out, todo = set(), [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif dataclasses.is_dataclass(x):
            todo.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def _local_bytes(t) -> int:
    return _nbytes(t.to_local() if isinstance(t, DTensor) else t)


# ---------------------------------------------------------------------------
# step builders: (fn, args, model) per shape kind, on the active mesh
# (None: none)
# ---------------------------------------------------------------------------
def _placed_model(cfg: ModelConfig, mesh, rules):
    """``cfg``'s model with its parameters placed on ``mesh`` by
    ``rules``.  On a mesh of more than one rank each parameter is made
    from the rank's shard alone (``_fake_shard``), as the reference's
    per-device memory holds only shards; on one rank (or none) the whole
    model is the rank's share."""
    if mesh is None or mesh.size() == 1:
        model = get_model(cfg, device="cpu")
        return model if mesh is None else shard_model(model, mesh, rules)
    with _disable_current_modes():      # shapes only: not the rank's
        model = get_model(cfg, device="meta")
        values, shardings = param_shardings(model, mesh, rules)
    for name, sh in shardings.items():
        prefix, _, field = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        setattr(owner, field, torch.nn.Parameter(_fake_shard(values[name],
                                                             sh)))
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"parameters without a sharding: {left}")
    model.device = torch.device("cpu")      # where the model makes caches
    return model


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                train_config: Optional[TrainConfig] = None):
    model = _placed_model(cfg, mesh, rules)
    state = init_state(model)
    batch = {k: _fake_like(v) for k, v in
             train_input_specs(cfg, shape).items()}
    step = make_train_step(model, train_config or TrainConfig())
    return step, (state, batch), model


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    model = _placed_model(cfg, mesh, rules)
    batch = {k: _fake_like(v) for k, v in
             prefill_input_specs(cfg, shape).items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh)

    if cfg.family == "encdec":
        def step(batch):
            return model.init_cache(batch["frames"], shape.seq_len)
    else:
        def step(batch):
            return model.prefill(batch, shape.seq_len)
    return step, (batch,), model


def _fake_shard(spec: torch.Tensor, sh) -> DTensor:
    """A DTensor of ``spec``'s global shape placed by ``sh``, made from
    the rank's shard alone: a whole tensor made first would count in the
    traced peak (the whole cache of a decode cell on 256 ranks is 256
    shards)."""
    local, coord = list(spec.shape), sh.mesh.get_coordinate()
    for i, p in enumerate(sh.placements):      # DTensor's chunks, in order
        if p.is_shard():
            n = local[p.dim]
            chunk = -(-n // sh.mesh.size(i))
            local[p.dim] = max(0, min(chunk, n - coord[i] * chunk))
    return DTensor.from_local(torch.empty(local, dtype=spec.dtype), sh.mesh,
                              sh.placements, run_check=False,
                              shape=spec.shape, stride=spec.stride())


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    model = _placed_model(cfg, mesh, rules)
    with _disable_current_modes():      # shapes only: not the rank's
        cache, tok, _ = decode_input_specs(cfg, shape)
    tokens = _fake_like(tok)
    if mesh is None:
        cache = tree_map(_fake_like, cache)
    else:
        cache = tree_map(_fake_shard, cache, cache_shardings(cache, mesh))
        tokens = shard_batch({"tokens": tokens}, mesh)["tokens"]

    def step(cache, tokens):
        return model.decode_step(cache, tokens, shape.seq_len - 1)
    return step, (cache, tokens), model


BUILDERS = {"train": build_train, "decode": build_decode,
            "prefill": build_prefill}


def _build(cfg, shape, mesh, rules, train_config):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules, train_config)
    return BUILDERS[shape.kind](cfg, shape, mesh, rules)


def _state_gib(args, kind: str) -> Dict[str, float]:
    """Rank 0's parameters, gradients (the parameters' placements and
    dtype) and AdamW moments, from the local shard shapes."""
    if kind != "train":
        return {}
    state = args[0]
    params = sum(_local_bytes(p) for p in state.params.values())
    opt = sum(_local_bytes(m) for m in
              list(state.opt.mu.values()) + list(state.opt.nu.values()))
    return {"mem_params_gib": params / GIB, "mem_grads_gib": params / GIB,
            "mem_opt_gib": opt / GIB}


def global_flops(cfg: ModelConfig, shape: ShapeConfig,
                 train_config: Optional[TrainConfig] = None) -> float:
    """FLOPs of the step traced without a mesh at global shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        fn, args, _ = _build(cfg, shape, None, {}, train_config)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
    return float(fc.get_total_flops())


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             with_flops: bool = True, cfg_override: Optional[ModelConfig] = None,
             train_config: Optional[TrainConfig] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             shape: Optional[ShapeConfig] = None,
             verbose: bool = True) -> dict:
    """One (arch x shape) cell's record.  ``mesh_shape`` (default the
    production mesh) takes the last ``len(mesh_shape)`` of ("pod",
    "data", "model") as its axes; ``shape`` replaces ``SHAPES[
    shape_name]`` (a smaller cell, named ``shape_name``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mshape = tuple(mesh_shape or production_shape(multi_pod))
    chips = math.prod(mshape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, mshape)), "kind": shape.kind,
           "chips": chips, "ok": False}
    skip = shape_applicable(cfg, shape)
    if skip:
        rec.update(skipped=True, skip_reason=skip, ok=True)
        return rec
    try:
        t0 = time.perf_counter()
        with fake_group(chips), _alltoall_as_on_cards(), \
                _global_shapes_unseen():
            mesh = make_mesh(mshape, mesh_axes(mshape), "cpu")
            rules = sharding_rules(cfg, model_axis_size(mesh))
            groups = {mesh.get_group(i).group_name: i
                      for i in range(mesh.ndim)}
            with FakeTensorMode(), use_mesh(mesh, rules):
                mt = MemTracker()
                with mt:
                    fn, args, model = _build(cfg, shape, mesh, rules,
                                             train_config)
                    counter = RankCounter(groups)
                    with CommDebugMode() as comm, counter:
                        fn(*args)
                peak = next(iter(mt.get_tracker_snapshot(
                    "peak").values()), {}).get("Total", 0)
                held = sum(_local_bytes(t) for t in
                           _tensors((args, list(model.parameters()))))
        rec.update(
            ok=True, trace_s=time.perf_counter() - t0,
            mem_args_gib=held / GIB, mem_peak_gib=peak / GIB,
            mem_temp_gib=max(peak - held, 0) / GIB,
            **_state_gib(args, shape.kind),
            per_device_flops=counter.flops,
            hbm_bytes_per_chip=counter.hbm_bytes,
            collective_bytes_per_chip=float(sum(counter.coll_bytes.values())),
            collectives=dict(counter.coll_bytes),
            collective_counts=dict(counter.coll_counts),
            collective_bytes_by_axis={
                (mesh_axes(mshape)[a] if a >= 0 else "other"): b
                for a, b in counter.axis_bytes.items()},
            collective_bytes_by_kind_axis={
                f"{k}@{mesh_axes(mshape)[a] if a >= 0 else 'other'}": b
                for (k, a), b in counter.kind_axis_bytes.items()},
            per_device_flops_by_op=dict(counter.op_flops),
            per_device_flops_top=dict(counter.shape_flops.most_common(12)),
            per_device_largest_outputs=counter.largest_outputs(),
            comm_debug_counts={str(k).split(".")[-1]: v for k, v in
                               comm.get_comm_counts().items()},
        )
        link_bw = effective_link_bw(dict(counter.axis_bytes), mshape)
        del fn, args, model, mt
    except Exception as e:                       # noqa: BLE001
        rec.update(error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec

    if with_flops:
        try:
            rec["flops_global"] = global_flops(cfg, shape, train_config)
        except Exception as e:                   # noqa: BLE001
            rec["flops_error"] = f"{type(e).__name__}: {e}"
    mf, mb = model_flops(cfg, shape), model_bytes(cfg, shape)
    rec["model_flops"], rec["model_bytes"] = mf, mb
    if rec.get("flops_global"):
        rec["roofline"] = RooflineTerms(
            chips=chips, hlo_flops=rec["flops_global"],
            hbm_bytes_per_chip=rec["hbm_bytes_per_chip"],
            collective_bytes_per_chip=rec["collective_bytes_per_chip"],
            model_flops=mf, model_bytes=mb,
            link_bytes_per_s=link_bw).finalize().to_dict()
    if verbose:
        r = rec.get("roofline", {})
        print(f"[dryrun] {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
              f"trace={rec.get('trace_s', 0):6.1f}s "
              f"peak={rec.get('mem_peak_gib', 0):8.2f}GiB "
              f"dom={r.get('dominant', '?'):10s} "
              f"frac={r.get('roofline_fraction', 0):.3f}", flush=True)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-flops", action="store_true",
                    help="skip the meshless FLOPs trace")
    ap.add_argument("--outdir", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            path = os.path.join(args.outdir, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] cached {tag}")
                continue
            rec = run_cell(arch, shape, multi_pod=mp,
                           with_flops=not args.no_flops)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if not rec["ok"]:
                print(f"[dryrun] FAILED {tag}: {rec.get('error')}")


if __name__ == "__main__":
    main()

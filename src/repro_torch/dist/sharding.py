"""Logical-axis sharding: names -> PartitionSpec entries -> DTensor
placements, ported from ``repro.dist.sharding``.

Model code annotates every parameter dim and activation dim with a
*logical* axis name ("embed", "heads", "mlp", ...).  This module maps
those names onto the axes of a ``torch.distributed.device_mesh.DeviceMesh``:

  - ``DEFAULT_RULES`` is the reference's production layout: tensor-parallel
    dims over 'model', FSDP parameter sharding over 'data', batch dims
    over ('pod', 'data').  Per-arch overrides come from
    ``repro_torch.models.registry.sharding_rules`` and are merged on top
    via ``use_mesh(mesh, rules)``.
  - ``logical_to_spec`` resolves one tuple of names to the reference's
    ``PartitionSpec`` entries, as a tuple, with its three safety rails:
    names not mapped (or mapped to mesh axes that don't exist) replicate;
    each mesh axis is used by at most one dim (first dim wins); a dim whose
    size is not divisible by its mesh-axes product replicates (when the
    shape is known).  Trailing ``None`` entries are trimmed.
  - ``to_placements`` turns such a per-tensor-dim spec into DTensor's
    per-mesh-dim list of ``Shard`` / ``Replicate`` (a dim of size 1 is
    never split: DTensor refuses to flatten or drop a split dim of size
    1, as a matrix product over (1, S, d) does); ``Sharding`` (a mesh and
    its placements) is the port's ``NamedSharding``.
  - ``constrain(x, *names)`` is the in-model annotation point: the
    identity without an active ``use_mesh`` context (and for a tensor that
    is not a DTensor), a ``redistribute`` of a DTensor inside one.  The
    constraints are layout only: they never change a value.
    ``fsdp_whole(w)`` makes only a parameter's FSDP split whole before a
    product, so its tensor-parallel split stays (the reference's compiled
    FSDP x TP product).
  - ``distribute_params`` makes a model's parameters DTensors with the
    placements ``shardings_for_axes`` gives them, and ``shard_batch``
    keeps each rank's share of a global batch.  Inside ``use_mesh`` a
    plain tensor that meets a DTensor (a mask, a position vector) counts
    as replicated (DTensor's ``implicit_replication``), as an unannotated
    constant is under the reference's jit.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

_BATCH = object()    # sentinel: resolve to batch_axes(mesh)

# production layout: TP over 'model', FSDP over 'data', batch over pods
DEFAULT_RULES: Dict[str, object] = {
    "batch": _BATCH,
    "attn_batch": None,
    "seq": None,
    "kv_seq": "model",
    "embed": "data",          # FSDP parameter sharding
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,         # kv heads are few; replicate unless divisible
    "head_dim": None,
    "qkv": "model",
    "mlp": "model",
    "expert": None,
    "expert_mlp": "model",
    "inner": "model",
    "conv": None,
    "ssm_state": None,
    "dt_rank": None,
    "layers": None,
}

Spec = Tuple[object, ...]     # PartitionSpec entries: None | axis | axes


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: the port's ``NamedSharding``."""
    mesh: DeviceMesh
    placements: Tuple[object, ...]     # one Shard / Replicate per mesh dim


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of a mock mesh."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mock mesh's ``shape``
    mapping."""
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh.shape)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` over every rank of the default
    process group, which must be started and as large as the mesh."""
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def flat_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ranks of the default group, the data-parallel
    shape.  ``num_devices`` (None: all) is clamped to the world size, as
    the reference clamps it to the devices there are; a mesh spans the
    whole group, so a smaller count is refused."""
    world = torch.distributed.get_world_size()
    n = world if num_devices is None else max(1, min(num_devices, world))
    if n != world:
        raise ValueError(f"a flat mesh spans all {world} ranks of the "
                         f"process group, not {n}")
    return make_mesh((n,), (axis_name,), device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim spans: ('pod', 'data') filtered to the mesh."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _resolve(name: Optional[str], mesh, rules: Dict[str, object]):
    if name is None:
        return None
    entry = rules[name] if name in rules else DEFAULT_RULES.get(name)
    if entry is _BATCH:
        entry = batch_axes(mesh)
    return entry


def logical_to_spec(axes: Sequence[Optional[str]], mesh,
                    rules: Optional[Dict[str, object]] = None,
                    shape: Optional[Sequence[int]] = None) -> Spec:
    """Map a tuple of logical axis names to PartitionSpec entries.

    ``mesh`` is a ``DeviceMesh`` or anything with ``.axis_names`` and a
    ``.shape`` mapping, so mock meshes work for pure-logic tests."""
    rules = rules or {}
    names_in_mesh = axis_names(mesh)
    sizes = axis_sizes(mesh)
    used: set = set()
    out: List[object] = []
    for i, name in enumerate(axes):
        entry = _resolve(name, mesh, rules)
        if entry is None:
            out.append(None)
            continue
        as_tuple = isinstance(entry, tuple)
        names = tuple(entry) if as_tuple else (entry,)
        names = tuple(a for a in names
                      if a in names_in_mesh and a not in used)
        if not names:
            out.append(None)
            continue
        size = 1
        for a in names:
            size *= sizes[a]
        if shape is not None and shape[i] % size != 0:
            out.append(None)          # non-divisible dim: replicate
            continue
        used.update(names)
        out.append(names if as_tuple else names[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def to_placements(spec: Spec, mesh, ndim: int,
                  shape: Optional[Sequence[int]] = None
                  ) -> Tuple[object, ...]:
    """Per-tensor-dim spec -> per-mesh-dim placements.  A mesh axis named
    in dim d's entry shards dim d (``Shard(d)``); one named nowhere
    replicates.  A dim mapped to several axes, such as ("pod", "data"), is
    sharded over each of them in mesh order, which is the reference's
    major-to-minor order when the entry lists them in mesh order.  With
    ``shape``, a dim of size 1 (a spec entry only a mesh of size 1 along
    it can keep) stays whole: nothing is split either way."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] == 1):
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_names(mesh))


def sharding(mesh: DeviceMesh, spec: Spec, ndim: int,
             shape: Optional[Sequence[int]] = None) -> Sharding:
    return Sharding(mesh, to_placements(spec, mesh, ndim, shape))


# ---------------------------------------------------------------------------
# active-mesh context
# ---------------------------------------------------------------------------
_ACTIVE: list = []    # stack of (mesh, merged rules)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, rules: Optional[Dict[str, object]] = None):
    """Activate (mesh, per-arch rule overrides) for ``constrain`` calls made
    inside the context, where plain tensors meeting DTensors replicate."""
    _ACTIVE.append((mesh, dict(rules or {})))
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE[-1][0] if _ACTIVE else None


def active_rules() -> Dict[str, object]:
    return _ACTIVE[-1][1] if _ACTIVE else {}


def constrain(x, *axes: Optional[str]):
    """Annotate ``x``'s dims with logical names.  The identity without an
    active mesh or for a plain tensor; inside ``use_mesh``, a DTensor is
    redistributed to the spec's placements."""
    if not _ACTIVE or not isinstance(x, DTensor):
        return x
    mesh, rules = _ACTIVE[-1]
    spec = logical_to_spec(tuple(axes), mesh, rules, shape=x.shape)
    return x.redistribute(mesh, to_placements(spec, mesh, x.dim(), x.shape))


def fsdp_whole(w):
    """The parameter ``w`` with its FSDP split made whole: each mesh dim
    that the active rules' "embed" names (and that has more than one
    rank) replicates it, every other placement is kept, so a
    tensor-parallel split on 'model' stays.  A product ``x @ fsdp_whole(
    w)`` then runs on the rank's slice of ``w``'s columns (or rows), as
    the reference's compiled FSDP x TP product does; on ``w`` itself
    DTensor gathers it on every mesh dim.  The identity without an
    active mesh, for a plain tensor, and on a mesh whose FSDP dims are
    of size 1."""
    if not _ACTIVE or not isinstance(w, DTensor):
        return w
    mesh, rules = w.device_mesh, _ACTIVE[-1][1]
    entry = _resolve("embed", mesh, rules)
    fsdp = set(entry if isinstance(entry, tuple) else (entry,))
    names = axis_names(mesh)
    placements = tuple(
        Replicate() if names[i] in fsdp and mesh.size(i) > 1 else p
        for i, p in enumerate(w.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(mesh, placements)


def gathered(x):
    """The whole value of ``x`` as a plain tensor on every rank: a
    DTensor's ``full_tensor()`` (differentiable), anything else as it is.
    Ops without a DTensor sharding rule run on it."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def on_mesh(t, mesh: Optional[DeviceMesh], *axes: Optional[str]):
    """``t``, a plain tensor holding the same whole value on every rank, as
    a replicated DTensor on ``mesh`` laid out by ``constrain(.., *axes)``;
    ``t`` itself when ``mesh`` is None."""
    if mesh is None:
        return t
    rep = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                             run_check=False)
    return constrain(rep, *axes) if axes else rep


def shardings_for_axes(axes_tree: Dict[str, Tuple[Optional[str], ...]],
                       mesh: DeviceMesh,
                       shape_tree: Optional[Dict[str, Sequence[int]]] = None,
                       rules: Optional[Dict[str, object]] = None
                       ) -> Dict[str, Sharding]:
    """{name: logical axes} -> {name: ``Sharding``}.

    Uses the active ``use_mesh`` rules when none are passed.  With
    ``shape_tree`` ({name: shape}, or tensors), non-divisible dims
    auto-replicate."""
    if rules is None:
        rules = active_rules()

    def shape_of(name):
        if shape_tree is None:
            return None
        leaf = shape_tree[name]
        return tuple(getattr(leaf, "shape", leaf))

    return {name: sharding(mesh, logical_to_spec(ax, mesh, rules,
                                                 shape=shape_of(name)),
                           len(ax), shape_of(name))
            for name, ax in axes_tree.items()}


def like_placements(x, like):
    """A DTensor gradient ``x`` in the placements of its parameter
    ``like`` (a ``Partial`` sum is reduced); anything else as it is."""
    if not isinstance(x, DTensor) or \
            tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def drop_nondivisible(spec: Spec, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with every entry whose mesh-axes product does not divide
    its dim replaced by None (replicated)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            size *= sizes[a]
        out.append(entry if shape[i] % size == 0 else None)
    return tuple(out)


def batch_spec(mesh, shape: Sequence[int]) -> Spec:
    """The batch dim over ``batch_axes(mesh)``, the rest replicated."""
    return drop_nondivisible((batch_axes(mesh),) + (None,) * (len(shape) - 1),
                             shape, mesh)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DeviceMesh
                ) -> Dict[str, torch.Tensor]:
    """Each tensor of a global batch (the same on every rank) as a DTensor
    that keeps this rank's rows: no data moves between ranks."""
    return {k: distribute_tensor(
        v, mesh, to_placements(batch_spec(mesh, v.shape), mesh, v.dim(),
                               v.shape),
        src_data_rank=None) for k, v in batch.items()}


@torch.no_grad()
def distribute_params(model: nn.Module, shardings: Dict[str, Sharding]
                      ) -> nn.Module:
    """Replace every parameter of ``model`` named in ``shardings`` by a
    DTensor parameter with its placements, in place, and return the model.
    Every rank holds the whole parameter (the same seeded weights) and
    keeps its shard: no data moves between ranks."""
    for name, sh in shardings.items():
        prefix, _, field = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        p = getattr(owner, field)
        d = distribute_tensor(p.detach(), sh.mesh, sh.placements,
                              src_data_rank=None)
        setattr(owner, field, nn.Parameter(d, requires_grad=p.requires_grad))
    return model

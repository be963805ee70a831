"""Production mesh construction, ported from ``repro.launch.mesh``.

Functions, never module-level meshes, so importing this module starts no
process group.  Each needs the default process group started with as
many ranks as the mesh has devices (one rank a card).

Single pod:  (16, 16)    ("data", "model")        = 256 ranks
Multi pod:   (2, 16, 16) ("pod", "data", "model") = 512 ranks

The model axis (16) carries TP/EP/sequence-sharded KV; data carries
FSDP + batch; pod is pure data parallelism across the pod boundary.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.sharding import axis_sizes, make_mesh


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return make_mesh(shape, axes, device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh_from_plan(plan, device_type: str = "cuda") -> DeviceMesh:
    """Mesh from a fault-tolerance ``MeshPlan`` (the elastic restart path):
    the restarted process group must have ``plan.n_chips`` ranks."""
    return _mesh(plan.shape, plan.axis_names, device_type)


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"]

"""Sharding assembly for train/serve steps on a device mesh, ported from
``repro.launch.shardings``.

Builds (meta-tensor specs, ``Sharding``s) for:
  - the ``TrainState`` (params from their logical axes; the AdamW moments
    mirror the params; the steps replicate)
  - input batches (batch dim over (pod, data))
  - KV / SSM caches (path-pattern rules: kv_seq over 'model', batch over
    (pod, data); non-divisible dims auto-replicated)
A ``Sharding`` is a mesh and one placement per mesh dim, the port's
``NamedSharding``; every function returns them per leaf.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.sharding import (Sharding, Spec, batch_axes,
                                      drop_nondivisible, sharding,
                                      shardings_for_axes)
from repro_torch.models.module import param_axes
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import AdamState


_drop_nondivisible = drop_nondivisible


def named(mesh: DeviceMesh, spec: Spec, shape=None,
          ndim: Optional[int] = None) -> Sharding:
    """The ``Sharding`` of ``spec``, non-divisible dims replicated when
    ``shape`` is given (the tensor's rank is ``len(shape)``, else
    ``ndim``, else ``len(spec)``)."""
    if shape is not None:
        spec = _drop_nondivisible(spec, shape, mesh)
        ndim = len(shape)
    return sharding(mesh, spec, len(spec) if ndim is None else ndim, shape)


def _replicated(mesh: DeviceMesh) -> Sharding:
    return named(mesh, (), ndim=0)


def batch_shardings(specs: Dict[str, torch.Tensor], mesh: DeviceMesh
                    ) -> Dict[str, Sharding]:
    b = batch_axes(mesh)
    return {k: named(mesh, (b,) + (None,) * (v.dim() - 1), tuple(v.shape))
            for k, v in specs.items()}


def _meta_params(model) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for k, p in model.named_parameters()}


def param_shardings(model, mesh: DeviceMesh,
                    rules: Optional[Dict[str, object]] = None):
    """({name: meta tensor}, {name: Sharding}) of ``model``'s parameters,
    from their logical axes (``param_axes``) under ``rules`` (the active
    ``use_mesh`` rules when None)."""
    values = _meta_params(model)
    return values, shardings_for_axes(param_axes(model), mesh,
                                      shape_tree=values, rules=rules)


def train_state_shardings(model, mesh: DeviceMesh,
                          rules: Optional[Dict[str, object]] = None
                          ) -> Tuple[TrainState, TrainState]:
    """(state of meta tensors, state of ``Sharding``s): the AdamW moments
    (float32) mirror the parameters' placements and the steps
    replicate."""
    values, param_sh = param_shardings(model, mesh, rules)
    moments = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
               for k, v in values.items()}
    state_sds = TrainState(step=0, params=values,
                           opt=AdamState(step=0, mu=moments,
                                         nu=dict(moments)))
    rep = _replicated(mesh)
    state_sh = TrainState(step=rep, params=param_sh,
                          opt=AdamState(step=rep, mu=dict(param_sh),
                                        nu=dict(param_sh)))
    return state_sds, state_sh


def _tree_map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over a cache tree of dicts, NamedTuples and
    tuples of tensors, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def cache_shardings(cache, mesh: DeviceMesh):
    """Path-pattern shardings for the port's decode caches.

    rank-5 (L, B, C, Kh, hd)  k/v rings + cross KV: batch->data, C->model
    rank-3 (L, B, C)          ring positions:        batch->data, C->model
    rank-4 'conv' (L,B,W-1,Di): batch->data, Di->model
    rank-4 'ssm'  (L,B,Di,N):   batch->data, Di->model
    """
    b = batch_axes(mesh)

    def one(path, leaf):
        keys = "/".join(path)
        if leaf.dim() == 5:
            spec = (None, b, "model", None, None)
        elif leaf.dim() == 3:
            spec = (None, b, "model")
        elif leaf.dim() == 4 and "conv" in keys:
            spec = (None, b, None, "model")
        elif leaf.dim() == 4:
            spec = (None, b, "model", None)
        else:
            spec = ()
        return named(mesh, spec, tuple(leaf.shape))

    return _tree_map_with_path(one, cache)


def logits_sharding(mesh: DeviceMesh, shape) -> Sharding:
    return named(mesh, (batch_axes(mesh), None, "model"), shape)

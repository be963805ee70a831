"""Carry state across from ``repro``: its scenario tables and populations,
and its language models' weights, handed over as numpy arrays, become this
package's tensors on ``device``.

For the mapper the "weights" are the scenario tables (``FitnessParams``)
and the GA population, and the RL baselines' policy; for the serving
engine they are the tenants' model weights.  These functions are what lets both packages compute on the same
inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import Population
from repro_torch.core.fitness import FitnessParams


def fitness_params_from_numpy(lat, bw, bw_sys, flops, energy, objective_code,
                              device) -> FitnessParams:
    """``FitnessParams`` from the arrays of ``repro.core.fitness.
    FitnessParams`` (f32 tables, f32 scalars, i32 code or code vector)."""
    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32),
                               device=device)

    return FitnessParams(
        lat=f32(lat), bw=f32(bw), bw_sys=f32(bw_sys), flops=f32(flops),
        energy=f32(energy),
        objective_code=torch.as_tensor(np.array(objective_code,
                                                  dtype=np.int32),
                                       device=device))


def population_from_numpy(accel, prio, device) -> Population:
    """``Population`` from (P, G) accel (int32) and prio (float32) arrays."""
    return Population(
        accel=torch.as_tensor(np.array(accel, dtype=np.int32),
                              device=device),
        prio=torch.as_tensor(np.array(prio, dtype=np.float32),
                             device=device))


def _field(tree, name):
    """``name`` of a JAX value-tree node: a dict key or a NamedTuple field."""
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _fill(module: torch.nn.Module, tree, index=None) -> None:
    """Copy every parameter of ``module`` from the same-named leaf of
    ``tree``, taking ``leaf[index]`` of a stacked leaf when ``index`` is
    given.  Leaves go through float32, which holds bf16 exactly."""
    for name, p in module.named_parameters(recurse=False):
        leaf = np.asarray(_field(tree, name))
        if index is not None:
            leaf = leaf[index]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{type(module).__name__}.{name}: JAX leaf "
                             f"{leaf.shape} vs port {tuple(p.shape)}")
        p.data.copy_(torch.as_tensor(leaf.astype(np.float32)).to(p.dtype))


def model_from_numpy(cfg, values, device):
    """The port's ``MambaLM`` / ``HybridLM`` / ``TransformerLM`` for ``cfg``
    holding the weights of a JAX model's value tree
    (``module.split(model.init(key))[0]`` with numpy leaves).  The stacked
    ``(L, ...)`` layer leaves are sliced into the per-layer modules (a
    transformer layer's ``attn`` and ``mlp`` into its submodules); the
    hybrid's shared attention and MLP leaves, stacked ``(1, ...)``, give
    their one block."""
    from repro_torch.models.registry import get_model

    model = get_model(cfg, device="meta").to_empty(device=device)
    model.device = torch.device(device)
    _fill(model, values)                    # embed, final_norm
    lyr = values["layers"]
    for i, lp in enumerate(model.layers):
        _fill(lp, lyr, index=i)
        for name, sub in lp.named_children():   # the transformer's attn, mlp
            _fill(sub, _field(lyr, name), index=i)
    if cfg.family == "hybrid":
        shared = values["shared"]
        sh = model.shared
        _fill(sh, shared)
        _fill(sh.attn, _field(shared, "attn"), index=0)
        _fill(sh.mlp, _field(shared, "mlp"), index=0)
    return model


def policy_from_numpy(values, device):
    """The RL baselines' policy (``repro_torch.core.rl``, a dict of
    tensors) from the reference's ``repro.core.rl.PolicyParams`` with
    numpy leaves: each head's list of ``{"w", "b"}`` layers becomes
    ``"<head>.<i>.w"`` / ``"<head>.<i>.b"``, and ``log_std`` stays."""
    from repro_torch.core.rl import HEADS

    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    params = {}
    for head in HEADS:
        for i, layer in enumerate(_field(values, head)):
            params[f"{head}.{i}.w"] = f32(_field(layer, "w"))
            params[f"{head}.{i}.b"] = f32(_field(layer, "b"))
    params["log_std"] = f32(_field(values, "log_std"))
    return params

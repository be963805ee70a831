"""Gradient compression: int8 quantization + error-feedback all-reduce,
ported from ``repro.dist.compression``.

Data-parallel replicas quantize their local gradients to int8 (per-tensor
absmax scale), all-reduce the dequantized values, and keep the rounding
residual on their own device for the next step (error feedback /
EF-SGD), which keeps the compressed optimizer trajectory unbiased in the
long run.

As in the reference, what this carries is the EF-SGD numerics (quantize
-> dequantize -> mean-reduce, residual kept locally): the reduced payload
is the dequantized float32, so the traffic is that of an exact mean
all-reduce while the quantization error and its feedback loop are
modeled exactly.  ``quantize_int8`` rounds half to even, as
``jnp.round`` does, so both packages give the same bits.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_EPS = 1e-12

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) -> (q int8, scale f32 scalar); round-to-nearest (half to
    even) with per-tensor absmax scale, so |dequant - x| <= scale / 2."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=_EPS) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def error_feedback(g: torch.Tensor, e: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One replica's gradient through the int8 round trip: c = g + e is
    quantized; returns (dequantized c, the new residual c - dequantized)."""
    c = g.float() + e
    q, s = quantize_int8(c)
    deq = dequantize_int8(q, s)
    return deq, c - deq


def init_error_buffers(params: Tree, n_shards: int = 1) -> Tree:
    """Zeroed error-feedback residuals, one row per replica (leading
    ``n_shards`` axis, the reference's layout).  Each rank reads and
    writes only its own row: the residual never leaves its rank."""
    return {k: torch.zeros((n_shards,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for k, p in params.items()}


def make_compressed_grad_fn(loss_fn: Callable, mesh: DeviceMesh,
                            axis_name: str) -> Callable:
    """Build ``fn(params, batch, errors) -> (loss, grads, new_errors)``.

    ``params`` (a dict of tensors, the same on every rank) are replicated;
    ``batch`` (a tuple or dict of tensors holding the global batch) and
    ``errors`` split along ``axis_name``: the rank at coordinate i of that
    axis takes the i-th equal slice of every batch tensor's first dim and
    row i of every error buffer.  It computes its local gradient of
    ``loss_fn(params, local_batch)``, adds its residual, quantizes to int8,
    and the dequantized tensors are mean-all-reduced over
    ``mesh.get_group(axis_name)``; so is the loss.  The new residual is the
    rank's own rounding error, written into its row of the returned
    buffers.  ``errors`` must come from ``init_error_buffers(params,
    n_shards=<axis size>)``."""
    names = tuple(mesh.mesh_dim_names)
    dim = names.index(axis_name)
    axis_size = mesh.size(dim)
    group = mesh.get_group(axis_name)
    index = mesh.get_local_rank(axis_name)

    def local_slice(t: torch.Tensor) -> torch.Tensor:
        n = t.shape[0] // axis_size
        return t[index * n:(index + 1) * n]

    def mean(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t / axis_size

    def fn(params: Tree, batch, errors: Tree):
        err_dim = next(iter(errors.values())).shape[0]
        if err_dim != axis_size:
            raise ValueError(
                f"error buffers have leading dim {err_dim} but the "
                f"{axis_name!r} mesh axis has {axis_size} shards — build "
                f"them with init_error_buffers(params, n_shards={axis_size})")
        if isinstance(batch, dict):
            local = {k: local_slice(v) for k, v in batch.items()}
        else:
            local = tuple(local_slice(v) for v in batch)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_fn(leaves, local)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out, new_err = {}, {}
        for k, g in zip(leaves, grads):
            deq, residual = error_feedback(g, errors[k][index])
            out[k] = mean(deq)
            e = errors[k].clone()
            e[index] = residual                  # the residual stays local
            new_err[k] = e
        return mean(loss.detach().float()), out, new_err

    return fn

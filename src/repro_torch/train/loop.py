"""Training loop, ported from ``repro.train.loop``: the train step (loss ->
grads -> clip -> AdamW), microbatched gradient accumulation, and
checkpoint/restart.

Parameters stay in the model dtype (bf16 at full width) with f32 AdamW
moments; gradients come out of autograd in the parameter dtype, as
``jax.grad`` gives them, are accumulated over microbatches in f32 as
``g / n``, and are clipped by their global norm.  The learning rate is
read from the schedule at the step count before the step increments, so
with warmup the first step's rate is 0, as in the reference.

Where the JAX package returns a new state, the port updates the model's
parameters and the moments in place and returns a ``TrainState`` holding
them; ``TrainState.params`` are the model's own ``nn.Parameter``s, by
name.  ``init_state`` takes the weights the model was built with (its
``torch.Generator``), where the reference draws them from a key.

On a device mesh (``repro_torch.dist.sharding.use_mesh`` active, the
model's parameters DTensors from ``distribute_params``) the same step
runs sharded: every rank is handed the global batch and keeps its rows
(``shard_batch``), as the reference's sharded jit sees the global batch;
the loss is gathered to a plain scalar before the backward pass; each
gradient is redistributed to its parameter's placements before the
clip and AdamW (a sharded weight's gradient comes back as a ``Partial``
sum); and the clip's norm is taken over every rank.  Without a mesh the
step is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import (active_mesh, gathered,
                                      like_placements, shard_batch)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import (AdamState, AdamW, Tree,
                                         apply_updates, clip_by_global_norm,
                                         cosine_schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree               # the model's parameters by name (bf16/f32)
    opt: AdamState


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1      # gradient accumulation chunks


def init_state(model) -> TrainState:
    """Step 0 of ``model`` as built: its parameters (now asking for
    gradients) and zero f32 moments."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt = AdamW(weight_decay=0.0).init(params)
    return TrainState(step=0, params=params, opt=opt)


def _on_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _placed(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's share of a global batch on the active mesh; the batch
    itself without one."""
    mesh = active_mesh()
    return batch if mesh is None else shard_batch(batch, mesh)


def make_train_step(model, tc: TrainConfig) -> Callable:
    """Returns step(state, batch) -> (state, metrics); ``batch`` holds numpy
    arrays or tensors (``TokenStream.batch_at``)."""
    opt = AdamW(weight_decay=tc.weight_decay)
    lr_fn = cosine_schedule(tc.lr, tc.warmup_steps, tc.total_steps)

    def loss_and_grads(params: Tree, batch):
        loss, metrics = model.loss(_placed(batch))
        loss = gathered(loss)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = [like_placements(g, p) for g, p in zip(grads,
                                                        params.values())]
        metrics = {k: gathered(v).detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(params, grads))

    def accumulated_grads(params: Tree, batch):
        n = tc.microbatches
        micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = [torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
               for p in params.values()]
        metrics = {}
        for i in range(n):
            mb_loss, metrics, grads = loss_and_grads(
                params, {k: v[i] for k, v in micro.items()})
            parts = [g.float() for g in grads.values()]
            torch._foreach_div_(parts, float(n))
            torch._foreach_add_(acc, parts)
            loss = loss + mb_loss / n
        return loss, metrics, dict(zip(params, acc))

    def step(state: TrainState, batch):
        batch = _on_device(batch, model.device)
        if tc.microbatches > 1:
            loss, metrics, grads = accumulated_grads(state.params, batch)
        else:
            loss, metrics, grads = loss_and_grads(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm)
        lr = lr_fn(state.step)
        updates, opt_state = opt.update(grads, state.opt, state.params, lr=lr)
        del grads
        params = apply_updates(state.params, updates)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt=opt_state)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return step


def train(model, tc: TrainConfig, stream, steps: int,
          state: Optional[TrainState] = None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          log_every: int = 10,
          log_fn=print,
          history: Optional[List[dict]] = None) -> TrainState:
    """Train ``model`` up to step ``steps`` on ``stream``, resuming from the
    newest checkpoint in ``checkpoint_dir`` when there is one.  When a
    ``history`` list is given, each step appends its loss, grad norm, lr,
    wall seconds (host clock around a step that ends in a device sync),
    tokens and, on a card, peak device memory."""
    step_fn = make_train_step(model, tc)
    device = model.device
    if state is None:
        state = init_state(model)
        if checkpoint_dir:
            latest = ckpt.find_latest(checkpoint_dir)
            if latest is not None:
                state = ckpt.restore(latest, like=state)
                log_fn(f"[train] restored step {state.step} from {latest}")

    t0 = time.perf_counter()
    start = state.step
    for s in range(start, steps):
        batch = stream.batch_at(s)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_step
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if history is not None:
            history.append({
                "step": s + 1, "loss": loss, "grad_norm": gnorm,
                "lr": metrics["lr"], "wall_s": wall,
                "tokens": int(np.asarray(batch["labels"]).size),
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None)})
        if log_every and (s + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / max(s + 1 - start, 1)
            log_fn(f"[train] step {s + 1:5d} loss {loss:.4f} "
                   f"gnorm {gnorm:.3f} {dt * 1e3:.0f} ms/step")
        if checkpoint_dir and checkpoint_every and \
                (s + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, state)
    if checkpoint_dir:
        ckpt.save(checkpoint_dir, state)
    return state

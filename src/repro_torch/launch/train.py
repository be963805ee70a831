"""Training launcher, ported from ``repro.launch.train``.

    python -m repro_torch.launch.train --arch granite-3-2b [--smoke] \
        --steps 300 --batch 16 --seq 512 [--ckpt-dir ckpts/granite] \
        [--device cuda|cpu]

    torchrun --nproc-per-node N -m repro_torch.launch.train --arch ...

Builds the model on ``--device`` (the card by default) with weights drawn
from a ``torch.Generator`` seeded with ``--seed``, trains it on the
synthetic token stream with the reference's ``TrainConfig`` (warmup a
tenth of the steps, at least 5), writes checkpoints with atomic commit,
and resumes step and data order exactly from the newest one in
``--ckpt-dir``.  ``--smoke`` takes the reduced same-family config in
float32.  The dense, MoE, VLM, SSM, hybrid and encoder-decoder families
train, each with ``use_flash=False`` (the kernels have no gradient, as in
the reference).

The mesh branch follows the reference's: under ``torchrun`` with
``WORLD_SIZE`` > 1 the launcher starts the process group (NCCL on
``cuda``, one card a rank by ``LOCAL_RANK``; gloo on ``cpu``; a failure
raises, the launcher never carries on alone), builds the ``(n // min(n,
4), min(n, 4))`` ``("data", "model")`` mesh over the n ranks, and trains
through ``train_on_mesh``: the parameters and AdamW moments are DTensors
placed by ``sharding_rules(cfg, model axis size)``, every rank builds the
global batch ``stream.batch_at(step)`` and keeps its data shard, so a
mesh run sees the meshless run's batches, and checkpoints are written
whole by rank 0.  Every trainable family trains on a mesh.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.dist.sharding import (distribute_params, make_mesh,
                                      use_mesh)
from repro_torch.launch.mesh import model_axis_size
from repro_torch.launch.shardings import param_shardings
from repro_torch.models.registry import get_model, sharding_rules
from repro_torch.train.data import TokenStream
from repro_torch.train.loop import TrainConfig, train

TRAINABLE = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def train_config(steps: int, lr: float = 3e-4,
                 microbatches: int = 1) -> TrainConfig:
    """The launcher's schedule for ``steps`` steps: warmup a tenth of them,
    at least 5, then cosine decay, as in the reference's launcher."""
    return TrainConfig(lr=lr, warmup_steps=max(steps // 10, 5),
                       total_steps=steps, microbatches=microbatches)


def launch_mesh(n: int, device_type: str):
    """The launcher's ``(n // min(n, 4), min(n, 4))`` ``("data",
    "model")`` mesh over the n ranks of the default process group."""
    m = min(n, 4)
    return make_mesh((n // m, m), ("data", "model"), device_type)


def shard_model(model, mesh, rules):
    """Place ``model``'s parameters on ``mesh`` (DTensors) by their logical
    axes under ``rules``; returns the model."""
    _, shardings = param_shardings(model, mesh, rules)
    return distribute_params(model, shardings)


def train_on_mesh(cfg, mesh, tc: TrainConfig, stream, steps: int, *,
                  device, seed: int = 0, checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0, log_every: int = 10,
                  log_fn=print, history: Optional[List[dict]] = None):
    """The launcher's mesh branch: build ``cfg``'s model on this rank's
    ``device`` with weights from ``seed`` (the meshless run's weights),
    place its parameters on ``mesh`` by ``sharding_rules(cfg, model axis
    size)``, and train it under ``use_mesh`` up to step ``steps``,
    resuming from the newest checkpoint in ``checkpoint_dir``.  Returns
    (model, final TrainState)."""
    rules = sharding_rules(cfg, model_axis_size(mesh))
    gen = torch.Generator(device=device).manual_seed(seed)
    model = shard_model(get_model(cfg, device=device, generator=gen), mesh,
                        rules)
    with use_mesh(mesh, rules):
        state = train(model, tc, stream, steps,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      log_every=log_every, log_fn=log_fn, history=history)
    return model, state


def _start_group(device: torch.device) -> torch.device:
    """Start the default process group from ``torchrun``'s environment
    (unless the caller has) and return this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            device_id=device if device.type == "cuda" else None)
    return device


def main(argv: Optional[List[str]] = None, log_fn=print):
    """Parse ``argv``, train, and return (model, final TrainState, per-step
    history)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config in float32 (CPU-size)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    if cfg.family not in TRAINABLE:
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported; trainable: "
            + ", ".join(TRAINABLE))
    device = torch.device(args.device)
    tc = train_config(args.steps, args.lr, args.microbatches)
    stream = TokenStream(cfg, args.batch, args.seq, seed=args.seed)
    history: List[dict] = []
    n = int(os.environ.get("WORLD_SIZE", 1))
    if n > 1:
        started = not dist.is_initialized()
        device = _start_group(device)
        if dist.get_rank() != 0:
            log_fn = lambda *_: None  # noqa: E731
        try:
            model, state = train_on_mesh(
                cfg, launch_mesh(n, device.type), tc, stream, args.steps,
                device=device, seed=args.seed, checkpoint_dir=args.ckpt_dir,
                checkpoint_every=args.ckpt_every, log_fn=log_fn,
                history=history)
        finally:
            if started:
                dist.destroy_process_group()
        return model, state, history
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)
    state = train(model, tc, stream, args.steps,
                  checkpoint_dir=args.ckpt_dir,
                  checkpoint_every=args.ckpt_every, log_fn=log_fn,
                  history=history)
    return model, state, history


if __name__ == "__main__":
    main()

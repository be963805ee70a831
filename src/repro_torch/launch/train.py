"""Training launcher, ported from ``repro.launch.train``.

    python -m repro_torch.launch.train --arch granite-3-2b [--smoke] \
        --steps 300 --batch 16 --seq 512 [--ckpt-dir ckpts/granite] \
        [--device cuda|cpu]

Builds the model on ``--device`` (the card by default) with weights drawn
from a ``torch.Generator`` seeded with ``--seed``, trains it on the
synthetic token stream with the reference's ``TrainConfig`` (warmup a
tenth of the steps, at least 5), writes checkpoints with atomic commit,
and resumes step and data order exactly from the newest one in
``--ckpt-dir``.  ``--smoke`` takes the reduced same-family config in
float32.  One device only: the reference's data/model mesh over several
devices waits for ``repro_torch.dist`` (ROADMAP Queue 1 item 12), and the
launcher says so when more than one card is visible.  The dense, VLM,
SSM, hybrid and encoder-decoder families train, each with
``use_flash=False`` (the kernels have no gradient, as in the reference);
MoE raises ``NotImplementedError``: its published configs with AdamW
state do not fit one card, and sharding them waits for item 12.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.registry import get_model
from repro_torch.train.data import TokenStream
from repro_torch.train.loop import TrainConfig, train

TRAINABLE = ("dense", "vlm", "ssm", "hybrid", "encdec")


def train_config(steps: int, lr: float = 3e-4,
                 microbatches: int = 1) -> TrainConfig:
    """The launcher's schedule for ``steps`` steps: warmup a tenth of them,
    at least 5, then cosine decay, as in the reference's launcher."""
    return TrainConfig(lr=lr, warmup_steps=max(steps // 10, 5),
                       total_steps=steps, microbatches=microbatches)


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
            f"training the {cfg.family!r} family is not ported yet "
            "(ROADMAP Queue 1 item 12); trainable: "
            + ", ".join(TRAINABLE))
    device = torch.device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        log_fn(f"[train] {torch.cuda.device_count()} cards visible; training "
               "on one: the data/model mesh waits for repro_torch.dist "
               "(ROADMAP Queue 1 item 12)")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)
    tc = train_config(args.steps, args.lr, args.microbatches)
    stream = TokenStream(cfg, args.batch, args.seq, seed=args.seed)
    history: List[dict] = []
    state = train(model, tc, stream, args.steps,
                  checkpoint_dir=args.ckpt_dir,
                  checkpoint_every=args.ckpt_every, log_fn=log_fn,
                  history=history)
    return model, state, history


if __name__ == "__main__":
    main()

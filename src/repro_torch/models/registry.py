"""Architecture registry: config -> model, and the parameter counts that
the serving engine's cost model and the trainer's FLOP count read.

The SSM and hybrid families serve (``MambaLM``, ``HybridLM``); the dense
and VLM families train and evaluate (``TransformerLM``, whose attention has
a forward-only flash kernel, as in the JAX package).  MoE and encdec raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import HybridLM, MambaLM
from repro_torch.models.module import count_params as _count
from repro_torch.models.transformer import (ENCDEC_LATER, MOE_LATER,
                                            TransformerLM)

MODEL_FAMILIES = {
    "dense": TransformerLM,
    "vlm": TransformerLM,
    "ssm": MambaLM,
    "hybrid": HybridLM,
}
_LATER = {
    "moe": MOE_LATER,
    "encdec": ENCDEC_LATER,
}


def get_model(cfg: ModelConfig, *, device: Union[str, torch.device] = "cuda",
              generator: Optional[torch.Generator] = None):
    """The model of ``cfg.family`` with weights drawn from ``generator``
    on ``device`` (``meta``: shapes only, nothing allocated)."""
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet: "
            f"{_LATER[cfg.family]}")
    if cfg.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return MODEL_FAMILIES[cfg.family](cfg, device=device, generator=generator)


@functools.lru_cache(maxsize=64)
def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, counted on the ``meta`` device."""
    return _count(get_model(cfg, device="meta"))


def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token.  The ported families have no routed
    experts, so every parameter is active."""
    if cfg.n_experts:
        raise NotImplementedError(
            "active parameters of a MoE model: " + _LATER["moe"])
    return count_params(cfg)

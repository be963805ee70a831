"""Architecture registry: config -> model, and the parameter counts that
the serving engine's cost model and the trainer's FLOP count read.

Every family of the JAX package builds: dense, MoE and VLM
(``TransformerLM``), SSM (``MambaLM``), hybrid (``HybridLM``) and
encoder-decoder (``EncDecLM``).  Each computes its loss; the SSM, hybrid,
dense and MoE families also serve.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import HybridLM, MambaLM
from repro_torch.models.module import count_params as _count
from repro_torch.models.transformer import EncDecLM, TransformerLM

MODEL_FAMILIES = {
    "dense": TransformerLM,
    "moe": TransformerLM,
    "vlm": TransformerLM,
    "ssm": MambaLM,
    "hybrid": HybridLM,
    "encdec": EncDecLM,
}


def get_model(cfg: ModelConfig, *, device: Union[str, torch.device] = "cuda",
              generator: Optional[torch.Generator] = None):
    """The model of ``cfg.family`` with weights drawn from ``generator``
    on ``device`` (``meta``: shapes only, nothing allocated)."""
    if cfg.family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return MODEL_FAMILIES[cfg.family](cfg, device=device, generator=generator)


@functools.lru_cache(maxsize=64)
def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s model, counted on the ``meta`` device."""
    return _count(get_model(cfg, device="meta"))


@functools.lru_cache(maxsize=64)
def count_active_params(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k of n_experts routed).  As in
    the reference, the routed weights are counted over the padded expert
    axis but scaled by ``top_k / n_experts``: the serving engine's job
    costs read this number, so it is kept as the reference computes it."""
    total = count_params(cfg)
    if cfg.n_experts == 0:
        return total
    moe = get_model(cfg, device="meta").layers[0].moe
    routed = cfg.num_layers * sum(w.numel() for w in
                                  (moe.w_gate, moe.w_up, moe.w_down))
    active_routed = routed * cfg.top_k / max(cfg.n_experts, 1)
    return int(total - routed + active_routed)

"""Architecture registry: config -> model, per-arch sharding rules, input
specs for each shape cell, and the parameter counts and analytic
FLOPs/bytes that the serving engine's cost model and the trainer read.

Every family of the JAX package builds: dense, MoE and VLM
(``TransformerLM``), SSM (``MambaLM``), hybrid (``HybridLM``) and
encoder-decoder (``EncDecLM``).  Each computes its loss; the SSM, hybrid,
dense and MoE families also serve.  Input specs are tensors on the
``meta`` device: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import torch

from repro_torch.models.config import ModelConfig, ShapeConfig
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


# ---------------------------------------------------------------------------
# per-arch sharding rule overrides (divisibility-driven)
# ---------------------------------------------------------------------------
def sharding_rules(cfg: ModelConfig, model_axis: int = 16) -> Dict[str, object]:
    """Pick TP axes that divide this arch's dims.

    - heads: shard over 'model' when divisible (all archs but phi3);
      otherwise shard head_dim (phi3: 40 heads, hd=128 -> contraction-dim TP).
    - kv_heads: shard when divisible (qwen/moonshot/seamless kv=16);
      otherwise replicated (kv projections are small).
    """
    rules: Dict[str, object] = {}
    if not cfg.fsdp:
        rules["embed"] = None      # replicate weights across 'data'
    if cfg.attn_batch_shard:
        rules["attn_batch"] = ("pod", "data", "model")
        rules["heads"] = None
        rules["head_dim"] = None
    elif cfg.n_heads and cfg.n_heads % model_axis != 0:
        rules["heads"] = None
        if cfg.hd % model_axis == 0:
            rules["head_dim"] = "model"
    if cfg.n_kv_heads and cfg.n_kv_heads % model_axis == 0:
        rules["kv_heads"] = "model"
    return rules


# ---------------------------------------------------------------------------
# input specs of a shape cell (meta tensors)
# ---------------------------------------------------------------------------
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if (arch, shape) is runnable, else the documented skip reason."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window > 0)
        if not sub_quadratic:
            return ("full quadratic attention; long_500k requires a "
                    "sub-quadratic path (skip per assignment)")
    return None


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = cfg.dtype_torch, torch.int32
    if cfg.family == "vlm":
        P = cfg.num_prefix_embeds
        return {"embeds": _spec((B, P, cfg.d_model), dt),
                "tokens": _spec((B, S - P), i32),
                "labels": _spec((B, S - P), i32)}
    if cfg.family == "encdec":
        return {"frames": _spec((B, S, cfg.d_model), dt),
                "tokens": _spec((B, S), i32),
                "labels": _spec((B, S), i32)}
    return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = cfg.dtype_torch, torch.int32
    if cfg.family == "vlm":
        P = cfg.num_prefix_embeds
        return {"embeds": _spec((B, P, cfg.d_model), dt),
                "tokens": _spec((B, S - P), i32)}
    if cfg.family == "encdec":
        return {"frames": _spec((B, S, cfg.d_model), dt)}
    return {"tokens": _spec((B, S), i32)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, model=None):
    """(cache_specs, tokens_spec, pos_spec) for one decode step: the
    model's own ``init_cache`` on the ``meta`` device (the encoder-decoder
    encodes ``num_prefix_embeds`` frames for its cross K/V, as the
    reference's does)."""
    model = model or get_model(cfg, device="meta")
    B, S = shape.global_batch, shape.seq_len
    with torch.no_grad():
        if cfg.family == "encdec":
            frames = _spec((B, cfg.num_prefix_embeds, cfg.d_model),
                           cfg.dtype_torch)
            cache = model.init_cache(frames, S)
        else:
            cache = model.init_cache(B, S)
    return cache, _spec((B, 1), torch.int32), _spec((), torch.int32)


# ---------------------------------------------------------------------------
# analytic model bytes and FLOPs (the roofline's terms)
# ---------------------------------------------------------------------------
def model_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Model-essential HBM bytes per step, the memory-roofline floor, as
    the reference counts them.

    train:   AdamW update touches every param: read p(bf16) + m,v(f32),
             write same -> 20 B/param; plus grads r/w (4+4) and the
             per-layer checkpointed activations (write fwd + read bwd).
    decode:  read active params (bf16) once per token + read the KV/SSM
             state once; write one KV slot (negligible).
    prefill: read params once + stream activations through every layer.
    """
    n_total = count_params(cfg)
    n_active = count_active_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    n_layers = cfg.num_layers + cfg.encoder_layers
    if shape.kind == "train":
        act = 2 * 2 * B * S * d * n_layers          # ckpt stack w + r, bf16
        return float(28.0 * n_total + act)
    if shape.kind == "prefill":
        act = 2 * 2 * B * S * d * n_layers
        return float(2.0 * n_total + act)
    # decode: params + full KV/state read per emitted token
    if cfg.n_heads and cfg.family not in ("ssm",):
        eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
        n_attn = (math.ceil(cfg.num_layers / cfg.shared_attn_every)
                  if cfg.family == "hybrid" else n_layers)
        kv = 2 * n_attn * B * eff * max(cfg.n_kv_heads, 1) * cfg.hd * 2
    else:
        kv = 0.0
    if cfg.family in ("ssm", "hybrid"):
        kv += cfg.num_layers * B * cfg.inner * cfg.ssm_state * 4
    return float(2.0 * n_active + kv)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * tokens (train) or 2 * N_active * tokens (inference),
    plus the quadratic attention term where applicable."""
    n_active = count_active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention score/context FLOPs (not in the 6N rule)
    if cfg.n_heads:
        S = shape.seq_len
        eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
        if shape.kind == "decode":
            att = 2 * 2 * shape.global_batch * cfg.n_heads * cfg.hd * eff
        else:
            att = (2 * 2 * shape.global_batch * cfg.n_heads * cfg.hd * S
                   * eff / 2)
        n_attn_layers = (cfg.num_layers + cfg.encoder_layers
                         if cfg.family == "encdec" else
                         (math.ceil(cfg.num_layers / cfg.shared_attn_every)
                          if cfg.family == "hybrid" else cfg.num_layers))
        flops += (3.0 if shape.kind == "train" else 1.0) * att * n_attn_layers
    return float(flops)

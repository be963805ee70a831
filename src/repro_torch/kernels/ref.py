"""Plain PyTorch versions of the kernels (the tests' source of truth).

Each is the straightforward dense implementation of its kernel's contract,
written for clarity over speed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.bw_allocator import simulate_population


def population_makespan_ref(accel, prio, lat, bw, bw_sys,
                            num_accels: int) -> torch.Tensor:
    """Event simulation in plain PyTorch == ``ops.population_makespan`` on
    any device."""
    return simulate_population(accel, prio, torch.as_tensor(lat).float(),
                               torch.as_tensor(bw).float(), bw_sys,
                               num_accels)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Dense softmax attention in float32 == ``ops.flash_attention`` on any
    device.  q: (B, S, Hq, D), k/v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's
    dtype; masked logits are -1e30 and k/v heads are repeated for GQA."""
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    kr = torch.repeat_interleave(k, group, dim=2)
    vr = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kr.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    logits = logits.masked_fill(~ok[None, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vr.float())
    return out.to(q.dtype)


def ssm_scan_ref(x, dt, A, B, C):
    """Time loop in plain PyTorch == ``repro_torch.models.mamba.
    selective_scan`` == ``ops.ssm_scan`` on any device."""
    from repro_torch.models.mamba import selective_scan
    return selective_scan(x, dt, A, B, C)


def ssm_inputs(dev, seed: int, Bt: int, L: int, D: int, N: int,
               low=torch.bfloat16):
    """Seeded inputs of ``ssm_scan`` on ``dev``: x, B, C in ``low``, dt =
    softplus(normal) / 10 and A = -exp(normal / 2) in f32, as the
    reference's kernel tests draw them."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(Bt, L, D).to(low)
    dt = torch.nn.functional.softplus(normal(Bt, L, D)) * 0.1
    A = -torch.exp(normal(D, N) * 0.5)
    return x, dt, A, normal(Bt, L, N).to(low), normal(Bt, L, N).to(low)

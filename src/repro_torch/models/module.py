"""Parameters and their initialisers, on an explicit device and generator.

The JAX package builds a tree of ``Param`` leaves from a splittable key;
the port builds ``nn.Module``s whose ``nn.Parameter``s are drawn from one
``torch.Generator`` on the parameters' own device, so that a 7B model is
made on the card without crossing the bus.  On the ``meta`` device a
parameter is only a shape: that is how ``count_params`` sizes a full
model without allocating it.  Parameters are made without gradients; the
trainer (``repro_torch.train.loop.init_state``) turns them on for the
model it trains.  ``remat`` is the models' layer recompute, the port's
``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def normal_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype,
                device, stddev: float = 0.02) -> torch.Tensor:
    """Normal(0, stddev) drawn in float32, then cast to ``dtype``."""
    z = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (stddev * z).to(dtype)


def zeros_init(gen, shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(gen, shape, dtype, device) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def param(gen: Optional[torch.Generator], shape: Sequence[int], dtype, device,
          init: Optional[Callable] = None,
          stddev: float = 0.02) -> nn.Parameter:
    """One parameter: ``normal_init`` at ``stddev`` unless ``init`` is
    given, and only a shape on the ``meta`` device."""
    device = torch.device(device)
    if device.type == "meta":
        value = torch.empty(tuple(shape), dtype=dtype, device=device)
    elif init is None:
        value = normal_init(gen, shape, dtype, device, stddev)
    else:
        value = init(gen, shape, dtype, device)
    return nn.Parameter(value, requires_grad=False)


def weights_generator(device, generator: Optional[torch.Generator]
                      ) -> Optional[torch.Generator]:
    """The generator a model's weights are drawn from: ``generator``, else
    one seeded with 0 on ``device``; none on the ``meta`` device."""
    device = torch.device(device)
    if generator is not None or device.type == "meta":
        return generator
    return torch.Generator(device=device).manual_seed(0)


def remat(cfg, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward pass
    (``torch.utils.checkpoint``) when ``cfg.remat`` is set and autograd
    records."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def count_params(module: nn.Module) -> int:
    """Number of parameter elements (works on the ``meta`` device)."""
    return sum(p.numel() for p in module.parameters())

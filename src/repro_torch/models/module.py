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

Every module that holds parameters names their logical axes in a class
attribute ``AXES`` ({field: axis names}), the reference's ``Param.axes``
without the leading ``"layers"`` entry of a stacked leaf (the port keeps
one module a layer); ``param_axes`` collects them by parameter name.  The
axes are metadata only: ``repro_torch.dist.sharding`` maps them to
placements on a device mesh, and nothing that runs without a mesh reads
them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

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


Axes = Tuple[Optional[str], ...]


def param_axes(model: nn.Module) -> Dict[str, Axes]:
    """{parameter name: logical axis names} of every parameter of
    ``model``, from the ``AXES`` of the module that holds it."""
    out: Dict[str, Axes] = {}
    for name, p in model.named_parameters():
        prefix, _, field = name.rpartition(".")
        owner = model.get_submodule(prefix) if prefix else model
        axes = getattr(type(owner), "AXES", {}).get(field)
        if axes is None or len(axes) != p.dim():
            raise ValueError(f"{type(owner).__name__}.{field}: no logical "
                             f"axes for a {p.dim()}-dim parameter")
        out[name] = tuple(axes)
    return out

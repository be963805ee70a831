"""AdamW with a cosine schedule and global-norm clipping, ported from
``repro.train.optimizer`` (no ``torch.optim``: the arithmetic is the
reference's).

The API is the reference's: ``init(params) -> state``, ``update(grads,
state, params, lr) -> (updates, state)``, and the updates are added to the
params by ``apply_updates``.  Trees are dicts of tensors keyed by
parameter name.  Unlike the JAX package, ``update`` advances the moments
in place and returns them in the new state (a copy of the f32 moments of
a 2.5B-parameter model is 20 GB), and ``apply_updates`` adds in place; the
old state is not read again.  The arithmetic is done with
``torch._foreach_*`` over groups of tensors, to keep the host's op count
and the f32 temporaries small.  ``RMSProp`` (the A2C baseline's
optimizer, ``repro_torch.core.rl``) has the same API.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]
GROUP_ELEMENTS = 1 << 28      # the f32 temporaries of one group: 1 GiB each


class AdamState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d)."""
    sq = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(leaves scaled by min(1, max_norm / (norm + 1e-9)), norm).  The scale
    is float32 and so are the scaled leaves, as JAX's promotion of a bf16
    leaf times an f32 scale gives them."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


def _groups(tensors: List[torch.Tensor]) -> Iterator[slice]:
    """Consecutive slices of ``tensors`` of at most GROUP_ELEMENTS each
    (a larger tensor is a group alone)."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        if i > start and size + t.numel() > GROUP_ELEMENTS:
            yield slice(start, i)
            start, size = i, 0
        size += t.numel()
    if start < len(tensors):
        yield slice(start, len(tensors))


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's weakly typed scalars
    meet float32 arrays."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Optional[float] = None       # fixed lr; or pass one to update
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    # the moments' dtype; params may be bf16
    state_dtype: torch.dtype = torch.float32

    def init(self, params: Tree) -> AdamState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=self.state_dtype,
                                   device=p.device)
                    for k, p in params.items()}
        return AdamState(step=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: Tree, state: AdamState, params: Tree,
               lr: Optional[float] = None) -> Tuple[Tree, AdamState]:
        """(updates in each param's dtype, the advanced state).  Decay
        applies to every parameter; the step count used for the bias
        correction is the incremented one."""
        lr = self.lr if lr is None else lr
        step = state.step + 1
        b1, b2, sd = self.b1, self.b2, self.state_dtype
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(step))
        bc2 = float(one - np.float32(b2) ** np.float32(step))
        names = list(params)
        g_all = [grads[k] for k in names]
        mu_all = [state.mu[k] for k in names]
        nu_all = [state.nu[k] for k in names]
        updates: Tree = {}
        for sl in _groups(g_all):
            g = [t.to(sd) for t in g_all[sl]]
            mu, nu = mu_all[sl], nu_all[sl]
            torch._foreach_mul_(mu, _f32(b1))
            torch._foreach_add_(mu, g, alpha=_f32(1 - b1))
            torch._foreach_mul_(nu, _f32(b2))
            torch._foreach_addcmul_(nu, g, g, value=_f32(1 - b2))
            del g
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _f32(self.eps))
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, denom)
            del denom
            if self.weight_decay:
                torch._foreach_add_(u, [params[k].to(sd) for k in names[sl]],
                                    alpha=_f32(self.weight_decay))
            torch._foreach_mul_(u, -_f32(lr))
            for k, t in zip(names[sl], u):
                updates[k] = t.to(params[k].dtype)
        return updates, AdamState(step=step, mu=state.mu, nu=state.nu)


class RMSPropState(NamedTuple):
    nu: Tree


@dataclasses.dataclass(frozen=True)
class RMSProp:
    """``nu = decay * nu + (1 - decay) * g**2``, update ``-lr * g /
    (sqrt(nu) + eps)``: ``repro.train.optimizer.RMSProp``'s arithmetic,
    in float32 (the RL policies' parameters are small: no groups)."""
    lr: float = 7e-4
    decay: float = 0.99
    eps: float = 1e-5

    def init(self, params: Tree) -> RMSPropState:
        return RMSPropState(nu={k: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tree, state: RMSPropState, params=None,
               lr: Optional[float] = None) -> Tuple[Tree, RMSPropState]:
        lr = self.lr if lr is None else lr
        names = list(grads)
        g = [grads[k] for k in names]
        nu = torch._foreach_mul([state.nu[k] for k in names],
                                _f32(self.decay))
        torch._foreach_addcmul_(nu, g, g, value=_f32(1 - self.decay))
        denom = torch._foreach_sqrt(nu)
        torch._foreach_add_(denom, _f32(self.eps))
        u = torch._foreach_mul(g, -_f32(lr))
        torch._foreach_div_(u, denom)
        return dict(zip(names, u)), RMSPropState(nu=dict(zip(names, nu)))


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """params += updates, in each param's dtype, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """step -> learning rate (a float holding a float32 value): linear
    warmup from 0, then a cosine to 0 at ``total_steps``."""
    f = np.float32

    def lr(step) -> float:
        s = f(step)
        warm = f(base_lr) * s / f(max(warmup_steps, 1))
        frac = (s - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
        frac = np.clip(frac, f(0.0), f(1.0))
        cos = f(0.5 * base_lr) * (f(1.0) + np.cos(f(np.pi) * frac))
        return float(warm if s < warmup_steps else cos)
    return lr

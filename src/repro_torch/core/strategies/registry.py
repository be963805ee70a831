"""Strategy registry — the successor of the old ``m3e.METHODS`` dict.

``register`` records a named factory plus metadata (device-resident or
host-only, what paper figure it serves); ``get_strategy`` instantiates by
name with validated kwargs; ``available`` lists what exists.  Unlike the
old ``METHODS`` lambdas — which died with a bare ``KeyError`` on unknown
names and silently swallowed unsupported kwargs in ``**kw`` — unknown
names raise a ``ValueError`` listing every registered strategy, and
kwargs a factory does not accept raise a ``ValueError`` naming the
accepted ones.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.strategies.base import SearchStrategy


@dataclasses.dataclass(frozen=True)
class StrategyInfo:
    """Registry entry: how to build a strategy and what it is."""
    name: str
    factory: Callable[..., SearchStrategy]
    device_resident: bool
    description: str = ""
    figures: str = ""            # paper figure/table the strategy serves
    aliases: Tuple[str, ...] = ()


_REGISTRY: Dict[str, StrategyInfo] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, factory: Callable[..., SearchStrategy], *,
             device_resident: bool, description: str = "",
             figures: str = "", aliases: Tuple[str, ...] = (),
             overwrite: bool = False) -> None:
    """Register a strategy factory under ``name`` (plus optional aliases)."""
    if not overwrite:
        taken = [n for n in (name, *aliases)
                 if n in _REGISTRY or n in _ALIASES]
        if taken:
            raise ValueError(
                f"strategy name(s) {', '.join(map(repr, taken))} are "
                "already registered")
    else:
        # drop stale alias entries: aliases previously pointing at this
        # name, and any alias shadowing a name being (re-)registered
        # directly (aliases win in lookup, so staleness would hijack it)
        for a in [a for a, target in _ALIASES.items()
                  if target == name or a in (name, *aliases)]:
            del _ALIASES[a]
    _REGISTRY[name] = StrategyInfo(name=name, factory=factory,
                                   device_resident=device_resident,
                                   description=description, figures=figures,
                                   aliases=tuple(aliases))
    for alias in aliases:
        _ALIASES[alias] = name


def canonical_name(name: str) -> str:
    return _ALIASES.get(name, name)


def available(*, device_resident: Optional[bool] = None) -> Tuple[str, ...]:
    """Sorted registered strategy names, optionally filtered by kind."""
    return tuple(sorted(
        n for n, info in _REGISTRY.items()
        if device_resident is None or info.device_resident == device_resident))


def strategy_info(name: str) -> StrategyInfo:
    """Metadata for ``name`` (aliases resolve); ValueError when unknown."""
    key = canonical_name(name)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown strategy {name!r}; available strategies: "
            f"{', '.join(available())}")
    return _REGISTRY[key]


def get_strategy(name: str, **kwargs) -> SearchStrategy:
    """Instantiate a registered strategy, rejecting unknown kwargs.

    The factory's signature is the contract: kwargs it does not declare
    raise a ``ValueError`` naming the accepted ones (the old METHODS
    lambdas silently dropped them into ``**kw``).
    """
    info = strategy_info(name)
    sig = inspect.signature(info.factory)
    accepts_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
    if not accepts_var_kw:
        unknown = sorted(set(kwargs) - set(sig.parameters))
        if unknown:
            accepted = sorted(
                p for p, v in sig.parameters.items()
                if v.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                              inspect.Parameter.KEYWORD_ONLY))
            raise ValueError(
                f"strategy {name!r} got unknown kwarg(s) "
                f"{', '.join(map(repr, unknown))}; accepted: "
                f"{', '.join(map(repr, accepted)) or '(none)'}")
    return info.factory(**kwargs)

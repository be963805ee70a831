"""The port's stages on torch's profiler timeline.

While a ``torch.profiler`` session is active, each stage the port traces
-- a search's prepare, issue and read-back, the stream's admit, dispatch,
route and run loop, the memo's and the sweep's spans -- also enters it as
a CPU range named ``repro.<stage>``, whatever ``ObsConfig`` says, so a
device trace names what the host was doing at each of the card's idle
gaps.  No profiler active: one module attribute read, no call into the
profiler at all.

The range is ``torch._C._profiler._RecordFunctionFast``: the profiler
records it as a CPU operation, not as a user annotation.  A user-scope
range (``torch.profiler.record_function``) would also appear on the
device timeline as a CUDA-typed ``gpu_user_annotation`` event, which a
reader of the device's operations counts as device work.  A torch
without that class gets no range.

Unlike the rest of ``repro_torch.obs`` this module has no counterpart in
the reference; it imports nothing from torch until a profiler is active.
"""
from __future__ import annotations

import sys
from typing import Optional

from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer

__all__ = ["active", "mirror", "stage"]

PREFIX = "repro."


def active() -> bool:
    """Whether a torch profiler session is recording (torch's own flag;
    False while torch has not even been imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(getattr(prof, "_is_profiler_enabled",
                                             False))


def _record_function(name: str):
    """A CPU-only profiler range (the context manager) or None."""
    import torch
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return None if fast is None else fast(name)


class _Range:
    """The profiler range of one stage, with the span handle's ``set``."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rf = None

    def __enter__(self) -> "_Range":
        self._rf = _record_function(PREFIX + self.name)
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def set(self, **args) -> None:
        pass


class _Mirrored(_Range):
    """A live tracer span and its profiler range, entered together."""

    __slots__ = ("span",)

    def __init__(self, span, name: str) -> None:
        super().__init__(name)
        self.span = span

    def __enter__(self) -> "_Mirrored":
        self.span.__enter__()
        return super().__enter__()

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        return self.span.__exit__(*exc)

    def set(self, **args) -> None:
        self.span.set(**args)


def mirror(name: str):
    """The profiler range ``repro.<name>`` when a profiler is active, else
    the shared no-op handle: for host work whose span the tracer records
    later, from stamps (the stream's dispatch and route)."""
    return _Range(name) if active() else NULL_SPAN


def stage(name: str, tracer: Optional[Tracer] = None,
          scope: Optional[int] = None, **args):
    """A context manager measuring the enclosed block as ``tracer``'s
    span ``name`` (when the tracer is enabled) and as the profiler range
    ``repro.<name>`` (when a profiler is active).  Its handle takes
    ``set(**args)`` as a span's does; with neither, it is the shared
    no-op handle."""
    tracer = NULL_TRACER if tracer is None else tracer
    if not tracer.enabled:
        return mirror(name)
    span = tracer.span(name, scope=scope, **args)
    return _Mirrored(span, name) if active() else span

"""Span tracer — request-scoped timelines for the scheduling stack.

A :class:`Tracer` records :class:`Span`s (name, start, end, scenario
scope, free-form args) into a bounded ring buffer under a lock.  In the
port the schedule memo emits into one (``memo.lookup``,
``memo.warm_start``, ``memo.record``); the reference's exporters, metric
registry and flight recorder (``repro.obs``) are ROADMAP Queue 1 item 13.
The module uses the standard library only and matches
``repro.obs.trace`` line for line.

Design constraints, in order:

* **Host-side only.**  Spans wrap host-side work (lookups, dispatch
  *enqueue*, synchronisation, routing); a span around a device call
  measures the host's view of it.  Nothing here may change what bytes a
  schedule contains.
* **~zero overhead when disabled.**  ``span()`` on a disabled tracer
  returns one shared no-op context manager (no allocation), ``emit()``
  is a single attribute check.  Hot loops additionally gate their
  per-member emit loops on ``tracer.enabled``.
* **Thread-safe.**  Concurrent emitters each build their span outside
  the lock and append it whole, so readers never observe a torn record.
  Eviction is oldest-first (``dropped`` counts casualties).

Two clock conventions coexist: a caller may pass its own run-relative
clock so span timestamps line up with its results, while the
process-wide default tracer (:func:`get_tracer`) runs on a
process-epoch clock.  A trace never mixes the two.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional


class RunClock:
    """Monotonic, resettable, run-relative clock (seconds since the
    last ``reset``).  The stream service resets it at run start so span
    and result timestamps share one timeline."""

    __slots__ = ("_t0",)

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self._t0


_MODULE_CLOCK = RunClock()          # process-epoch default timeline


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span.  ``scope`` is the scenario uid (the per-
    request track in exports); ``None`` for batch/infra spans."""

    name: str
    start_s: float
    end_s: float
    scope: Optional[int] = None
    worker: str = "main"
    args: Optional[Dict] = None

    @property
    def dur_s(self) -> float:
        return self.end_s - self.start_s


class _NullSpan:
    """Shared no-op handle for disabled tracers: context manager and
    explicit-finish APIs all do nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass

    def finish(self, **args) -> None:
        pass


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Open span handle: ``with tracer.span(...)`` or explicit
    ``h = tracer.begin(...); ...; h.finish()``."""

    __slots__ = ("_tracer", "name", "scope", "args", "start_s", "_open")

    def __init__(self, tracer: "Tracer", name: str, scope: Optional[int],
                 args: Dict) -> None:
        self._tracer = tracer
        self.name = name
        self.scope = scope
        self.args = args
        self.start_s = tracer.now()
        self._open = True

    def set(self, **args) -> None:
        """Attach args discovered mid-span (e.g. memo lookup outcome)."""
        self.args.update(args)

    def finish(self, **args) -> None:
        if not self._open:      # idempotent: CM exit after manual finish
            return
        self._open = False
        if args:
            self.args.update(args)
        self._tracer.emit(self.name, self.start_s, self._tracer.now(),
                          scope=self.scope, **self.args)

    def __enter__(self) -> "_LiveSpan":
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False


class Tracer:
    """Thread-safe bounded span recorder.  See the module docstring for
    the overhead and clock conventions."""

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 worker: str = "main") -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.worker = str(worker)
        self._clock = clock if clock is not None else _MODULE_CLOCK
        self._lock = threading.Lock()
        self._spans: Deque[Span] = collections.deque()  # @locked:_lock
        self.dropped = 0                                # @locked:_lock

    def now(self) -> float:
        """Current time on this tracer's clock (emit-compatible)."""
        return self._clock()

    def emit(self, name: str, start_s: float, end_s: float,
             scope: Optional[int] = None, **args) -> None:
        """Record a completed span retroactively (used for stages whose
        boundaries are only known later, e.g. queue_wait at dispatch
        time and device occupancy at route time)."""
        if not self.enabled:
            return
        span = Span(name=name, start_s=float(start_s), end_s=float(end_s),
                    scope=scope, worker=self.worker, args=args or None)
        with self._lock:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()           # oldest-first eviction
                self.dropped += 1
            self._spans.append(span)

    def span(self, name: str, scope: Optional[int] = None, **args):
        """Context manager measuring the enclosed block.  On a disabled
        tracer this returns the shared no-op handle."""
        if not self.enabled:
            return NULL_SPAN
        return _LiveSpan(self, name, scope, args)

    def begin(self, name: str, scope: Optional[int] = None, **args):
        """Explicit-start API: returns a handle; call ``.finish()``."""
        return self.span(name, scope=scope, **args)

    def spans(self) -> List[Span]:
        """Snapshot of the buffer, oldest first."""
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[Span]:
        """Snapshot and clear in one critical section."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0


NULL_TRACER = Tracer(capacity=1, enabled=False)

_DEFAULT_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide default tracer (process-epoch clock).  Callers
    without their own tracer — ``run_rows`` chunk spans, the fleet
    router — emit here when their ``ObsConfig`` enables observability."""
    return _DEFAULT_TRACER

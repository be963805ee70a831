"""Runtime sanitizers — the port's counterpart of ``repro.lint.runtime``.

Two invariants the static pass cannot see end to end:

* **No compilation after warmup.**  The stream scheduler promises that
  after ``warmup()`` every dispatch reuses what is already built; in the
  port the things built at run time are the CUDA kernels' libraries
  (``repro_torch.kernels._build.load``: ``nvcc`` at first use, then a
  ``dlopen``), the generation step's CUDA graphs
  (``repro_torch.core.strategies.graphs``: a warm generation and a
  capture for each new shape) and, should a path use ``torch.compile``,
  dynamo's graphs.  Any of them mid-run stalls a dispatch.
  :class:`RecompileGuard` counts them all and raises, naming them, when
  any happen after ``warmup()``.

* **No hidden synchronisation on the hot path.**
  :func:`transfer_sanitizer` is the reference's scoped
  ``jax.transfer_guard("disallow")`` in PyTorch terms: inside the scope a
  call that synchronises the host with the card (a blocking copy in
  either direction, ``.item()``, ``nonzero``, a boolean-mask index, an
  explicit synchronize) raises instead of silently stalling the issue of
  device work.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["RecompileError", "RecompileGuard", "transfer_sanitizer"]


def _count_compile(label: str, post_warmup: bool) -> None:
    """Publish every observed compile to the obs registry (never raises:
    the guard runs inside the kernel loader's and dynamo's callbacks)."""
    try:
        from repro_torch.obs.registry import get_registry
        get_registry().counter(
            "repro_jit_compiles_total",
            "jit compilations observed by RecompileGuard",
        ).inc(phase="post_warmup" if post_warmup else "warmup",
              guard=label or "unlabeled")
    except Exception:
        pass


class RecompileError(RuntimeError):
    """A compilation happened inside a region that promised none."""


def _dynamo_callbacks():
    """torch's dynamo compile-callback module (its import costs ~1.5 s on
    the first guard a process enters)."""
    from torch._dynamo import callback
    return callback


def _dynamo_names() -> Dict[str, str]:
    """compile id -> compiled function name, for the dynamo compiles
    recorded so far (the metrics land after the end callback fires)."""
    try:
        from torch._dynamo.utils import get_compilation_metrics
        return {str(m.compile_id): str(m.co_name)
                for m in get_compilation_metrics()}
    except Exception:
        return {}


_DYNAMO = "torch.compile "


class RecompileGuard:
    """Context manager asserting zero compilations after warmup.

        with RecompileGuard(label="stream") as guard:
            svc.warmup(trace)
            guard.warmup()          # compiles so far were expected
            svc.run(trace)          # any compile past here raises
        # __exit__ re-checks; guard.post_warmup lists offenders

    A compile event is what ``repro_torch.kernels._build`` reports: a
    kernel library it loaded (recorded by its name, e.g. ``"makespan"``)
    or a generation step captured as a CUDA graph
    (``"cuda graph <key>"``, e.g. ``"cuda graph magma R=1 P=100 G=100
    A=8 throughput cuda:0"``) or a dynamo compile
    (``"torch.compile <id>"``).
    ``warmup()`` marks the boundary: everything compiled before it was the
    deliberate warmup, anything after is a violation.  Without a
    ``warmup()`` call the guard only observes and never raises.
    Thread-safe: loads on pool threads are counted.
    """

    def __init__(self, label: str = ""):
        self.label = label
        self.compiles: List[str] = []       # @locked:_lock
        self._boundary: Optional[int] = None   # @locked:_lock
        self._lock = threading.Lock()
        self._callbacks: List[Callable[[str, bool], None]] = []  # @locked:_lock
        self._entered = False

    def add_listener(self, fn: Callable[[str, bool], None]) -> None:
        """Register ``fn(name, post_warmup)`` to run on every recorded
        compile (the obs flight recorder hooks in here)."""
        with self._lock:
            self._callbacks.append(fn)

    # -- listener plumbing ----------------------------------------------------
    def _record_compile(self, name: str) -> None:
        with self._lock:
            self.compiles.append(name)
            post = self._boundary is not None
            callbacks = list(self._callbacks)
        _count_compile(self.label, post)
        for fn in callbacks:
            try:
                fn(name, post)
            except Exception:       # never raise into the compiler
                pass

    def _on_compile(self, name: str, seconds: float) -> None:
        self._record_compile(name)

    def _on_dynamo(self, args) -> None:
        self._record_compile(_DYNAMO + str(args.compile_id))

    def __enter__(self) -> "RecompileGuard":
        from repro_torch.kernels import _build
        _build.add_compile_listener(self._on_compile)
        _dynamo_callbacks().callback_handler.register_end_callback(
            self._on_dynamo)
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._entered:
            from repro_torch.kernels import _build
            _build.remove_compile_listener(self._on_compile)
            _dynamo_callbacks().callback_handler.remove_end_callback(
                self._on_dynamo)
            self._entered = False
        if exc_type is None:
            self.check()
        return False

    # -- the contract ---------------------------------------------------------
    def warmup(self) -> "RecompileGuard":
        """Mark the boundary: compilations so far were the warmup."""
        with self._lock:
            self._boundary = len(self.compiles)
        return self

    @property
    def warmup_compiles(self) -> List[str]:
        with self._lock:
            cut = (len(self.compiles) if self._boundary is None
                   else self._boundary)
            return list(self.compiles[:cut])

    @property
    def post_warmup(self) -> List[str]:
        """What was compiled after ``warmup()`` (the violations)."""
        with self._lock:
            if self._boundary is None:
                return []
            return list(self.compiles[self._boundary:])

    def check(self) -> None:
        """Raise :class:`RecompileError` naming everything compiled after
        ``warmup()`` (no-op before ``warmup()``)."""
        bad = self.post_warmup
        if bad:
            label = f" [{self.label}]" if self.label else ""
            fns = _dynamo_names()
            names = ", ".join(sorted(
                {f"{fns.get(b[len(_DYNAMO):], '?')} ({b})"
                 if b.startswith(_DYNAMO) else b for b in bad}))
            raise RecompileError(
                f"{len(bad)} compilation(s) after warmup{label}: {names} — "
                "a kernel library loaded for the first time, a generation "
                "step captured for a shape the warmup did not run, or a "
                "torch.compile'd function retraced (a new shape or a "
                "changed static argument)")


@contextlib.contextmanager
def transfer_sanitizer(enabled: bool = True):
    """Run the scope under ``torch.cuda.set_sync_debug_mode("error")``
    and restore the previous mode after it (no-op when disabled or when
    no card is present).

    JAX separates transfers from synchronisation: its guard disallows
    implicit transfers only, so the reference wraps both a batch's
    launch and its ``block_until_ready`` / ``device_get``.  In PyTorch
    every device-to-host copy is a synchronisation, so callers wrap the
    **dispatch** region only — the non-blocking copies of a batch to the
    card and the issue of its generation loop — and run their explicit
    wait and read-back outside the scope.  The mode is process-wide, so
    host threads that touch no CUDA tensor are unaffected.
    """
    if not enabled or not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)

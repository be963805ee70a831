"""Flight recorder — last-N events per worker, dumped on trouble.

A :class:`FlightRecorder` is a cheap always-on ring of recent pipeline
events (admits, dispatches, routes).  A copy of ``repro.obs.flight``
(standard library only).  Nothing is written anywhere in the happy path;
on an exception, a deadline miss, or a post-warmup recompile reported by
a guard hooked with :meth:`attach_guard` the rings are dumped as one
JSON file into ``dump_dir`` (or to stderr when no directory is
configured), so the question "what was the pipeline doing just before
this?" has an answer without re-running under full tracing.

Dump triggers:

* ``capture(stage)`` — context manager; dumps and re-raises on any
  exception inside the block (the stream service wraps its run loops).
* ``on_deadline_miss(...)`` — called by the router when a
  deadline-carrying schedule lands late.
* ``attach_guard(guard)`` — registers a listener on any guard with the
  ``add_listener(fn(name, post_warmup))`` hook (the port's
  ``repro_torch.lint.runtime.RecompileGuard``); any compile recorded
  after the guard's warmup boundary dumps immediately.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Deque, Dict, List, Optional


class FlightRecorder:
    """Bounded per-worker event rings + dump-on-trouble."""

    def __init__(self, max_events: int = 256,
                 dump_dir: Optional[str] = None,
                 worker: str = "main", clock=None) -> None:
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.max_events = int(max_events)
        self.dump_dir = dump_dir
        self.worker = str(worker)
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._events: Dict[str, Deque[Dict]] = {}   # @locked:_lock
        self.dumps: List[str] = []                  # @locked:_lock
        self._seq = 0                               # @locked:_lock

    def note(self, event: str, worker: Optional[str] = None,
             **fields) -> None:
        """Append one event to a worker's ring (oldest evicted)."""
        w = worker if worker is not None else self.worker
        entry = {"t": float(self._clock()), "event": event, **fields}
        with self._lock:
            ring = self._events.get(w)
            if ring is None:
                ring = collections.deque(maxlen=self.max_events)
                self._events[w] = ring
            ring.append(entry)

    def snapshot(self) -> Dict[str, List[Dict]]:
        with self._lock:
            return {w: list(ring) for w, ring in self._events.items()}

    def dump(self, reason: str, **context) -> str:
        """Write the rings out; returns the path (or ``"<stderr>"``)."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        payload = {
            "reason": reason,
            "worker": self.worker,
            "seq": seq,
            "unix_time": time.time(),
            "context": context,
            "events": self.snapshot(),
        }
        if self.dump_dir:
            os.makedirs(self.dump_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "-_" else "_"
                           for c in reason)
            path = os.path.join(
                self.dump_dir,
                f"flight_{self.worker}_{seq:03d}_{safe}.json")
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        else:
            sys.stderr.write("[flight] " + json.dumps(payload,
                                                      default=str) + "\n")
            path = "<stderr>"
        with self._lock:
            self.dumps.append(path)
        return path

    @contextlib.contextmanager
    def capture(self, stage: str):
        """Dump-and-reraise on any exception inside the block."""
        try:
            yield self
        except Exception as e:
            self.note("exception", stage=stage, error=repr(e))
            self.dump("exception", stage=stage, error=repr(e))
            raise

    def on_deadline_miss(self, uid, latency_s: float,
                         deadline_s: float) -> str:
        self.note("deadline_miss", uid=uid, latency_s=latency_s,
                  deadline_s=deadline_s)
        return self.dump("deadline_miss", uid=uid, latency_s=latency_s,
                         deadline_s=deadline_s)

    def attach_guard(self, guard) -> None:
        """Hook a recompile guard (``add_listener(fn(name,
        post_warmup))``): every compile lands in the ring; a post-warmup
        compile dumps immediately."""
        guard.add_listener(self._on_compile)

    def _on_compile(self, name: str, post_warmup: bool) -> None:
        self.note("jit_compile", executable=name, post_warmup=post_warmup)
        if post_warmup:
            self.dump("post_warmup_recompile", executable=name)


@contextlib.contextmanager
def capture(recorder: Optional[FlightRecorder], stage: str):
    """No-op variant of :meth:`FlightRecorder.capture` for call sites
    whose recorder is optional."""
    if recorder is None:
        yield None
        return
    with recorder.capture(stage):
        yield recorder

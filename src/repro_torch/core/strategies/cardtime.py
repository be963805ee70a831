"""The card's own time of each generation loop, from CUDA timing events.

``driver.scan_steps`` brackets a loop -- one search, one sweep chunk's
shard or one stream batch's shard -- with two timing events on the
loop's stream, one before the step's load and one after its unload, when
its caller hands it a list to keep the :class:`CardInterval` in.  The
caller reads the interval only where it already waits for the loop's
results (:func:`settle`, after an event query that reports done), so the
timing adds no synchronisation; the events come from a pool a device and
go back to it once read.  On the CPU there are no events, so nothing is
recorded or counted.

An interval is placed on a host clock through an *anchor*: an event
recorded while the card is idle, at a known host time (the stream
records one as each run starts); an event's host time is the anchor's
plus :func:`between` the two.

Each settled loop feeds the process registry (``repro_torch.obs``),
always on: ``repro_loop_total``, ``repro_loop_card_seconds_total``,
``repro_loop_generations_total`` and ``repro_loop_graph_nodes_total``
(the nodes of each graph the loop replayed, ``cuGraphGetNodes``'s count;
0 for a loop run eagerly).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.obs.registry import get_registry

__all__ = ["CardInterval", "begin", "end", "settle", "anchor", "between"]


def _new_event(device: torch.device):
    """A fresh timing event for ``device``, or None where there is no
    card (the CPU)."""
    if device.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True)


_LOCK = threading.Lock()
_POOL: Dict[str, List[object]] = {}      # @locked:_LOCK


def _take(device: torch.device):
    with _LOCK:
        free = _POOL.get(str(device))
        if free:
            return free.pop()
    return _new_event(device)


def _give(device: torch.device, events: Sequence[object]) -> None:
    if device.type != "cuda":
        return                  # only a card's events are kept for reuse
    with _LOCK:
        _POOL.setdefault(str(device), []).extend(events)


def _mark(device: torch.device, event):
    """``event`` recorded on ``device``'s current stream."""
    event.record(torch.cuda.current_stream(device)
                 if device.type == "cuda" else None)
    return event


class CardInterval:
    """One loop's stretch on the card: its start and end events, and the
    generations and graph nodes it ran."""

    __slots__ = ("device", "start", "end", "generations", "nodes")

    def __init__(self, device: torch.device, start) -> None:
        self.device = device
        self.start = start
        self.end = None
        self.generations = 0
        self.nodes = 0

    def done(self) -> bool:
        """Whether the card has passed the end event (no wait)."""
        return self.end is not None and bool(self.end.query())

    def seconds(self) -> float:
        """Start to end on the card; valid once :meth:`done`."""
        return between(self.start, self.end)


def begin(device: torch.device) -> Optional[CardInterval]:
    """An interval whose start event is recorded now on ``device``'s
    current stream; None on the CPU."""
    event = _take(device)
    return None if event is None else CardInterval(device,
                                                   _mark(device, event))


def end(interval: CardInterval, generations: int, nodes: int
        ) -> CardInterval:
    """Record ``interval``'s end event now, with the loop's generations
    and replayed graph nodes."""
    interval.end = _mark(interval.device, _take(interval.device))
    interval.generations, interval.nodes = int(generations), int(nodes)
    return interval


def settle(intervals: Sequence[CardInterval]) -> Optional[float]:
    """The card seconds of the ``intervals`` the card has finished,
    counted into the registry, their events back in the pool; None when
    none had finished.  Call it where the host has already waited for the
    loops: the end events are queried, never waited on."""
    total, n = 0.0, 0
    for iv in intervals:
        if not iv.done():
            continue
        s = iv.seconds()
        total += s
        n += 1
        reg = get_registry()
        reg.counter("repro_loop_total",
                    "Generation loops timed on the card").inc()
        reg.counter("repro_loop_card_seconds_total",
                    "Card seconds of the timed generation loops").inc(s)
        reg.counter("repro_loop_generations_total",
                    "Generations of the timed generation loops").inc(
                        iv.generations)
        reg.counter("repro_loop_graph_nodes_total",
                    "CUDA graph nodes the timed loops replayed").inc(
                        iv.nodes)
        _give(iv.device, (iv.start, iv.end))
        iv.start = iv.end = None          # settled once
    return total if n else None


def anchor(device: torch.device):
    """An event recorded now on ``device``'s current stream (for an
    anchor: record it while the card is idle and note the host time);
    None on the CPU."""
    event = _new_event(device)
    return None if event is None else _mark(device, event)


def between(a, b) -> float:
    """Seconds on the card from event ``a`` to event ``b`` (both
    finished)."""
    return a.elapsed_time(b) / 1e3

"""Reading the device out of a ``torch.profiler`` trace.

The benchmark profiles a short steady stretch after its window, never
the window itself: a search replays a CUDA graph of ~12,000 nodes, and
the profiler's records of every node stretch the wall it sees.  Kernel
intervals and counts are sound (their durations read 1-2% long under
the profiler); the profiled wall is not, so the idle shares the
benchmark reports set kernel intervals against the unprofiled window.
"""
from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

# the CUDA runtime and driver calls that put work on the device
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
               "cudaMemcpyAsync", "cudaMemsetAsync")


class Op(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Profile(NamedTuple):
    device: List[Op]       # device operations, by start
    host: List[Op]         # host operations (empty unless asked for)
    wall_s: float          # the profiled stretch (stretched by the profiler)


def profile(fn: Callable[[], object], host: bool = False) -> Profile:
    """``fn()`` under ``torch.profiler`` with the card's activity (and the
    host's with ``host``), ending in a device synchronisation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, cpu = [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        (dev if e.device_type == DeviceType.CUDA else cpu).append(op)
    dev.sort(key=lambda o: o.start_us)
    cpu.sort(key=lambda o: o.start_us)
    return Profile(dev, cpu, wall)


def busy_s(ops: Sequence[Op]) -> float:
    """Seconds in which at least one of ``ops`` ran (their union)."""
    total, end = 0.0, float("-inf")
    for o in sorted(ops, key=lambda o: o.start_us):
        if o.end_us <= end:
            continue
        total += o.end_us - max(o.start_us, end)
        end = o.end_us
    return total * 1e-6


def top_ops(ops: Sequence[Op], n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` operation names that took most device seconds."""
    by: Dict[str, float] = {}
    for o in ops:
        by[o.name] = by.get(o.name, 0.0) + (o.end_us - o.start_us) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def idle_gaps(dev: Sequence[Op], host: Sequence[Op], n: int = 10
              ) -> List[Tuple[str, float]]:
    """The device's idle gaps between its first and last operation,
    summed by what the host was doing at each gap's middle (the innermost
    host operation there), the ``n`` largest."""
    host = sorted(host, key=lambda h: h.start_us)
    by: Dict[str, float] = {}
    # the gaps' middles only grow: a host op that has ended before one
    # middle covers none after it, so the heap (latest start on top)
    # drops it for good
    running: List[Tuple[float, int]] = []
    nxt, end = 0, None
    for o in sorted(dev, key=lambda o: o.start_us):
        if end is not None and o.start_us > end:
            mid = (end + o.start_us) / 2
            while nxt < len(host) and host[nxt].start_us <= mid:
                heapq.heappush(running, (-host[nxt].start_us, nxt))
                nxt += 1
            while running and host[running[0][1]].end_us < mid:
                heapq.heappop(running)
            name = (host[running[0][1]].name if running
                    else "host outside any recorded op")
            by[name] = by.get(name, 0.0) + (o.start_us - end) * 1e-6
        end = o.end_us if end is None else max(end, o.end_us)
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def launches(host: Sequence[Op]) -> int:
    """Host calls that put work on the device."""
    return sum(o.name in LAUNCH_APIS for o in host)


def split_batches(dev: Sequence[Op], per_batch: int,
                  kernel: str = "makespan") -> List[List[Op]]:
    """Device operations of back-to-back batches, each of which launches
    ``kernel`` exactly ``per_batch`` times: the ops between the last such
    launch of one batch and the first of the next go to the one or the
    other at the widest idle gap between them."""
    ops = sorted(dev, key=lambda o: o.start_us)
    marks = [i for i, o in enumerate(ops) if kernel in o.name]
    if not marks or len(marks) % per_batch:
        raise ValueError(f"{len(marks)} {kernel} launches do not make "
                         f"whole batches of {per_batch}")
    cuts = [0]
    for b in range(per_batch, len(marks), per_batch):
        lo, hi = marks[b - 1], marks[b]           # last of b-1, first of b
        gaps = [(ops[i + 1].start_us - ops[i].end_us, i + 1)
                for i in range(lo, hi)]
        cuts.append(max(gaps)[1])
    cuts.append(len(ops))
    return [ops[a:b] for a, b in zip(cuts, cuts[1:])]

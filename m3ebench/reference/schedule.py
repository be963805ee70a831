"""Plain NumPy reference of what a mapping is worth: the job analysis
table, the genome decode (Section IV-A), the BW-allocator event
simulation (Algorithm 1) and a no-contention lower bound on the makespan.

Nothing here imports the program.  ``tables`` profiles a job group with
the frozen cost model; ``decode`` turns (accel, prio) genomes into
per-sub-accelerator queues; ``makespans`` simulates many schedules at once
in float64 (or in a lower precision, for the control); ``lower_bound``
is what no mapping can beat.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from m3ebench.reference.costmodel import (BW_FLOOR, Layer, SubAccel,
                                          profile)

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class Tables:
    """lat[g, a] no-stall latency (s), bw[g, a] required bandwidth (B/s),
    flops the group's total."""
    lat: np.ndarray
    bw: np.ndarray
    flops: float


def scale_batch(jobs: Sequence[Layer], batch_scale: int) -> list:
    """A tenant's mini-batch multiplier on every job: in N for
    convolutions, in the GEMM's M (Y) for FC jobs."""
    if batch_scale == 1:
        return list(jobs)
    return [dataclasses.replace(j, Y=j.Y * batch_scale) if j.kind == "fc"
            else dataclasses.replace(j, N=j.N * batch_scale) for j in jobs]


def tables(jobs: Sequence[Layer], subs: Sequence[SubAccel],
           cache: Dict | None = None) -> Tables:
    """The job analysis table of ``jobs`` on ``subs``; ``cache`` keeps
    profiles across groups (the cost model is pure)."""
    cache = {} if cache is None else cache
    G, A = len(jobs), len(subs)
    lat = np.empty((G, A))
    bw = np.empty((G, A))
    for g, job in enumerate(jobs):
        for a, sub in enumerate(subs):
            key = (job, sub)
            if key not in cache:
                cache[key] = profile(job, sub)
            lat[g, a], bw[g, a] = cache[key]
    return Tables(lat, bw, float(sum(j.flops for j in jobs)))


def decode(accel: np.ndarray, prio: np.ndarray, num_accels: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, G) genomes -> (queue (N, A, G) job ids, count (N, A)): queue
    ``a`` holds the jobs mapped to ``a`` by ascending priority, ties by
    job id; slots past ``count`` are -1."""
    accel = np.asarray(accel, dtype=np.int64)
    prio = np.asarray(prio, dtype=np.float32)
    N, G = accel.shape
    if accel.min(initial=0) < 0 or accel.max(initial=0) >= num_accels:
        raise ValueError("an accel gene lies outside [0, A)")
    ids = np.broadcast_to(np.arange(G), (N, G))
    order = np.lexsort((ids, prio, accel), axis=1)          # (N, G)
    count = np.stack([(accel == a).sum(axis=1) for a in range(num_accels)],
                     axis=1)
    start = np.cumsum(count, axis=1) - count
    queue = np.full((N, num_accels, G), -1, dtype=np.int64)
    slot = np.arange(G)
    for a in range(num_accels):
        valid = slot[None, :] < count[:, a:a + 1]
        pos = np.minimum(start[:, a:a + 1] + slot[None, :], G - 1)
        queue[:, a, :] = np.where(valid, np.take_along_axis(order, pos, 1),
                                  -1)
    return queue, count


def to_bfloat16(x) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even), held in
    float32: the control's precision."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def makespans(queue: np.ndarray, count: np.ndarray, lat: np.ndarray,
              bw: np.ndarray, bw_sys: np.ndarray, rnd=None) -> np.ndarray:
    """(N,) makespans of N decoded schedules; schedule n reads the
    tables ``lat[n]`` / ``bw[n]`` ((N, G, A)) and ``bw_sys[n]``.

    Each sub-accelerator runs its queue in order; the live jobs' requests
    are summed and, over ``bw_sys``, scaled down in proportion; a job's
    work is its no-stall latency times its request in bytes, drained at
    its allocation.  One job finishes per event (the earliest), so G
    events simulate G jobs.  Float64; ``rnd`` (e.g. :func:`to_bfloat16`)
    rounds the inputs and every operation's result, for a lower
    precision."""
    r = rnd or (lambda x: np.asarray(x, dtype=np.float64))
    N, A, G = queue.shape
    req_bw = np.maximum(np.asarray(bw, dtype=np.float64), BW_FLOOR)
    work = r(r(lat) * r(req_bw))
    req_bw = r(req_bw)
    bw_sys = r(np.broadcast_to(np.asarray(bw_sys, np.float64), (N,)))
    rows = np.arange(N)[:, None]
    accs = np.arange(A)[None, :]

    def pick(table, ptr):
        job = np.take_along_axis(queue, np.minimum(ptr, G - 1)[:, :, None],
                                 2)[..., 0]
        return table[rows, np.maximum(job, 0), accs]

    ptr = np.zeros((N, A), dtype=np.int64)
    rem = r(np.where(ptr < count, pick(work, ptr), 0.0))
    t = r(np.zeros(N))
    for _ in range(G):
        active = ptr < count
        req = r(np.where(active, pick(req_bw, ptr), 0.0))
        total = r(req.sum(axis=1))
        scale = r(np.minimum(r(bw_sys / np.maximum(total, _TINY)), 1.0))
        alloc = r(req * scale[:, None])
        with np.errstate(divide="ignore", invalid="ignore"):
            runtime = np.where(active, r(rem / np.maximum(alloc, _TINY)),
                               np.inf)
        live = active.any(axis=1)
        fin = runtime.argmin(axis=1)
        dt = np.where(live, runtime[np.arange(N), fin], 0.0)
        rem = r(np.maximum(r(rem - r(dt[:, None] * alloc)), 0.0))
        done = (accs == fin[:, None]) & live[:, None]
        ptr = ptr + done
        rem = np.where(done, np.where(ptr < count, pick(work, ptr), 0.0),
                       rem)
        t = r(t + dt)
    return np.asarray(t, dtype=np.float64)


def lower_bound(lat: np.ndarray, bw: np.ndarray, bw_sys) -> np.ndarray:
    """A makespan no mapping can beat, for (..., G, A) tables: the larger
    of (1) every job at its fastest, spread evenly over the A
    sub-accelerators, (2) the slowest job at its fastest, and (3) every
    job's least work in bytes through the shared ``bw_sys`` (allocations
    never sum above it, and a job drains its bytes at its allocation)."""
    lat = np.asarray(lat, dtype=np.float64)
    work = lat * np.maximum(np.asarray(bw, dtype=np.float64), BW_FLOOR)
    fastest = lat.min(axis=-1)
    A = lat.shape[-1]
    return np.maximum.reduce([fastest.sum(axis=-1) / A, fastest.max(axis=-1),
                              work.min(axis=-1).sum(axis=-1)
                              / np.asarray(bw_sys, dtype=np.float64)])

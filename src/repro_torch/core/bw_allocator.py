"""BW Allocator — Algorithm 1 of the paper, over a whole population.

Event-driven simulation of one group of jobs executing on A sub-accelerators
that share the system bandwidth:

  - each sub-accelerator runs its queue in priority order;
  - at any instant the live jobs' *required* BWs are summed; if they exceed
    the system BW every job is throttled proportionally
    (``alloc = req * BW_sys / sum(req)``), otherwise each gets its request;
  - a job's remaining work is measured in bytes (no-stall latency x required
    BW, the paper's ``CurJobs``); it completes when its bytes drain at the
    allocated rate — so with full allocation its runtime is exactly the
    no-stall latency;
  - on every completion the allocation is recomputed (one event per step).

Exactly one job finishes per event step, so ``G`` steps simulate a group of
``G`` jobs; ties drain in consecutive zero-dt steps.

``simulate_tables`` is the plain PyTorch version of the CUDA makespan kernel
(``repro_torch.kernels.makespan``): a Python loop over the ``G`` events on
dense (P, A) tensors.  ``simulate_numpy`` is the float64 oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import DecodedSchedule, decode

_BW_FLOOR = 1e-3    # bytes/s; keeps rem/alloc well-defined
_TINY = 1e-30


def queue_tables(sched: DecodedSchedule, lat: torch.Tensor,
                 bw: torch.Tensor):
    """Gather per-queue-slot (latency, bw) tables, (P, A, G) each:
    ``q*[p, a, i] = table[queue[p, a, i], a]``, with the BW floor applied."""
    A = sched.queue.shape[1]
    acc = torch.arange(A, device=lat.device)[None, :, None]
    queue = sched.queue.long()
    qlat = lat.T[acc, queue]
    qbw = bw.T[acc, queue]
    return qlat, torch.clamp_min(qbw, _BW_FLOOR)


def simulate_tables(qlat: torch.Tensor, qbw: torch.Tensor,
                    count: torch.Tensor, bw_sys) -> torch.Tensor:
    """(P,) makespans from dense queue tables: qlat/qbw (P, A, G) f32,
    count (P, A) int32.  Every per-event quantity is a dense (P, A)
    tensor; the loop runs the ``G`` events."""
    P, A, G = qlat.shape
    qbytes = qlat * qbw                  # remaining work, paper's CurJobs
    iota_a = torch.arange(A, device=qlat.device)[None, :]

    def pick(q, ptr):
        return torch.gather(q, 2, torch.clamp_max(ptr, G - 1)[:, :, None]
                            .long())[..., 0]

    ptr = torch.zeros((P, A), dtype=torch.int32, device=qlat.device)
    rem = torch.where(ptr < count, pick(qbytes, ptr), 0.0)
    t = torch.zeros((P,), dtype=torch.float32, device=qlat.device)
    for _ in range(G):
        active = ptr < count
        req = torch.where(active, pick(qbw, ptr), 0.0)
        total = req.sum(dim=1)
        scale = torch.clamp_max(bw_sys / torch.clamp_min(total, _TINY), 1.0)
        alloc = req * scale[:, None]
        runtime = torch.where(active, rem / torch.clamp_min(alloc, _TINY),
                              float("inf"))
        any_active = active.any(dim=1)
        low, fin = runtime.min(dim=1)
        dt = torch.where(any_active, low, 0.0)
        rem = torch.clamp_min(rem - dt[:, None] * alloc, 0.0)
        fin_oh = (iota_a == fin[:, None]) & any_active[:, None]
        ptr = ptr + fin_oh.int()
        nxt = torch.where(ptr < count, pick(qbytes, ptr), 0.0)
        rem = torch.where(fin_oh, nxt, rem)
        t = t + dt
    return t


def simulate_population(accel: torch.Tensor, prio: torch.Tensor,
                        lat: torch.Tensor, bw: torch.Tensor, bw_sys,
                        num_accels: int) -> torch.Tensor:
    """(P,) makespans for a whole population, in plain PyTorch."""
    sched = decode(accel, prio, num_accels)
    qlat, qbw = queue_tables(sched, lat.float(), bw.float())
    return simulate_tables(qlat, qbw, sched.count, bw_sys)


# ---------------------------------------------------------------------------
# float64 host oracle
# ---------------------------------------------------------------------------
def simulate_numpy(queues, lat, bw, bw_sys) -> float:
    """Reference event simulation.

    queues: list (len A) of job-id lists in execution order.
    lat/bw: (G, A) float64 job-analysis arrays.
    """
    lat = np.asarray(lat, dtype=np.float64)
    bw = np.maximum(np.asarray(bw, dtype=np.float64), _BW_FLOOR)
    A = len(queues)
    ptr = [0] * A
    rem = np.zeros(A)
    req = np.zeros(A)
    active = np.zeros(A, dtype=bool)
    for a in range(A):
        if queues[a]:
            j = queues[a][0]
            rem[a] = lat[j, a] * bw[j, a]
            req[a] = bw[j, a]
            active[a] = True
            ptr[a] = 1
    t = 0.0
    while active.any():
        live_req = np.where(active, req, 0.0)
        total = live_req.sum()
        scale = min(1.0, bw_sys / total) if total > 0 else 1.0
        alloc = live_req * scale
        with np.errstate(divide="ignore", invalid="ignore"):
            runtime = np.where(active, rem / np.maximum(alloc, _TINY), np.inf)
        dt = runtime.min()
        t += dt
        rem = np.maximum(rem - dt * alloc, 0.0)
        for a in range(A):
            if active[a] and rem[a] <= 1e-12 * max(1.0, dt * alloc[a]):
                if ptr[a] < len(queues[a]):
                    j = queues[a][ptr[a]]
                    rem[a] = lat[j, a] * bw[j, a]
                    req[a] = bw[j, a]
                    ptr[a] += 1
                else:
                    active[a] = False
                    rem[a] = 0.0
                    req[a] = 0.0
    return t


def throughput(total_flops, makespan: torch.Tensor) -> torch.Tensor:
    """Objective (Section IV-C): group FLOPs per second."""
    return total_flops / torch.clamp_min(makespan, _TINY)

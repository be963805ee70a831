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


# lint: dispatch
def queue_tables(sched: DecodedSchedule, lat: torch.Tensor,
                 bw: torch.Tensor):
    """Gather per-queue-slot (latency, bw) tables, (N, A, G) each:
    ``q*[n, a, i] = table[queue[n, a, i], a]``, with the BW floor applied.

    ``lat``/``bw`` are one scenario's (G, A) tables, or R scenarios'
    (R, G, A) with ``N % R == 0``: the schedules are then R rows of
    ``N // R``, and row r reads scenario r's tables."""
    N, A, _ = sched.queue.shape
    acc = torch.arange(A, device=lat.device)[None, :, None]
    queue = sched.queue.long()
    if lat.dim() == 2:
        qlat = lat.T[acc, queue]
        qbw = bw.T[acc, queue]
    else:
        R = lat.shape[0]
        row = (torch.arange(N, device=lat.device) // (N // R))[:, None, None]
        qlat = lat.transpose(1, 2)[row, acc, queue]
        qbw = bw.transpose(1, 2)[row, acc, queue]
    return qlat, torch.clamp_min(qbw, _BW_FLOOR)


# lint: dispatch
def per_individual(bw_sys, n: int):
    """``bw_sys`` as the simulators take it: a float or a one-element
    tensor stays one value; an ``(R,)`` tensor with ``n % R == 0`` gives
    each of the R rows of ``n // R`` individuals its row's value, as an
    ``(n,)`` tensor."""
    if not isinstance(bw_sys, torch.Tensor) or bw_sys.numel() == 1:
        return bw_sys.reshape(()) if isinstance(bw_sys, torch.Tensor) \
            else bw_sys
    R = bw_sys.numel()
    if bw_sys.dim() != 1 or n % R:
        raise ValueError(f"bw_sys must be one value or (R,) with R "
                         f"dividing the population {n}; got "
                         f"{tuple(bw_sys.shape)}")
    return torch.repeat_interleave(bw_sys, n // R)


# lint: dispatch
def simulate_tables(qlat: torch.Tensor, qbw: torch.Tensor,
                    count: torch.Tensor, bw_sys) -> torch.Tensor:
    """(N,) makespans from dense queue tables: qlat/qbw (N, A, G) f32,
    count (N, A) int32, ``bw_sys`` one value or one per row (see
    :func:`per_individual`).  Every per-event quantity is a dense (N, A)
    tensor; the loop runs the ``G`` events."""
    P, A, G = qlat.shape
    bw_sys = per_individual(bw_sys, P)
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
    """Makespans of a population, in plain PyTorch: accel/prio (P, G)
    with (G, A) tables give (P,); (R, P, G) with (R, G, A) tables and
    ``bw_sys`` one value or (R,) give (R, P)."""
    lead = accel.shape[:-1]
    G = accel.shape[-1]
    sched = decode(accel.reshape(-1, G), prio.reshape(-1, G), num_accels)
    qlat, qbw = queue_tables(sched, lat.float(), bw.float())
    return simulate_tables(qlat, qbw, sched.count, bw_sys).reshape(lead)


def simulate_decoded(sched: DecodedSchedule, lat: torch.Tensor,
                     bw: torch.Tensor, bw_sys) -> torch.Tensor:
    """Makespan (seconds, f32, 0-d) of one decoded schedule: queue (A, G),
    count (A,)."""
    one = DecodedSchedule(queue=sched.queue[None], count=sched.count[None])
    qlat, qbw = queue_tables(one, lat.float(), bw.float())
    return simulate_tables(qlat, qbw, one.count, bw_sys)[0]


def simulate(accel: torch.Tensor, prio: torch.Tensor, lat: torch.Tensor,
             bw: torch.Tensor, bw_sys, num_accels: int) -> torch.Tensor:
    """Makespan (0-d) of one *encoded* individual: accel/prio (G,)."""
    return simulate_population(accel[None], prio[None], lat, bw, bw_sys,
                               num_accels)[0]


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

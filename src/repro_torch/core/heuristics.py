"""Manual-tuned baseline mappers: Herald-like and AI-MT-like (Table IV).

These reimplement the *strategies* of the cited works as the paper uses
them ("-like"):

Herald-like (heterogeneous-aware greedy, after Herald's layer scheduler):
  jobs are taken largest-compute-first; each is placed on the
  sub-accelerator with the earliest estimated finish time given its
  per-core affinity (no-stall latency on that core).  Orders within a core
  follow assignment order.  Greedy EFT load-balancing is exactly the kind
  of hand heuristic Herald applies to hetero cores; it ignores the shared
  system BW — which is why MAGMA beats it when BW is scarce (Fig. 15).

AI-MT-like (homogeneous multi-array heuristic, after AI-MT):
  AI-MT's core idea is to pair memory-intensive layer blocks with
  compute-intensive ones so prefetches hide behind compute.  The jobs are
  split around the median required-BW; cores round-robin over an
  alternating high-BW/low-BW stream (preserving each model's layer order,
  as AI-MT's dependency-aware scheduler would).  It assumes homogeneous
  cores — on heterogeneous settings it degrades sharply (Fig. 9), because
  it never accounts for per-core affinity.

The greedy runs on the host in numpy, as in ``repro.core.heuristics``;
its one fitness evaluation runs on the fitness' device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.job_analyzer import JobAnalysisTable
from repro_torch.core.fitness import FitnessFn
from repro_torch.core.magma import SearchResult


def _result(fitness_fn: FitnessFn, accel: np.ndarray, prio: np.ndarray,
            t0: float) -> SearchResult:
    """The one schedule's fitness, evaluated on the fitness' device."""
    dev = fitness_fn.device
    f = float(fitness_fn(torch.as_tensor(accel[None], device=dev),
                         torch.as_tensor(prio[None], device=dev))[0].cpu())
    return SearchResult(best_fitness=f, best_accel=accel, best_prio=prio,
                        history_samples=np.array([1]),
                        history_best=np.array([f]), n_samples=1,
                        wall_time_s=time.perf_counter() - t0)


def herald_like(fitness_fn: FitnessFn) -> SearchResult:
    t0 = time.perf_counter()
    table: JobAnalysisTable = fitness_fn.table
    G, A = table.group_size, table.num_accels
    order = np.argsort(-table.flops)           # largest compute first
    finish = np.zeros(A)
    accel = np.zeros(G, dtype=np.int32)
    prio = np.zeros(G, dtype=np.float32)
    for rank, g in enumerate(order):
        eft = finish + table.lat[g]             # earliest finish w/ affinity
        a = int(np.argmin(eft))
        accel[g] = a
        finish[a] = eft[a]
        prio[g] = rank / G                      # assignment order
    return _result(fitness_fn, accel, prio, t0)


def ai_mt_like(fitness_fn: FitnessFn) -> SearchResult:
    t0 = time.perf_counter()
    table: JobAnalysisTable = fitness_fn.table
    G, A = table.group_size, table.num_accels
    # BW intensity on a representative (first) core: AI-MT assumes homogeneity
    bw0 = table.bw[:, 0]
    med = np.median(bw0)
    hi = [g for g in range(G) if bw0[g] > med]     # memory-intensive
    lo = [g for g in range(G) if bw0[g] <= med]    # compute-intensive
    # alternate hi/lo so memory blocks overlap compute blocks
    stream = []
    for i in range(max(len(hi), len(lo))):
        if i < len(hi):
            stream.append(hi[i])
        if i < len(lo):
            stream.append(lo[i])
    accel = np.zeros(G, dtype=np.int32)
    prio = np.zeros(G, dtype=np.float32)
    for rank, g in enumerate(stream):
        accel[g] = rank % A                        # round-robin cores
        prio[g] = rank / G
    return _result(fitness_fn, accel, prio, t0)

"""Shared machinery for the black-box baseline optimizers (Table IV).

All baselines operate on a continuous vector x in [0,1]^{2G}; the first G
dims decode to the accel-selection genome (floor(x*A)) and the last G to the
priority genome — the same search space MAGMA explores with its discrete
encoding.  The optimizers' arithmetic and random numbers are numpy on the
host, as in ``repro.core.optimizers``; their fitness batches go to the
``FitnessFn``'s device (the makespan kernel on a card).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.fitness import FitnessFn
from repro_torch.core.magma import SearchResult


def decode_x(X: np.ndarray, num_accels: int):
    """(P, 2G) continuous -> (accel int32 (P,G), prio float32 (P,G))."""
    X = np.clip(X, 0.0, 1.0 - 1e-7)
    G = X.shape[1] // 2
    accel = np.minimum((X[:, :G] * num_accels).astype(np.int32), num_accels - 1)
    prio = X[:, G:].astype(np.float32)
    return accel, prio


def eval_x(fitness_fn: FitnessFn, X: np.ndarray) -> np.ndarray:
    """Fitness of a (P, 2G) host batch, evaluated on the fitness' device;
    a writable host copy."""
    accel, prio = decode_x(X, fitness_fn.num_accels)
    dev = fitness_fn.device
    fit = fitness_fn(torch.as_tensor(accel, device=dev),
                     torch.as_tensor(prio, device=dev))
    return np.array(torch.as_tensor(fit).cpu())


class Recorder:
    """Tracks best-so-far vs cumulative samples (for convergence curves)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.samples = 0
        self.best = -np.inf
        self.best_x = None
        self.hist_s, self.hist_b = [], []

    def record(self, X: np.ndarray, fits: np.ndarray):
        self.samples += len(fits)
        i = int(np.argmax(fits))
        if fits[i] > self.best:
            self.best = float(fits[i])
            self.best_x = np.array(X[i])
        self.hist_s.append(self.samples)
        self.hist_b.append(self.best)

    def result(self, num_accels: int) -> SearchResult:
        accel, prio = decode_x(self.best_x[None], num_accels)
        return SearchResult(
            best_fitness=self.best,
            best_accel=accel[0], best_prio=prio[0],
            history_samples=np.asarray(self.hist_s),
            history_best=np.asarray(self.hist_b),
            n_samples=self.samples,
            wall_time_s=time.perf_counter() - self.t0,
        )

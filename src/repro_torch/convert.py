"""Carry state across from ``repro``: its scenario tables and populations,
handed over as numpy arrays, become this package's tensors on ``device``.

In this system the "weights" are the scenario tables (``FitnessParams``)
and the GA population, so these two functions are what lets both packages
compute on the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoding import Population
from repro_torch.core.fitness import FitnessParams


def fitness_params_from_numpy(lat, bw, bw_sys, flops, energy, objective_code,
                              device) -> FitnessParams:
    """``FitnessParams`` from the arrays of ``repro.core.fitness.
    FitnessParams`` (f32 tables, f32 scalars, i32 code or code vector)."""
    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32),
                               device=device)

    return FitnessParams(
        lat=f32(lat), bw=f32(bw), bw_sys=f32(bw_sys), flops=f32(flops),
        energy=f32(energy),
        objective_code=torch.as_tensor(np.array(objective_code,
                                                  dtype=np.int32),
                                       device=device))


def population_from_numpy(accel, prio, device) -> Population:
    """``Population`` from (P, G) accel (int32) and prio (float32) arrays."""
    return Population(
        accel=torch.as_tensor(np.array(accel, dtype=np.int32),
                              device=device),
        prio=torch.as_tensor(np.array(prio, dtype=np.float32),
                             device=device))

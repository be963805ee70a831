"""Plain PyTorch versions of the kernels (the tests' source of truth).

Each is the straightforward dense implementation of its kernel's contract,
written for clarity over speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.bw_allocator import simulate_population


def population_makespan_ref(accel, prio, lat, bw, bw_sys,
                            num_accels: int) -> torch.Tensor:
    """Event simulation in plain PyTorch == ``ops.population_makespan`` on
    any device."""
    return simulate_population(accel, prio, torch.as_tensor(lat).float(),
                               torch.as_tensor(bw).float(), bw_sys,
                               num_accels)

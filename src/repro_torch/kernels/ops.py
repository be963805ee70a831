"""Public wrappers around the kernels.

``population_makespan`` is the M3E fitness hot loop: genome decode and the
table gather run in PyTorch, and the event simulation in the makespan
kernel (``repro_torch.kernels.makespan``), which takes CUDA tensors to the
hand-written kernel and CPU tensors to the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.bw_allocator import queue_tables
from repro_torch.core.encoding import decode
from repro_torch.kernels.makespan import makespan


def population_makespan(accel: torch.Tensor, prio: torch.Tensor,
                        lat: torch.Tensor, bw: torch.Tensor, bw_sys,
                        num_accels: int) -> torch.Tensor:
    """(P,) makespans of a population.

    accel: (P, G) int32, prio: (P, G) f32, lat/bw: (G, A) job tables,
    bw_sys: float or one-element tensor on the genomes' device."""
    sched = decode(accel, prio, num_accels)
    qlat, qbw = queue_tables(sched, lat.float(), bw.float())
    return makespan(qlat.contiguous(), qbw.contiguous(), sched.count, bw_sys)

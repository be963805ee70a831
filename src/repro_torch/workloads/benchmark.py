"""Task benchmark builder — dependency-free job groups (Section III).

A *job* is a mini-batch of one layer of one tenant model.  The host-side
control program chops the queue of jobs into dependency-free *groups*; jobs
within a group may be freely reordered (multi-tenancy + mini-batch
independence, per AI-MT's observation cited in the paper).

The benchmark interleaves jobs from all of a task's models round-robin,
which both mimics the multi-tenant arrival pattern and guarantees each group
mixes models (the situation MAGMA exploits).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence

import numpy as np

from repro_torch.costmodel.layers import LayerDesc
from repro_torch.workloads.models import TASK_MODELS, model_layers


@dataclasses.dataclass(frozen=True)
class Job:
    uid: int
    model: str
    layer: LayerDesc

    @property
    def flops(self) -> int:
        return self.layer.flops


@dataclasses.dataclass(frozen=True)
class JobGroup:
    task: str
    jobs: tuple

    def __len__(self) -> int:
        return len(self.jobs)

    @property
    def total_flops(self) -> float:
        return float(sum(j.flops for j in self.jobs))


def build_task_groups(task: str, group_size: int = 100, num_groups: int = 1,
                      seed: int = 0) -> List[JobGroup]:
    """Round-robin interleave the task's model layers into groups.

    Different ``seed`` values rotate each model's starting layer, yielding
    distinct-but-same-distribution groups (used by the warm-start study).
    """
    models = TASK_MODELS[task]
    rng = np.random.default_rng(seed)
    streams = []
    for m in models:
        layers = model_layers(m)
        start = int(rng.integers(0, len(layers)))
        streams.append((m, itertools.cycle(layers[start:] + layers[:start])))

    groups, uid = [], 0
    for _ in range(num_groups):
        jobs = []
        for i in range(group_size):
            m, stream = streams[i % len(streams)]
            jobs.append(Job(uid, m, next(stream)))
            uid += 1
        groups.append(JobGroup(task, tuple(jobs)))
    return groups


def jobs_flops(jobs: Sequence[Job]) -> np.ndarray:
    return np.array([j.flops for j in jobs], dtype=np.float64)

"""Warm-start engine (Section V-C) — a thin client of ``repro_torch.memo``.

Caches the converged population per *task type* (Vision / Lang / Recom /
Mix).  When a new group of the same type arrives, the cached population —
re-randomized only in priorities' low bits to preserve diversity —
replaces random initialization.  Table V: Trf-0-ep alone recovers most of
a full optimization; Trf-1-ep ~ 93% of it.

Transfer is valid across groups because groups of the same task type share
the (model, layer)-distribution even though the concrete jobs differ; the
accel-selection genome encodes "which kind of job goes to which kind of
core", which is the transferable knowledge.

Populations live as records in a :class:`repro_torch.memo.MemoStore`
(pass one backed by a directory to keep warm-start knowledge across
processes); the task-type string is the record's transfer *family*, and
lookup takes the family's most recently remembered population of the
right group size (the legacy last-write-wins behavior).  The full
generalization — scenario-table features, exact-hit replay, seeding in
the strategy's ``init`` — is ``repro_torch.memo.ScheduleMemo``
(``M3E(memo=...)``).

Seed discipline: ``init_population`` is a pure function of (the
generator's state, the stored population) — the jitter is drawn from the
caller's generator, so the same seed always yields the same warm-started
population.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import Population, to_host
from repro_torch.core.strategies.base import seed_population
from repro_torch.memo.store import MemoRecord, MemoStore


def _family(task_type: str) -> Tuple:
    return ("warmstart", str(task_type))


class WarmStartEngine:
    def __init__(self, jitter: float = 0.02,
                 store: Optional[MemoStore] = None):
        self.store = store if store is not None else MemoStore()
        self.jitter = jitter

    def remember(self, task_type: str, population) -> None:
        """Store a converged ``(accel, prio)`` population (tensors on any
        device or host arrays) under ``task_type``."""
        accel, prio = population[:2]
        if isinstance(accel, torch.Tensor):
            accel, prio = to_host(accel, prio)
        accel, prio = np.asarray(accel), np.asarray(prio)
        # content-addressed like every memo record: the digest of the
        # population itself (re-remembering identical knowledge is a
        # no-op overwrite, new knowledge appends)
        h = hashlib.sha256()
        h.update(f"warmstart|{task_type}|".encode())
        h.update(np.ascontiguousarray(accel).tobytes())
        h.update(np.ascontiguousarray(prio).tobytes())
        self.store.put(MemoRecord(
            fingerprint=h.hexdigest(), family=_family(task_type),
            arrays={"pop_accel": accel, "pop_prio": prio},
            meta={"task_type": str(task_type),
                  "group_size": int(accel.shape[1])}))

    def has(self, task_type: str) -> bool:
        return bool(self.store.family(_family(task_type)))

    def _latest(self, task_type: str, group_size: int):
        """Most recently remembered population of this task type with a
        matching group size (the legacy last-write-wins semantics)."""
        for rec in reversed(self.store.family(_family(task_type))):
            if rec.has_population and \
                    rec.arrays["pop_accel"].shape[1] == group_size:
                return rec
        return None

    def init_population(self, task_type: str, gen: torch.Generator,
                        group_size: int, num_accels: int
                        ) -> Optional[Population]:
        """Warm-started population on ``gen``'s device, its jitter drawn
        from ``gen``; None if this task type is unseen (or only seen at
        other group sizes: fall back to random init)."""
        rec = self._latest(task_type, group_size)
        if rec is None:
            return None
        dev = gen.device
        prio = torch.as_tensor(rec.arrays["pop_prio"], dtype=torch.float32,
                               device=dev)
        noise = torch.randn(prio.shape, generator=gen, device=dev,
                            dtype=torch.float32)
        accel, prio = seed_population(
            torch.as_tensor(rec.arrays["pop_accel"], dtype=torch.int32,
                            device=dev),
            prio, self.jitter, noise, num_accels)
        return Population(accel=accel, prio=prio)

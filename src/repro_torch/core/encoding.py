"""Genome encoding/decoding (Section IV-A, Fig. 5a), batched over a population.

An individual = two genomes of length G (group size):

  accel genome   int32 in [0, A)   — sub-accelerator selection per job
  prio genome    float32 in [0, 1) — job priority (0 = highest)

Everything here works on a whole population at once: genomes are (P, G)
tensors and the decoded queues are dense (P, A, G) job-index tables plus a
(P, A) count — the layout ``repro.core.encoding.decode`` gives under
``jax.vmap``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Individual(NamedTuple):
    accel: torch.Tensor   # (G,) int32
    prio: torch.Tensor    # (G,) float32


class Population(NamedTuple):
    accel: torch.Tensor   # (P, G) int32
    prio: torch.Tensor    # (P, G) float32

    @property
    def size(self) -> int:
        return self.accel.shape[0]


class DecodedSchedule(NamedTuple):
    queue: torch.Tensor   # (P, A, G) int32 job ids, first count[p, a] valid
    count: torch.Tensor   # (P, A)    int32


def random_population(gen: torch.Generator, pop: int, group: int,
                      accels: int, device) -> Population:
    """Uniform random genomes drawn from ``gen`` (which lives on ``device``)."""
    return Population(
        accel=torch.randint(0, accels, (pop, group), generator=gen,
                            device=device, dtype=torch.int32),
        prio=torch.rand((pop, group), generator=gen, device=device,
                        dtype=torch.float32),
    )


# lint: dispatch
def rand_rows(gens: Sequence[torch.Generator], shape: Tuple[int, ...]
              ) -> torch.Tensor:
    """(R, *shape) float32 in [0, 1): row r drawn from ``gens[r]``."""
    out = torch.empty((len(gens),) + tuple(shape), dtype=torch.float32,
                      device=gens[0].device)
    for r, gen in enumerate(gens):
        torch.rand(tuple(shape), generator=gen, out=out[r])
    return out


# lint: dispatch
def randn_rows(gens: Sequence[torch.Generator], shape: Tuple[int, ...]
               ) -> torch.Tensor:
    """(R, *shape) float32 standard normals: row r drawn from ``gens[r]``."""
    out = torch.empty((len(gens),) + tuple(shape), dtype=torch.float32,
                      device=gens[0].device)
    for r, gen in enumerate(gens):
        torch.randn(tuple(shape), generator=gen, out=out[r])
    return out


# lint: dispatch
def randint_rows(gens: Sequence[torch.Generator], low: int, high: int,
                 shape: Tuple[int, ...], dtype: torch.dtype = torch.int32
                 ) -> torch.Tensor:
    """(R, *shape) integers in [low, high) (int32 unless ``dtype``): row r
    drawn from ``gens[r]``."""
    out = torch.empty((len(gens),) + tuple(shape), dtype=dtype,
                      device=gens[0].device)
    for r, gen in enumerate(gens):
        torch.randint(low, high, tuple(shape), generator=gen, out=out[r])
    return out


def row_generators(seeds: Sequence[int], device) -> Tuple[torch.Generator,
                                                          ...]:
    """One generator per row on ``device``, each seeded with its seed --
    the generator a standalone search with that seed starts from."""
    gens = []
    for seed in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        gens.append(gen)
    return tuple(gens)


# lint: dispatch
def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[r, idx[r, i]]`` for (R, N, ...) ``x`` and (R, K) ``idx``:
    a gather along axis 1, row by row."""
    tail = x.shape[2:]
    index = idx.long().reshape(idx.shape + (1,) * len(tail))
    return torch.gather(x, 1, index.expand(idx.shape + tail))


def to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """numpy copies of ``tensors`` (all on one device) read back in one
    transfer: on a card their bytes are packed into one buffer there and
    copied once, instead of one synchronising copy per tensor."""
    if tensors[0].device.type == "cpu":
        return tuple(t.numpy().copy() for t in tensors)
    return _unpack(_packed(tensors).cpu().numpy(), _layout(tensors))


def to_host_async(*tensors: torch.Tensor):
    """:func:`to_host` issued without waiting: on a card the packed bytes
    are copied into pinned host memory on the current stream, and the
    returned function gives the numpy arrays once the caller has waited
    for that stream to pass the copy (an event recorded after it); on the
    CPU the copies are made now."""
    if tensors[0].device.type == "cpu":
        out = to_host(*tensors)
        return lambda: out
    flat, layout = _packed(tensors), _layout(tensors)
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    return lambda: _unpack(host.numpy(), layout)


def _packed(tensors) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _layout(tensors):
    """(numpy dtype, shape, bytes) of each tensor, in order."""
    return [(torch.empty((), dtype=t.dtype).numpy().dtype, tuple(t.shape),
             t.numel() * t.element_size()) for t in tensors]


def _unpack(flat: np.ndarray, layout) -> Tuple[np.ndarray, ...]:
    """The arrays of ``layout`` from their packed bytes ``flat``."""
    out, at = [], 0
    for dtype, shape, n in layout:
        out.append(flat[at:at + n].view(dtype).reshape(shape))
        at += n
    return tuple(out)


# lint: dispatch
def random_population_rows(gens: Sequence[torch.Generator], pop: int,
                           group: int, accels: int) -> Population:
    """(R, pop, group) uniform random genomes, row r drawn from
    ``gens[r]`` exactly as :func:`random_population` draws it."""
    return Population(accel=randint_rows(gens, 0, accels, (pop, group)),
                      prio=rand_rows(gens, (pop, group)))


# lint: dispatch
def decode(accel: torch.Tensor, prio: torch.Tensor,
           num_accels: int) -> DecodedSchedule:
    """Decode (P, G) genomes into per-accelerator ordered queues.

    The reference sorts lexicographically on (accel, prio, job id).  Two
    stable sorts give the same order: first by priority (equal priorities
    keep job-id order), then by accelerator (equal accelerators keep
    priority order).  Queue ``a`` is the slice at ``offset[a]`` of the
    grouped job-id vector, clamped to ``G - 1``; slots past ``count[a]``
    are padding from the neighbouring groups, never read by the simulators.
    """
    P, G = accel.shape
    by_prio = torch.argsort(prio, dim=1, stable=True)
    by_accel = torch.argsort(torch.gather(accel, 1, by_prio), dim=1,
                             stable=True)
    grouped = torch.gather(by_prio, 1, by_accel)            # (P, G) job ids
    accels = torch.arange(num_accels, dtype=accel.dtype, device=accel.device)
    count = (accel[:, None, :] == accels[None, :, None]).sum(
        dim=2, dtype=torch.int32)                           # (P, A)
    offset = torch.cumsum(count, dim=1, dtype=torch.int32) - count
    job_ids = torch.arange(G, dtype=torch.int32, device=accel.device)
    idx = torch.clamp_max(offset[:, :, None] + job_ids, G - 1)
    queue = torch.gather(grouped, 1, idx.reshape(P, -1).long())
    return DecodedSchedule(queue=queue.reshape(P, num_accels, G).int(),
                           count=count)


def decode_to_lists(accel, prio, num_accels: int):
    """Host-side convenience: list of job-id lists per accelerator for one
    individual (numpy arrays or tensors of shape (G,))."""
    accel = np.asarray(torch.as_tensor(accel).cpu())
    prio = np.asarray(torch.as_tensor(prio).cpu())
    out = []
    for a in range(num_accels):
        ids = np.where(accel == a)[0]
        out.append([int(i) for i in ids[np.argsort(prio[ids], kind="stable")]])
    return out

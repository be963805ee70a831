"""Pareto machinery — fixed-shape non-dominated sorting on the search's
device, plus host-side front extraction and hypervolume.

Device half (PyTorch, batched over any leading axes, so that NSGA-II's
rows stay independent):

  :func:`nd_ranks`            fast-non-dominated-sort ranks via a pairwise
                              domination matrix peeled front by front, N
                              peels for N points (every shape static)
  :func:`crowding_distance`   NSGA-II crowding, one lexicographic sort per
                              objective with the rank as the major key
                              (two stable sorts) and per-front spans via
                              scatter-min/max

All objectives are **maximized** (the ``repro_torch.core.fitness``
convention: every registered column is higher-is-better).

Host half: :class:`ParetoFront` (the result surfaced through
``M3E.search_front``), :func:`pareto_front` which re-evaluates a
converged population through ``FitnessFn.objectives`` -- so every front
point equals a standalone evaluation of that genome -- and an exact
recursive :func:`hypervolume`.  The same functions as
``repro.core.pareto``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------
def domination_matrix(F: torch.Tensor) -> torch.Tensor:
    """(..., N, N) bool: ``D[i, j]`` — point i dominates point j
    (maximization: >= everywhere, > somewhere) for F (..., N, M)."""
    a, b = F[..., :, None, :], F[..., None, :, :]
    return (a >= b).all(dim=-1) & (a > b).any(dim=-1)


def nd_ranks(F: torch.Tensor) -> torch.Tensor:
    """(..., N) i32 non-domination ranks (0 = the Pareto front) of an
    (..., N, M) objective matrix — fast non-dominated sort, fixed shape.

    Peels N fronts (the worst case: a strict domination chain); each peel
    marks the points no *remaining* point dominates.  Every remaining set
    has maximal elements, so each peel takes at least one point and every
    point gets a rank < N.
    """
    N = F.shape[-2]
    dom = domination_matrix(F)
    rank = torch.full(F.shape[:-1], N, dtype=torch.int32, device=F.device)
    remaining = torch.ones(F.shape[:-1], dtype=torch.bool, device=F.device)
    for r in range(N):
        dominated = (dom & remaining[..., :, None]).any(dim=-2)
        front = remaining & ~dominated
        rank = torch.where(front, r, rank)
        remaining = remaining & ~front
    return rank


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation sorting the last axis by ``keys`` (major first), ties
    by index: one stable sort per key, minor key first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else torch.gather(key, -1, order)
        o = torch.argsort(k, dim=-1, stable=True)
        order = o if order is None else torch.gather(order, -1, o)
    return order


def crowding_distance(F: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """(..., N) f32 NSGA-II crowding distances, computed within each
    rank's front (boundary points per front and objective get +inf)."""
    N, M = F.shape[-2:]
    rank = rank.long()
    pos = torch.arange(N, device=F.device)
    crowd = torch.zeros(F.shape[:-1], dtype=torch.float32, device=F.device)
    lead = F.shape[:-2]
    for m in range(M):                      # M is small
        f = F[..., m]
        gmin = torch.full(lead + (N + 1,), float("inf"), dtype=f.dtype,
                          device=F.device).scatter_reduce(-1, rank, f, "amin")
        gmax = torch.full(lead + (N + 1,), float("-inf"), dtype=f.dtype,
                          device=F.device).scatter_reduce(-1, rank, f, "amax")
        span = gmax - gmin
        order = _lexsort(rank, f)
        r_s = torch.gather(rank, -1, order)
        f_s = torch.gather(f, -1, order)
        first = (pos == 0) | (r_s != torch.roll(r_s, 1, dims=-1))
        last = (pos == N - 1) | (r_s != torch.roll(r_s, -1, dims=-1))
        gap = torch.roll(f_s, -1, dims=-1) - torch.roll(f_s, 1, dims=-1)
        contrib = torch.where(
            first | last, float("inf"),
            gap / torch.clamp_min(torch.gather(span, -1, r_s), 1e-12))
        crowd = crowd.scatter_add(-1, order, contrib.to(torch.float32))
    return crowd


def crowded_order(rank: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """(..., N) permutation sorting by (rank asc, crowding desc, index) —
    NSGA-II's survivor/elitism order (ties broken by index, so the order
    is fully deterministic)."""
    return _lexsort(rank.to(torch.int32), -crowd)


# ---------------------------------------------------------------------------
# host-side front extraction + quality metrics
# ---------------------------------------------------------------------------
def non_dominated_mask(F: np.ndarray) -> np.ndarray:
    """(N,) bool: which rows of a host (N, M) matrix are non-dominated
    (maximization)."""
    F = np.asarray(F)
    ge = (F[:, None, :] >= F[None, :, :]).all(-1)
    gt = (F[:, None, :] > F[None, :, :]).any(-1)
    return ~(ge & gt).any(axis=0)


@dataclasses.dataclass
class ParetoFront:
    """A non-dominated set of schedules over named objectives.

    ``objectives[k, j]`` is point k's value of ``names[j]`` (higher is
    better — the registry convention), with the matching genome in
    ``accel[k] / prio[k]``.  Points are unique in objective space and
    sorted by the first objective, descending.
    """
    names: Tuple[str, ...]
    objectives: np.ndarray      # (F, M) f32
    accel: np.ndarray           # (F, G) int32
    prio: np.ndarray            # (F, G) float32
    # provenance: how the front was computed (0/None when replayed)
    n_samples: int = 0
    wall_time_s: float = 0.0

    def __len__(self) -> int:
        return int(self.objectives.shape[0])

    def best(self, name: str) -> int:
        """Index of the front point maximizing one named objective."""
        j = self.names.index(name)
        return int(np.argmax(self.objectives[:, j]))

    def point(self, k: int) -> dict:
        """Front point k as a plain dict (objectives by name + genome)."""
        return {**{n: float(self.objectives[k, j])
                   for j, n in enumerate(self.names)},
                "accel": self.accel[k], "prio": self.prio[k]}

    def summary(self) -> dict:
        return {"size": len(self), "names": list(self.names),
                **{f"best_{n}": float(self.objectives[:, j].max())
                   for j, n in enumerate(self.names)}}


def pareto_front(fit, population, *, n_samples: int = 0,
                 wall_time_s: float = 0.0) -> ParetoFront:
    """Extract the non-dominated front of a converged population.

    ``fit`` is a (multi-column) ``FitnessFn``; ``population`` an
    ``encoding.Population`` (the strategy's final archive).  Every point's
    objective row is re-evaluated through ``fit.objectives`` — the SAME
    evaluation a standalone scalar search of each column runs — so the
    front values are bit-identical to standalone evaluations of the same
    genomes, independent of how the search was batched or sharded.
    Duplicate genomes (archives keep copies) collapse to one point per
    distinct objective row.
    """
    accel = np.asarray(torch.as_tensor(population.accel).cpu())
    prio = np.asarray(torch.as_tensor(population.prio).cpu())
    dev = fit.device
    objs = fit.objectives(torch.as_tensor(accel, device=dev),
                          torch.as_tensor(prio, device=dev)).cpu().numpy()
    _, keep = np.unique(objs, axis=0, return_index=True)
    keep = np.sort(keep)
    objs, accel, prio = objs[keep], accel[keep], prio[keep]
    mask = non_dominated_mask(objs)
    objs, accel, prio = objs[mask], accel[mask], prio[mask]
    order = np.argsort(-objs[:, 0], kind="stable")
    return ParetoFront(
        names=tuple(fit.objective_spec.names),
        objectives=objs[order], accel=accel[order], prio=prio[order],
        n_samples=int(n_samples), wall_time_s=float(wall_time_s))


def hypervolume(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact hypervolume of a maximization point set w.r.t. a dominated
    reference corner (recursive objective slicing — fine for the
    front/objective counts the benchmarks use; not for M >> 3).

    Points are clipped to the reference from below, so a point worse than
    ``ref`` in some objective simply contributes nothing there.
    """
    pts = np.maximum(np.asarray(points, dtype=np.float64),
                     np.asarray(ref, dtype=np.float64))
    pts = pts[non_dominated_mask(pts)]
    return float(_hv(pts.tolist(), list(np.asarray(ref, dtype=np.float64))))


def _hv(pts, ref) -> float:
    if not pts:
        return 0.0
    if len(ref) == 1:
        return max(p[0] for p in pts) - ref[0]
    pts = sorted(pts, key=lambda p: -p[-1])
    hv = 0.0
    for i, p in enumerate(pts):
        depth = p[-1] - (pts[i + 1][-1] if i + 1 < len(pts) else ref[-1])
        if depth > 0:
            hv += depth * _hv([q[:-1] for q in pts[:i + 1]], ref[:-1])
    return hv

"""Job Analyzer + Job Analysis Table (Section IV-D2/D4).

Profiles every (job, sub-accelerator) pair once with the cost model and
caches the result; inside the optimization loop the table is a pure lookup
(exactly the paper's design — the cost model is never re-queried).

Thread-safety contract
----------------------
``JobAnalyzer`` instances may be shared across host threads (the
``repro.stream`` async analysis stage runs a bounded pool of workers over
one analyzer per accelerator setting, so concurrent scenarios share one
profile cache).  The cache is guarded by a lock around lookup+insert; the
cost model itself is pure (``MaestroModel.profile`` touches no shared
state), so a duplicated profile between check and insert is a wasted
computation, never a wrong one.  Callers that want lock-free analyzers can
instead give each worker its own ``JobAnalyzer`` — correctness is the
same, only cache reuse differs.
"""
from __future__ import annotations

import threading
from typing import Sequence, Tuple

import dataclasses

import numpy as np

from repro_torch.costmodel.accelerators import AcceleratorConfig, SubAccelConfig
from repro_torch.costmodel.layers import LayerDesc
from repro_torch.costmodel.maestro import MaestroModel
from repro_torch.workloads.benchmark import Job


def profile_key(layer: LayerDesc, sub: SubAccelConfig) -> Tuple:
    """Hashable digest of exactly the fields the cost model reads.

    Keying on the *cost-relevant* fields (and not, e.g., ``layer.name``)
    means two layers with identical loop nests share one cache entry —
    ResNet50's repeated bottleneck blocks profile once, not once per
    block.  Both inputs are frozen dataclasses, so the digest is a stable
    value snapshot: a caller that (illegitimately) built a new mutated
    ``sub`` between calls gets a distinct key, never a stale profile.
    """
    return (layer.kind, layer.N, layer.K, layer.C, layer.Y, layer.X,
            layer.R, layer.S, layer.stride, layer.bytes_per_elem,
            sub.pe_h, sub.pe_w, sub.dataflow, sub.sg_bytes, sub.sl_bytes,
            sub.freq_hz)


@dataclasses.dataclass(frozen=True)
class JobAnalysisTable:
    """lat[g, a] = no-stall latency (s); bw[g, a] = required BW (B/s);
    energy[g, a] = job energy (J, Section IV-C alternative objectives)."""
    lat: np.ndarray          # (G, A) float64
    bw: np.ndarray           # (G, A) float64
    flops: np.ndarray        # (G,)  float64
    num_accels: int
    energy: np.ndarray = None   # (G, A) float64 (optional)

    @property
    def group_size(self) -> int:
        return self.lat.shape[0]

    @property
    def total_flops(self) -> float:
        return float(self.flops.sum())


class JobAnalyzer:
    def __init__(self, accel: AcceleratorConfig, model: MaestroModel | None = None):
        self.accel = accel
        self.model = model or MaestroModel()
        self._cache: dict = {}       # @locked:_lock
        self._lock = threading.Lock()

    def _profile(self, layer: LayerDesc, sub: SubAccelConfig):
        key = profile_key(layer, sub)
        with self._lock:
            prof = self._cache.get(key)
        if prof is None:
            # profile outside the lock: pure + idempotent, so a racing
            # duplicate costs a redundant profile, not a wrong entry
            prof = self.model.profile(layer, sub)
            with self._lock:
                prof = self._cache.setdefault(key, prof)
        return prof

    def analyze(self, jobs: Sequence[Job]) -> JobAnalysisTable:
        A = self.accel.num_sub_accels
        G = len(jobs)
        lat = np.empty((G, A), dtype=np.float64)
        bw = np.empty((G, A), dtype=np.float64)
        energy = np.empty((G, A), dtype=np.float64)
        flops = np.empty((G,), dtype=np.float64)
        for g, job in enumerate(jobs):
            flops[g] = job.flops
            for a, sub in enumerate(self.accel.sub_accels):
                prof = self._profile(job.layer, sub)
                lat[g, a] = prof.no_stall_latency_s
                bw[g, a] = prof.required_bw
                energy[g, a] = prof.energy_j
        return JobAnalysisTable(lat=lat, bw=bw, flops=flops, num_accels=A,
                                energy=energy)

    @property
    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)


def table_from_arrays(lat, bw, flops, energy=None) -> JobAnalysisTable:
    """Build a table directly (used by the TPU-submesh serving scheduler)."""
    lat = np.asarray(lat, dtype=np.float64)
    bw = np.asarray(bw, dtype=np.float64)
    flops = np.asarray(flops, dtype=np.float64)
    assert lat.shape == bw.shape and lat.shape[0] == flops.shape[0]
    return JobAnalysisTable(lat=lat, bw=bw, flops=flops,
                            num_accels=lat.shape[1],
                            energy=None if energy is None
                            else np.asarray(energy, dtype=np.float64))

"""TPU-native cost model — the hardware adaptation of MAESTRO for this repo.

When MAGMA is used as the *framework* scheduler (mapping multi-tenant JAX
jobs onto TPU submeshes), the "sub-accelerator" is a submesh of TPU chips
and the per-job quantities are derived from a three-term roofline over the
chip constants given in the assignment:

    peak compute  197 bf16 TFLOP/s per chip
    HBM bandwidth 819 GB/s per chip
    ICI           ~50 GB/s per link

The paper's two Job-Analyzer quantities map directly:
    no-stall latency  = max(FLOPs / peak, on-chip bytes / HBM_bw)
    required BW       = host-visible bytes / no-stall latency
                        (weights resident => host traffic is activations/KV IO)

The shared "system BW" of the paper maps onto the host->pod ingress
(PCIe/DCN) that all submeshes contend for, which is exactly the contention
structure Algorithm 1 models.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TPUChipModel:
    name: str = "v5e"
    peak_flops_bf16: float = 197e12
    hbm_bw: float = 819e9           # bytes/s
    hbm_bytes: float = 16e9
    ici_bw_per_link: float = 50e9   # bytes/s
    ici_links: int = 4
    vmem_bytes: float = 128 * 2**20
    mxu_dim: int = 128
    watts: float = 200.0            # per-chip board power while busy
    ici_power_frac: float = 0.08    # extra power per log2(slice) of ICI
    #                                 fan-out (all-reduce keeps every link
    #                                 busy on bigger slices)


V5E = TPUChipModel()


@dataclasses.dataclass(frozen=True)
class TPUSubmesh:
    """A rectangular slice of the pod acting as one 'sub-accelerator'.

    ``tp`` chips cooperate on each job instance (tensor parallel); larger tp
    gives lower latency but higher interconnect/system-BW pressure — the TPU
    analogue of the paper's HB dataflow.  ``dp`` replicas raise throughput at
    lower BW pressure per replica — the LB analogue.
    """
    name: str
    tp: int
    dp: int = 1
    chip: TPUChipModel = V5E

    @property
    def num_chips(self) -> int:
        return self.tp * self.dp

    @property
    def peak_flops(self) -> float:
        return self.num_chips * self.chip.peak_flops_bf16

    def profile(self, flops: float, hbm_bytes: float, host_bytes: float,
                mxu_util: float = 0.7):
        """Return (no_stall_latency_s, required_host_bw) for one job.

        flops:      total job FLOPs
        hbm_bytes:  bytes the job moves through HBM (weights + activations/KV)
        host_bytes: bytes that must cross the shared host<->pod pipe
                    (inputs, outputs, KV migration) — contends for system BW.
        """
        compute_t = flops / (self.tp * self.chip.peak_flops_bf16 * mxu_util)
        memory_t = hbm_bytes / (self.tp * self.chip.hbm_bw)
        latency = max(compute_t, memory_t)
        req_bw = host_bytes / latency if latency > 0 else 0.0
        return latency, req_bw

    def energy_j(self, latency_s: float) -> float:
        """Energy to hold the whole slice for ``latency_s``: every chip
        burns board power for the job's duration, plus ICI power growing
        with the slice's all-reduce fan-out (``ici_power_frac`` per
        log2 chip).  Under the roofline's perfect 1/tp latency scaling
        ``latency x chips`` is tp-invariant, so the ICI term is what makes
        a big slice fast but strictly MORE energy than a small one — the
        latency/energy tension the multi-objective tier searches over."""
        ici = 1.0 + self.chip.ici_power_frac * math.log2(max(
            self.num_chips, 1))
        return latency_s * self.num_chips * self.chip.watts * ici

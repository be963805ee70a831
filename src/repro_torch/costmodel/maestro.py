"""MAESTRO-like analytical cost model for PE-array sub-accelerators.

Produces the two numbers the paper's Job Analyzer needs per
(layer, sub-accelerator):

  no-stall latency:  cycles / freq assuming the memory system always keeps
                     the (double-buffered) SG fed;
  required BW:       bytes-moved / no-stall-latency — the minimum DRAM->SG
                     bandwidth that keeps the array compute-bound.

Dataflow styles (Section VI-A3):

  HB (NVDLA-inspired, weight-stationary): parallelizes output channels K
     along the array height and input channels C along the width.  Weights
     are fetched once; input activations are re-fetched once per weight tile
     that does not fit the (half, double-buffered) SG.  High compute
     efficiency on channel-rich layers (late CNN layers, FC), but high BW.

  LB (Eyeriss-inspired, row-stationary): parallelizes output rows Y along
     the height and kernel positions R*S along the width.  Activations are
     fetched once; weights re-fetched per activation tile.  Efficient on
     early CNN layers (large Y, nontrivial R*S), very inefficient on FC
     (R=S=1 uses one array column) — but with a tiny BW footprint.

The absolute numbers of the original MAESTRO tool are not reproduced (it is
a far finer simulator); what matters for the paper's experiments is the
*structure* of the (latency, BW) landscape across dataflows and layer types,
which this model matches (validated against Fig. 7 trends in
tests/test_costmodel.py and benchmarks/fig07_job_analysis.py).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.costmodel.accelerators import SubAccelConfig
from repro_torch.costmodel.layers import LayerDesc

# Extra serialization factor for LB on reuse-free GEMMs: the row-stationary
# NoC multicast provides no temporal reuse for R=S=1, stalling the array.
_LB_FC_NOC_PENALTY = 3.0


# energy constants (45nm-class accelerator estimates, documented in
# DESIGN §2: what matters for the paper's objectives is the relative
# compute-vs-DRAM split, not absolute joules)
E_MAC_J = 2.3e-12        # J per MAC (datapath + local SL traffic)
E_DRAM_J = 15.0e-12      # J per DRAM byte


@dataclasses.dataclass(frozen=True)
class JobProfile:
    no_stall_latency_s: float     # seconds
    required_bw: float            # bytes / second
    bytes_moved: float            # total DRAM<->SG traffic
    util: float                   # spatial PE utilization in [0, 1]

    @property
    def energy_j(self) -> float:
        """Section IV-C alternative objectives: job energy = MAC energy
        (bytes-independent) + DRAM traffic energy."""
        # macs recovered from latency x utilization is lossy; energy is
        # attached by the JobAnalyzer which knows the layer
        return self._energy

    _energy: float = 0.0


def _eff(dim: int, size: int) -> float:
    """Spatial mapping efficiency of `dim` work units on `size` lanes."""
    if dim <= 0:
        return 1.0 / size
    folds = math.ceil(dim / size)
    return dim / (folds * size)


class MaestroModel:
    """Analytical (latency, BW) estimator for one sub-accelerator."""

    def profile(self, layer: LayerDesc, sub: SubAccelConfig) -> JobProfile:
        if sub.dataflow == "HB":
            return self._profile_hb(layer, sub)
        if sub.dataflow == "LB":
            return self._profile_lb(layer, sub)
        raise ValueError(f"unknown dataflow {sub.dataflow!r}")

    # -- HB: weight-stationary, K x C spatial ---------------------------------
    def _profile_hb(self, layer: LayerDesc, sub: SubAccelConfig) -> JobProfile:
        util = _eff(layer.K, sub.pe_h) * _eff(layer.C, sub.pe_w)
        cycles = layer.macs / (sub.num_pes * util)
        latency = cycles / sub.freq_hz

        sg_half = sub.sg_bytes / 2  # double-buffered
        # weights streamed once; inputs re-fetched once per resident weight tile
        w_passes = max(1, math.ceil(layer.weight_bytes / sg_half))
        bytes_moved = (layer.weight_bytes
                       + layer.input_bytes * w_passes
                       + layer.output_bytes)
        energy = layer.macs * E_MAC_J + bytes_moved * E_DRAM_J
        return JobProfile(latency, bytes_moved / latency, bytes_moved, util,
                          energy)

    # -- LB: row-stationary, Y x (R*S) spatial --------------------------------
    def _profile_lb(self, layer: LayerDesc, sub: SubAccelConfig) -> JobProfile:
        rows = layer.Y * max(1, layer.N)
        util = _eff(rows, sub.pe_h) * _eff(layer.R * layer.S, sub.pe_w)
        cycles = layer.macs / (sub.num_pes * util)
        if layer.kind == "fc":
            cycles *= _LB_FC_NOC_PENALTY
        latency = cycles / sub.freq_hz

        sg_half = sub.sg_bytes / 2
        # activations resident; weights re-fetched once per activation tile
        a_passes = max(1, math.ceil(layer.input_bytes / sg_half))
        bytes_moved = (layer.input_bytes
                       + layer.weight_bytes * a_passes
                       + layer.output_bytes)
        energy = layer.macs * E_MAC_J + bytes_moved * E_DRAM_J
        return JobProfile(latency, bytes_moved / latency, bytes_moved, util,
                          energy)


class FlexibleMaestroModel(MaestroModel):
    """Flexible-PE-array accelerator (Section VI-F): the 2D array *shape*
    is reconfigurable per job (FPGA/CGRA-style), so the dataflow strategy
    picks the (h, w) factorization of the fixed PE budget that maximizes
    spatial utilization — evaluating candidate shapes with the cost model
    and keeping the lowest-latency one, exactly the paper's procedure.

    The fixed-shape baseline re-fetches per the chosen shape's tiling; the
    flexible mapping tends to raise utilization (lower latency) at the cost
    of more data fetched per tile (higher required BW) — Fig. 14."""

    def __init__(self, shapes_per_side: int = 16):
        self.shapes_per_side = shapes_per_side

    def _candidate_shapes(self, num_pes: int):
        out = []
        h = 1
        while h <= num_pes:
            if num_pes % h == 0:
                out.append((h, num_pes // h))
            h *= 2
        return out

    def profile(self, layer: LayerDesc, sub: SubAccelConfig) -> JobProfile:
        import dataclasses as _dc
        best = None
        for h, w in self._candidate_shapes(sub.num_pes):
            cand = _dc.replace(sub, pe_h=h, pe_w=w)
            prof = super().profile(layer, cand)
            if best is None or prof.no_stall_latency_s < best.no_stall_latency_s:
                best = prof
        return best

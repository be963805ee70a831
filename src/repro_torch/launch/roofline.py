"""Roofline terms of a dry-run cell on NVIDIA H100 SXM cards: the
counterpart of ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), as in the reference:

  compute term    = global FLOPs / (chips x PEAK_FLOPS)
  memory term     = HBM bytes per rank / HBM_BW
  collective term = collective bytes per rank / the link rate of the mesh
                    axes they cross

The reference reads compiled HLO text with TPU v5e constants; nothing in
torch reads HLO, so its HLO parser has no counterpart here.  The numbers
come from ``repro_torch.launch.dryrun``, which traces the step on fake
tensors: the FLOPs with ``torch.utils.flop_counter`` over the meshless
step (global shapes, remat recompute included, the counterpart of the
reference's unrolled lowering; ``hlo_flops`` keeps the reference's field
name), the HBM and collective bytes per rank from the operations rank 0
issues on its shards.

Constants, NVIDIA H100 Tensor Core GPU data sheet (SXM5):

  PEAK_FLOPS   989e12 B/s dense bf16 tensor-core operations per second
  HBM_BW       3.35e12 bytes/s of HBM3
  NVLINK_BW    450e9 bytes/s each way (NVLink 4: 900 GB/s per card, both
               directions together), between the 8 cards of a node
  NIC_BW       50e9 bytes/s: the card's 400 Gb/s network port, between
               nodes

Which axis takes which rate: ranks are laid out row-major over the mesh
(the last axis, "model", varies fastest) and a node holds
``CARDS_PER_NODE`` consecutive ranks.  A mesh axis whose every group of
ranks lies inside one node runs at ``NVLINK_BW``; any other axis (on the
(16, 16) and (2, 16, 16) meshes every axis: "model"'s 16 ranks span two
nodes, "data" and "pod" stride across nodes) runs at ``NIC_BW``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s, per card
NVLINK_BW = 450e9            # bytes/s each way, inside a node
NIC_BW = 50e9                # bytes/s, the 400 Gb/s port between nodes
CARDS_PER_NODE = 8


def axis_link_bw(mesh_shape: Sequence[int], axis: int,
                 cards_per_node: int = CARDS_PER_NODE) -> float:
    """The link rate of mesh axis ``axis`` (index into ``mesh_shape``) on
    a row-major rank layout: NVLink when each of its groups of ranks
    lies inside one node of ``cards_per_node`` consecutive ranks, else
    the network port.  A group spans a block of ``stride x size``
    consecutive ranks, inside a node exactly when the block size divides
    the node's."""
    block = math.prod(mesh_shape[axis:])
    return NVLINK_BW if cards_per_node % block == 0 else NIC_BW


def effective_link_bw(bytes_by_axis: Dict[int, float],
                      mesh_shape: Sequence[int]) -> float:
    """One rate for all the collective bytes: their total over the time
    each axis's bytes take at that axis's rate (NVLink when there are
    none)."""
    total = sum(bytes_by_axis.values())
    time_s = sum(b / axis_link_bw(mesh_shape, a)
                 for a, b in bytes_by_axis.items())
    return total / time_s if time_s else NVLINK_BW


@dataclasses.dataclass
class RooflineTerms:
    chips: int
    hlo_flops: float             # global FLOPs of the traced step
    hbm_bytes_per_chip: float    # unfused per-operation estimate, rank 0
    collective_bytes_per_chip: float
    model_flops: float
    model_bytes: float = 0.0     # model-essential HBM floor (global)
    link_bytes_per_s: float = NVLINK_BW   # the collectives' rate
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0

    def finalize(self) -> "RooflineTerms":
        self.compute_s = self.hlo_flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.hbm_bytes_per_chip / HBM_BW
        self.collective_s = (self.collective_bytes_per_chip
                             / self.link_bytes_per_s)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / self.hlo_flops
                             if self.hlo_flops else 0.0)
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["step_time_s"] = self.step_time_s
        d["ideal_time_s"] = self.ideal_time_s
        d["roofline_fraction"] = self.roofline_fraction
        return d

    @property
    def step_time_s(self) -> float:
        """Roofline step time (no overlap assumption: max of terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def ideal_time_s(self) -> float:
        """Achievable floor: the slower of the model-essential compute and
        the model-essential HBM traffic (decode is memory-bound: its floor
        is the bytes term, not the FLOPs term)."""
        c = self.model_flops / (self.chips * PEAK_FLOPS)
        m = self.model_bytes / (self.chips * HBM_BW)
        return max(c, m)

    @property
    def roofline_fraction(self) -> float:
        """ideal_time / step_time: the share of the achievable roofline the
        traced step reaches (1.0 = every FLOP, byte and collective is
        model-essential or hidden)."""
        return self.ideal_time_s / self.step_time_s if self.step_time_s \
            else 0.0

"""Frozen plain copy of the job analysis: layer loop nests and the
MAESTRO-like latency / required-bandwidth model of Table III's
sub-accelerators (Section IV-D2, VI-A3).

It is a copy, not an import: the benchmark judges the program's tables
against these, so a later change to the program's cost model shows as a
fitness gap instead of moving the yardstick with it.  Everything is
float64 on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

KB = 1024
GB = 1024 ** 3

# the row-stationary NoC gives no temporal reuse on R = S = 1 GEMMs
LB_FC_NOC_PENALTY = 3.0
BW_FLOOR = 1e-3          # bytes/s: the simulator's floor on a job's request


@dataclasses.dataclass(frozen=True)
class Layer:
    """One job's loop nest: N batch, K out channels, C in channels,
    Y x X output, R x S kernel."""
    kind: str            # 'conv' | 'dwconv' | 'fc'
    N: int
    K: int
    C: int
    Y: int
    X: int
    R: int
    S: int
    stride: int = 1
    bytes_per_elem: int = 1

    @property
    def macs(self) -> int:
        return self.N * self.K * self.C * self.Y * self.X * self.R * self.S

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def weight_bytes(self) -> int:
        if self.kind == "dwconv":
            return self.C * self.R * self.S * self.bytes_per_elem
        return self.K * self.C * self.R * self.S * self.bytes_per_elem

    @property
    def input_bytes(self) -> int:
        in_y = self.Y * self.stride + (self.R - self.stride)
        in_x = self.X * self.stride + (self.S - self.stride)
        return self.N * self.C * in_y * in_x * self.bytes_per_elem

    @property
    def output_bytes(self) -> int:
        return self.N * self.K * self.Y * self.X * self.bytes_per_elem


def conv2d(N, K, C, Y, X, R, S, stride=1) -> Layer:
    return Layer("conv", N, K, C, Y, X, R, S, stride)


def dwconv2d(N, C, Y, X, R, S, stride=1) -> Layer:
    return Layer("dwconv", N, 1, C, Y, X, R, S, stride)


def fc(M, N_out, K_in) -> Layer:
    """GEMM (M x K_in) @ (K_in x N_out)."""
    return Layer("fc", 1, N_out, K_in, M, 1, 1, 1)


def attention_fcs(seq, d_model, n_heads, d_ff=None) -> List[Layer]:
    """One transformer block as FC jobs: QKV, scores, context, out
    projection and, with ``d_ff``, the two MLP GEMMs."""
    d_head = d_model // n_heads
    layers = [fc(seq, 3 * d_model, d_model),
              fc(seq * n_heads, seq, d_head),
              fc(seq * n_heads, d_head, seq),
              fc(seq, d_model, d_model)]
    if d_ff:
        layers += [fc(seq, d_ff, d_model), fc(seq, d_model, d_ff)]
    return layers


@dataclasses.dataclass(frozen=True)
class SubAccel:
    """A ``pe_h x pe_w`` PE array with an HB or LB dataflow and a
    double-buffered global scratchpad of ``sg_bytes``."""
    pe_h: int
    pe_w: int
    dataflow: str
    sg_bytes: int
    freq_hz: float

    @property
    def num_pes(self) -> int:
        return self.pe_h * self.pe_w


def sub_accels(spec: Sequence[dict]) -> Tuple[SubAccel, ...]:
    """The sub-accelerators a configuration file lists, in order: each
    entry ``{"count", "pe_h", "pe_w", "dataflow", "sg_kb", "freq_hz"}``
    gives ``count`` identical arrays."""
    out = []
    for e in spec:
        out += [SubAccel(int(e["pe_h"]), int(e["pe_w"]), str(e["dataflow"]),
                         int(e["sg_kb"]) * KB, float(e["freq_hz"]))
                for _ in range(int(e["count"]))]
    return tuple(out)


def _eff(dim: int, size: int) -> float:
    """Spatial efficiency of ``dim`` work units on ``size`` lanes."""
    if dim <= 0:
        return 1.0 / size
    return dim / (math.ceil(dim / size) * size)


def profile(layer: Layer, sub: SubAccel) -> Tuple[float, float]:
    """(no-stall latency s, required bandwidth B/s) of one job."""
    if sub.dataflow == "HB":
        util = _eff(layer.K, sub.pe_h) * _eff(layer.C, sub.pe_w)
        latency = layer.macs / (sub.num_pes * util) / sub.freq_hz
        passes = max(1, math.ceil(layer.weight_bytes / (sub.sg_bytes / 2)))
        moved = (layer.weight_bytes + layer.input_bytes * passes
                 + layer.output_bytes)
    elif sub.dataflow == "LB":
        rows = layer.Y * max(1, layer.N)
        util = _eff(rows, sub.pe_h) * _eff(layer.R * layer.S, sub.pe_w)
        cycles = layer.macs / (sub.num_pes * util)
        if layer.kind == "fc":
            cycles *= LB_FC_NOC_PENALTY
        latency = cycles / sub.freq_hz
        passes = max(1, math.ceil(layer.input_bytes / (sub.sg_bytes / 2)))
        moved = (layer.input_bytes + layer.weight_bytes * passes
                 + layer.output_bytes)
    else:
        raise ValueError(f"unknown dataflow {sub.dataflow!r}")
    return latency, moved / latency

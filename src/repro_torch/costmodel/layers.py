"""Layer descriptors — the unit of a "job" in the paper.

A job is a mini-batch of one DNN layer (Section III).  Every layer kind is
reduced to its loop-nest dims so the dataflow cost models can reason about
parallelism and data movement uniformly:

    N  batch                 K  output channels / features
    C  input channels        Y, X  output spatial
    R, S  kernel spatial

FC/GEMM (M x N_out x K_in) maps to (N=1, K=N_out, C=K_in, Y=M, X=1, R=S=1).
Attention layers are modeled as bags of FCs (Section II-A: "the MLPs and the
attention layers are modeled as several FCs").  Embedding lookups stay on the
host CPU (Section II-A) and are therefore never emitted as jobs.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One schedulable layer mini-batch ("job" payload)."""
    name: str
    kind: str          # 'conv' | 'dwconv' | 'fc'
    N: int             # batch
    K: int             # output channels
    C: int             # input channels
    Y: int             # output height (or GEMM M)
    X: int             # output width
    R: int             # kernel height
    S: int             # kernel width
    stride: int = 1
    bytes_per_elem: int = 1   # paper: "bit-width of 1 Byte"

    # ---- derived quantities -------------------------------------------------
    @property
    def macs(self) -> int:
        return self.N * self.K * self.C * self.Y * self.X * self.R * self.S

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def weight_bytes(self) -> int:
        if self.kind == "dwconv":
            # depthwise: one RxS filter per channel
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

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.input_bytes + self.output_bytes


def conv2d(name: str, N: int, K: int, C: int, Y: int, X: int,
           R: int, S: int, stride: int = 1) -> LayerDesc:
    return LayerDesc(name, "conv", N, K, C, Y, X, R, S, stride)


def dwconv2d(name: str, N: int, C: int, Y: int, X: int,
             R: int, S: int, stride: int = 1) -> LayerDesc:
    # depthwise: K==1 per group, C groups; we keep K=1 so channel-parallel
    # (HB) dataflows see no K parallelism — the paper's "depth-wise CONV jobs
    # are often more memory-intensive than regular 2D CONV jobs".
    return LayerDesc(name, "dwconv", N, 1, C, Y, X, R, S, stride)


def fc(name: str, M: int, N_out: int, K_in: int) -> LayerDesc:
    """GEMM of (M x K_in) @ (K_in x N_out)."""
    return LayerDesc(name, "fc", 1, N_out, K_in, M, 1, 1, 1)


def attention_fcs(name: str, seq: int, d_model: int, n_heads: int,
                  d_ff: int | None = None) -> List[LayerDesc]:
    """One transformer block as a bag of FC jobs (paper Section II-A).

    QKV projection, attention scores (seq x seq per head, quadratic in seq),
    attention-weighted values, output projection, and the 2-layer MLP.
    """
    d_head = d_model // n_heads
    layers = [
        fc(f"{name}.qkv", seq, 3 * d_model, d_model),
        # score/context GEMMs: batch the heads into the M dim
        fc(f"{name}.scores", seq * n_heads, seq, d_head),
        fc(f"{name}.context", seq * n_heads, d_head, seq),
        fc(f"{name}.proj", seq, d_model, d_model),
    ]
    if d_ff:
        layers += [
            fc(f"{name}.mlp_in", seq, d_ff, d_model),
            fc(f"{name}.mlp_out", seq, d_model, d_ff),
        ]
    return layers

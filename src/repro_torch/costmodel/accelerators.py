"""Accelerator settings S1-S6 from Table III of the paper.

Each sub-accelerator is a 2D PE array ``h x 64`` (the paper fixes one
dimension to 64), a dataflow style (HB = NVDLA-inspired high-bandwidth
weight-stationary; LB = Eyeriss-inspired low-bandwidth row-stationary),
and an on-chip global scratchpad (SG, double-buffered).

Frequencies: 200 MHz, 1 byte datapath (Section VI-A3).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

KB = 1024
GB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class SubAccelConfig:
    name: str
    pe_h: int                # array height
    dataflow: str            # 'HB' | 'LB'
    sg_bytes: int            # shared global scratchpad
    pe_w: int = 64           # fixed per paper
    sl_bytes: int = 1 * KB   # per-PE local scratchpad
    freq_hz: float = 200e6

    @property
    def num_pes(self) -> int:
        return self.pe_h * self.pe_w

    @property
    def peak_flops(self) -> float:
        return 2.0 * self.num_pes * self.freq_hz  # MAC = 2 flops


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    name: str
    sub_accels: Tuple[SubAccelConfig, ...]

    @property
    def num_sub_accels(self) -> int:
        return len(self.sub_accels)

    @property
    def peak_flops(self) -> float:
        return sum(s.peak_flops for s in self.sub_accels)

    def describe(self) -> str:
        parts = [f"{s.pe_h}x{s.pe_w}/{s.dataflow}" for s in self.sub_accels]
        return f"{self.name}[{', '.join(parts)}]"


def _sub(h: int, df: str, sg_kb: int, i: int) -> SubAccelConfig:
    return SubAccelConfig(name=f"sa{i}_{h}x64{df}", pe_h=h, dataflow=df,
                          sg_bytes=sg_kb * KB)


def _accel(name: str, spec: list) -> AcceleratorConfig:
    subs, i = [], 0
    for count, h, df, sg_kb in spec:
        for _ in range(count):
            subs.append(_sub(h, df, sg_kb, i))
            i += 1
    return AcceleratorConfig(name, tuple(subs))


# Table III.  (count, height, dataflow, SG KB)
SETTINGS = {
    "S1": _accel("S1_small_homog", [(4, 32, "HB", 146)]),
    "S2": _accel("S2_small_hetero", [(3, 32, "HB", 146), (1, 32, "LB", 110)]),
    "S3": _accel("S3_large_homog", [(8, 128, "HB", 580)]),
    "S4": _accel("S4_large_hetero", [(7, 128, "HB", 580), (1, 128, "LB", 434)]),
    "S5": _accel("S5_large_biglittle", [
        (3, 128, "HB", 580), (1, 128, "LB", 434),
        (3, 64, "HB", 291), (1, 64, "LB", 218)]),
    "S6": _accel("S6_large_scaleup", [
        (7, 128, "HB", 580), (1, 128, "LB", 434),
        (7, 64, "HB", 291), (1, 64, "LB", 218)]),
}


def get_setting(name: str) -> AcceleratorConfig:
    return SETTINGS[name]

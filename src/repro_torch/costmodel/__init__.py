"""Analytical cost models for sub-accelerators (copy of ``repro.costmodel``).

``maestro`` is a MAESTRO-like model of PE-array sub-accelerators with HB
(NVDLA-style, weight-stationary) and LB (Eyeriss-style, row-stationary)
dataflows, used by the paper's S1-S6 settings.  It gives the paper's two
quantities per (job, sub-accelerator): the no-stall latency and the
required bandwidth.  ``tpu`` is the TPU-submesh roofline model that the
serving engine (``repro_torch.serve``) profiles its jobs with; it is
copied unchanged, so that the engine's tables, and with them its
schedules, are the JAX package's.
"""
from repro_torch.costmodel.layers import LayerDesc, conv2d, dwconv2d, fc, attention_fcs
from repro_torch.costmodel.accelerators import (
    SubAccelConfig, AcceleratorConfig, SETTINGS, get_setting, GB, KB)
from repro_torch.costmodel.maestro import MaestroModel
from repro_torch.costmodel.tpu import TPUChipModel, TPUSubmesh, V5E

__all__ = [
    "LayerDesc", "conv2d", "dwconv2d", "fc", "attention_fcs",
    "SubAccelConfig", "AcceleratorConfig", "SETTINGS", "get_setting",
    "GB", "KB", "MaestroModel", "TPUChipModel", "TPUSubmesh", "V5E",
]
